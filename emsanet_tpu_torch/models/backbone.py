"""ResNet-18/34/50/101 backbones with NonBottleneck1D, basic or bottleneck
blocks, SE variants ('resnet18se', 'resnet34se') and reduced
downsampling ('-d16').

Counterpart of `emsanet_tpu/models/backbone.py`, built stage-wise (stem
+ 4 stages) so the dual encoder can fuse between stages. Only the plain
7x7/2 stem is ported: the space-to-depth form there is a rewrite for
XLA on the TPU, not a different function. Bottleneck backbones
(resnet50/101) take bottleneck blocks whatever block is chosen; an SE
stage runs its blocks one by one with an SE gate after each and never
takes a kernel; a '-d16' backbone keeps the resolution in its last stage.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
from torch import nn

from emsanet_tpu_torch.models.layers import (
    BLOCK_CLASSES,
    Conv2d,
    Norm,
    SqueezeExcitation,
    apply_blocks_fused,
    get_activation,
    remat_active,
    remat_call,
)

STAGE_FEATURES = (64, 128, 256, 512)
_BASE_SPECS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
}
# the non-bottleneck backbones' blocks per stage (the upstream checkpoint
# import's choices)
STAGE_BLOCKS = {k: v for k, (v, bottleneck) in _BASE_SPECS.items()
                if not bottleneck}
# the skip taken at each downscale: the stem's (4) or a stage's output
_STAGE_OF_DOWNSCALE = {4: 0, 8: 1, 16: 2, 32: 3}


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """Static description of a ResNet variant."""

    name: str
    stage_blocks: Tuple[int, ...]
    bottleneck: bool = False  # resnet50/101: x4 expansion
    se: bool = False
    downsampling: int = 32  # 16 for '-d16'

    @property
    def stage_out_features(self) -> Tuple[int, ...]:
        mult = 4 if self.bottleneck else 1
        return tuple(f * mult for f in STAGE_FEATURES)

    @property
    def n_channels_out(self) -> int:
        return self.stage_out_features[-1]

    @property
    def stage_strides(self) -> Tuple[int, ...]:
        return (1, 2, 2, 2 if self.downsampling == 32 else 1)

    def skip_features(self, downscales: Sequence[int]) -> Tuple[int, ...]:
        """Channels of the skip at each of `downscales`."""
        return tuple(self.stage_out_features[_STAGE_OF_DOWNSCALE[d]]
                     for d in downscales)


def get_backbone_spec(name: str) -> BackboneSpec:
    """'resnet34', 'resnet34se', 'resnet18-d16', ... -> its spec."""
    base = name.lower()
    downsampling = 32
    if base.endswith("-d16"):
        base, downsampling = base[:-4], 16
    se = base.endswith("se")
    if se:
        base = base[:-2]
    if base not in _BASE_SPECS:
        raise ValueError(f"Unknown backbone '{name}'")
    stage_blocks, bottleneck = _BASE_SPECS[base]
    return BackboneSpec(name=name.lower(), stage_blocks=stage_blocks,
                        bottleneck=bottleneck, se=se,
                        downsampling=downsampling)


class ResNetStem(nn.Module):
    """7x7/2 conv (padding 3) + norm + act + 3x3/2 max pool (-inf pad 1).

    `forward` is the plain version, which training and the unfused
    forward run; at inference with `fused_inference`, batchnorm and relu
    the encoder runs the stems through the fused stem kernel
    (`ops/stem.py`) with these parameters.
    """

    def __init__(self, cin: int, features: int = 64,
                 normalization: str = "batchnorm", activation: str = "relu"):
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, 7, stride=2, padding=3,
                             bias=False)
        self.Norm_0 = Norm(features, normalization)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.Norm_0(self.Conv_0(x)))
        return torch.nn.functional.max_pool2d(x, 3, stride=2, padding=1)


class ResNetStage(nn.Module):
    """A sequence of residual blocks; the first applies the stride. An SE
    stage puts an SE gate (`se{i}`) after each block."""

    def __init__(self, block: str, n_blocks: int, cin: int, features: int,
                 stride: int, dropout_p: float = 0.0, se: bool = False,
                 normalization: str = "batchnorm", activation: str = "relu",
                 fused_inference: bool = False,
                 fused_training: bool = False, remat: bool = False):
        super().__init__()
        cls = BLOCK_CLASSES[block]
        self.remat = remat
        self.n_blocks = n_blocks
        self.se = se
        self.fused_inference = fused_inference
        self.fused_training = fused_training
        c = cin
        for i in range(n_blocks):
            setattr(self, f"block{i}", cls(
                c, features, stride=stride if i == 0 else 1,
                dropout_p=dropout_p, normalization=normalization,
                activation=activation))
            c = features * cls.expansion
            if se:
                setattr(self, f"se{i}", SqueezeExcitation(
                    c, activation=activation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if remat_active(self):
            return remat_call(self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = [getattr(self, f"block{i}") for i in range(self.n_blocks)]
        if not self.se:
            return apply_blocks_fused(blocks, x, self.fused_training,
                                      self.fused_inference)
        for i, b in enumerate(blocks):
            x = getattr(self, f"se{i}")(b(x))
        return x


def make_backbone_stages(
    backbone: str, block: str, cin: int, dropout_p: float = 0.0,
    normalization: str = "batchnorm", activation: str = "relu",
    fused_inference: bool = False, fused_training: bool = False,
    remat: bool = False,
) -> Tuple[ResNetStem, List[ResNetStage]]:
    """(stem, [stage0..stage3]) of a backbone named as `get_backbone_spec`
    reads it; a bottleneck backbone ignores `block`. With `remat` each
    stage recomputes its forward in the backward pass (`remat_call`)."""
    spec = get_backbone_spec(backbone)
    block = "bottleneck" if spec.bottleneck else block
    stem = ResNetStem(cin, normalization=normalization,
                      activation=activation)
    stages = []
    c = 64
    for n, f, s, out in zip(spec.stage_blocks, STAGE_FEATURES,
                            spec.stage_strides, spec.stage_out_features):
        stages.append(ResNetStage(block, n, c, f, s, dropout_p, spec.se,
                                  normalization, activation,
                                  fused_inference, fused_training, remat))
        c = out
    return stem, stages
