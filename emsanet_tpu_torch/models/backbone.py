"""ResNet-18/34 backbones with NonBottleneck1D or basic blocks.

Counterpart of `emsanet_tpu/models/backbone.py`, built stage-wise (stem
+ 4 stages) so the dual encoder can fuse between stages. Only the plain
7x7/2 stem is ported: the space-to-depth form there is a rewrite for
XLA on the TPU, not a different function.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emsanet_tpu_torch.models.layers import (
    BLOCK_CLASSES,
    Conv2d,
    Norm,
    apply_blocks_fused,
)

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_FEATURES = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 2, 2)


class ResNetStem(nn.Module):
    """7x7/2 conv (padding 3) + BN + ReLU + 3x3/2 max pool (-inf pad 1).

    `forward` is the plain version, which training runs (its BatchNorm
    takes batch statistics); at inference the encoder runs both stems
    through the fused stem kernel (`ops/stem.py`) with these parameters.
    """

    def __init__(self, cin: int, features: int = 64):
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, 7, stride=2, padding=3,
                             bias=False)
        self.Norm_0 = Norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)


class ResNetStage(nn.Module):
    """A sequence of residual blocks; the first applies the stride."""

    def __init__(self, block: str, n_blocks: int, cin: int, features: int,
                 stride: int, dropout_p: float = 0.0,
                 fused_training: bool = False):
        super().__init__()
        cls = BLOCK_CLASSES[block]
        self.n_blocks = n_blocks
        self.fused_training = fused_training
        for i in range(n_blocks):
            setattr(self, f"block{i}", cls(
                cin if i == 0 else features, features,
                stride=stride if i == 0 else 1, dropout_p=dropout_p,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = [getattr(self, f"block{i}") for i in range(self.n_blocks)]
        return apply_blocks_fused(blocks, x, self.fused_training)


def make_backbone_stages(
    backbone: str, block: str, cin: int, dropout_p: float = 0.0,
    fused_training: bool = False,
) -> Tuple[ResNetStem, List[ResNetStage]]:
    """(stem, [stage0..stage3]) for 'resnet18' / 'resnet34'."""
    stem = ResNetStem(cin)
    stages = []
    c = 64
    for i, (n, f, s) in enumerate(
        zip(STAGE_BLOCKS[backbone], STAGE_FEATURES, STAGE_STRIDES)
    ):
        stages.append(ResNetStage(block, n, c, f, s, dropout_p,
                                  fused_training))
        c = f
    return stem, stages
