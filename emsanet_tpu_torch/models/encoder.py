"""Dual (RGB + depth), single-modality or RGBD encoder with SE-add fusion.

Counterpart of `emsanet_tpu/models/encoder.py::FusedEncoder`. Builds one
backbone per modality: 'rgbd' alone (a 4-channel input) where the
modalities name it, else 'rgb' and / or 'depth'. With two backbones it
runs them stage-wise and, after the stem and after every stage, fuses
the other modality into the main branch (SE gates on both, then add; a
plain add without SE); 'none' and one backbone fuse nothing.
At inference with `fused_inference`, batchnorm and relu, every stem runs
in ONE launch of the fused stem kernel (`ops/stem.py`; the gate of
`emsanet_tpu/models/encoder.py:209-236`); in training and otherwise the
stems run unfused (with batch statistics in training).
Returns the per-modality final maps and the skip dict
{downscale: {modality: t}} at the configured downscales.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from emsanet_tpu_torch.config import ModelConfig
from emsanet_tpu_torch.models.backbone import (
    get_backbone_spec,
    make_backbone_stages,
)
from emsanet_tpu_torch.models.layers import SqueezeExcitation
from emsanet_tpu_torch.ops import stem as stem_ops

# downscale after stem and after each stage
_STAGE_DOWNSCALES = (4, 4, 8, 16, 32)
MODALITY_CHANNELS = {"rgb": 3, "depth": 1, "rgbd": 4}


def encoder_modalities(cfg: ModelConfig) -> Tuple[str, ...]:
    """The backbones an encoder builds: ('rgbd',) where the modalities
    name it, else 'rgb' and / or 'depth' in that order."""
    if "rgbd" in cfg.input_modalities:
        return ("rgbd",)
    return tuple(m for m in ("rgb", "depth") if m in cfg.input_modalities)


class SEFusion(nn.Module):
    """fused = SE_main(main) + SE_other(other) (plain add without SE)."""

    def __init__(self, c: int, use_se: bool = True,
                 activation: str = "relu"):
        super().__init__()
        self.use_se = use_se
        if use_se:
            self.se_main = SqueezeExcitation(c, activation=activation)
            self.se_other = SqueezeExcitation(c, activation=activation)

    def forward(self, main: torch.Tensor, other: torch.Tensor):
        if self.use_se:
            main = self.se_main(main)
            other = self.se_other(other)
        return main + other


class FusedEncoder(nn.Module):
    """Dual, single-modality or RGBD encoder."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.modalities = encoder_modalities(cfg)
        self.skip_downscales = tuple(cfg.encoder_decoder_skip_downsamplings)
        self.specs = {}
        self.use_stem_kernel = (
            cfg.fused_inference and cfg.encoder_normalization == "batchnorm"
            and cfg.activation == "relu")
        for mod in self.modalities:
            backbone = getattr(cfg, f"{mod}_encoder_backbone")
            self.specs[mod] = get_backbone_spec(backbone)
            stem, stages = make_backbone_stages(
                backbone, getattr(cfg, f"{mod}_encoder_backbone_block"),
                MODALITY_CHANNELS[mod], cfg.dropout_p,
                cfg.encoder_normalization, cfg.activation,
                cfg.fused_inference, cfg.fused_training, cfg.remat,
            )
            setattr(self, f"{mod}_stem", stem)
            for i, st in enumerate(stages):
                setattr(self, f"{mod}_stage{i}", st)
        fusion = cfg.encoder_fusion
        self.fuse_into = None
        if fusion != "none" and len(self.modalities) == 2:
            self.fuse_into = "depth" if fusion.endswith("depth") else "rgb"
            spec = self.specs[self.fuse_into]
            for i, c in enumerate((64,) + spec.stage_out_features):
                setattr(self, f"fusion{i}", SEFusion(
                    c, use_se=fusion.startswith("se-"),
                    activation=cfg.activation))

    @property
    def n_channels_out(self) -> int:
        return next(iter(self.specs.values())).n_channels_out

    @property
    def skips_n_channels(self) -> Dict[int, int]:
        spec = next(iter(self.specs.values()))
        return dict(zip(self.skip_downscales,
                        spec.skip_features(self.skip_downscales)))

    def forward(
        self, inputs: Dict[str, torch.Tensor]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[int, Dict[str, torch.Tensor]]]:
        """inputs: NHWC tensors in the compute dtype, one per modality."""
        stems = [getattr(self, f"{m}_stem") for m in self.modalities]
        xs = [inputs[m] for m in self.modalities]
        if self._stem_kernel_takes(xs):
            outs = stem_ops.fused_stems(
                [x.contiguous() for x in xs],
                [s.Conv_0.weight for s in stems],
                [s.Norm_0.BatchNorm_0.params() for s in stems],
            )
            feats = {m: o.permute(0, 3, 1, 2)
                     for m, o in zip(self.modalities, outs)}
        else:
            feats = {m: s(x.permute(0, 3, 1, 2))
                     for m, s, x in zip(self.modalities, stems, xs)}

        fused = self.fuse_into
        other = "depth" if fused == "rgb" else "rgb"
        if fused is not None:
            feats[fused] = self.fusion0(feats[fused], feats[other])
        skips: Dict[int, Dict[str, torch.Tensor]] = {}
        for i in range(4):
            for mod in self.modalities:
                feats[mod] = getattr(self, f"{mod}_stage{i}")(feats[mod])
            if fused is not None:
                feats[fused] = getattr(self, f"fusion{i + 1}")(
                    feats[fused], feats[other])
            downscale = _STAGE_DOWNSCALES[i + 1]
            if downscale in self.skip_downscales:
                skips[downscale] = dict(feats)
        return feats, skips

    def _stem_kernel_takes(self, xs) -> bool:
        """The JAX package's gate of the fused stem (`encoder.py:222-236`):
        inference, `fused_inference`, batchnorm and relu, inputs of one
        spatial shape."""
        return (not self.training and self.use_stem_kernel
                and all(x.shape[:3] == xs[0].shape[:3] for x in xs))
