"""Dual RGB + depth encoder with SE-add fusion.

Counterpart of `emsanet_tpu/models/encoder.py::FusedEncoder`. Runs both
backbones stage-wise; after the stem and after every stage the other
modality is fused into the main branch (SE gates on both, then add).
At inference both stems run as ONE launch of the fused stem kernel
(`ops/stem.py`); in training they run unfused, with batch statistics
(`emsanet_tpu/models/encoder.py:209-220`).
Returns the per-modality final maps and the skip dict
{downscale: {'rgb': t, 'depth': t}} at the configured downscales.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from emsanet_tpu_torch.config import ModelConfig
from emsanet_tpu_torch.models.backbone import make_backbone_stages
from emsanet_tpu_torch.models.layers import SqueezeExcitation
from emsanet_tpu_torch.ops import stem as stem_ops

# downscale after stem and after each stage
_STAGE_DOWNSCALES = (4, 4, 8, 16, 32)
_MODALITY_CHANNELS = {"rgb": 3, "depth": 1}


class SEFusion(nn.Module):
    """fused = SE_main(main) + SE_other(other) (plain add without SE)."""

    def __init__(self, c: int, use_se: bool = True):
        super().__init__()
        self.use_se = use_se
        if use_se:
            self.se_main = SqueezeExcitation(c)
            self.se_other = SqueezeExcitation(c)

    def forward(self, main: torch.Tensor, other: torch.Tensor):
        if self.use_se:
            main = self.se_main(main)
            other = self.se_other(other)
        return main + other


class FusedEncoder(nn.Module):
    """Dual (RGB + depth) encoder."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.modalities = ("rgb", "depth")
        self.skip_downscales = tuple(cfg.encoder_decoder_skip_downsamplings)
        for mod in self.modalities:
            stem, stages = make_backbone_stages(
                getattr(cfg, f"{mod}_encoder_backbone"),
                getattr(cfg, f"{mod}_encoder_backbone_block"),
                _MODALITY_CHANNELS[mod], cfg.dropout_p, cfg.fused_training,
            )
            setattr(self, f"{mod}_stem", stem)
            for i, st in enumerate(stages):
                setattr(self, f"{mod}_stage{i}", st)
        fusion = cfg.encoder_fusion
        self.fuse_into = None
        if fusion != "none":
            self.fuse_into = "depth" if fusion.endswith("depth") else "rgb"
            for i, c in enumerate((64, 64, 128, 256, 512)):
                setattr(self, f"fusion{i}",
                        SEFusion(c, use_se=fusion.startswith("se-")))

    n_channels_out = 512

    def forward(
        self, inputs: Dict[str, torch.Tensor]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[int, Dict[str, torch.Tensor]]]:
        """inputs: NHWC tensors in the compute dtype."""
        stems = [getattr(self, f"{m}_stem") for m in self.modalities]
        if self.training:
            feats = {m: s(inputs[m].permute(0, 3, 1, 2))
                     for m, s in zip(self.modalities, stems)}
        else:
            outs = stem_ops.fused_stems(
                [inputs[m].contiguous() for m in self.modalities],
                [s.Conv_0.weight for s in stems],
                [s.Norm_0.BatchNorm_0.params() for s in stems],
            )
            feats = {m: o.permute(0, 3, 1, 2)
                     for m, o in zip(self.modalities, outs)}

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
