"""EMSANet model assembly (counterpart: `emsanet_tpu/models/emsanet.py`).

Forward: dual encoder with SE fusion -> PPM context module on the RGB
branch -> semantic and instance dense decoders and the scene head. The
input batch holds NHWC 'rgb' (N, H, W, 3) and 'depth' (N, H, W, 1)
normalized floats; the output dict matches the flax model's key for key,
with NHWC tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from emsanet_tpu_torch.config import ModelConfig, validate_for_port
from emsanet_tpu_torch.datasets.metadata import DatasetConfig
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.models.context import (
    context_reduction_channels,
    get_context_module,
)
from emsanet_tpu_torch.models.decoder import (
    DenseDecoder,
    SceneClassificationHead,
)
from emsanet_tpu_torch.models.encoder import FusedEncoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SKIP_CHANNELS = {4: 64, 8: 128, 16: 256, 32: 512}


class EMSANet(nn.Module):
    """Multi-task RGB-D scene analysis network, inference only."""

    def __init__(self, cfg: ModelConfig, dataset_config: DatasetConfig):
        super().__init__()
        cfg = validate_for_port(cfg)
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.encoder = FusedEncoder(cfg)
        c_enc = FusedEncoder.n_channels_out
        self.context_module = get_context_module(
            cfg.context_module, c_enc, cfg.upsampling_context_module)
        skip_channels = {d: _SKIP_CHANNELS[d]
                         for d in cfg.encoder_decoder_skip_downsamplings}
        zero_init = not cfg.no_zero_init_decoder_residuals
        for task in ("semantic", "instance"):
            if task not in cfg.tasks:
                continue
            extra: Dict[str, Any] = {}
            if task == "semantic":
                extra["n_classes"] = (
                    dataset_config.n_semantic_classes_without_void)
            else:
                extra.update(
                    with_orientation="orientation" in cfg.tasks,
                    sigmoid_for_center=cfg.instance_sigmoid_for_center,
                    tanh_for_offset=cfg.instance_tanh_for_offset,
                )
            setattr(self, f"{task}_decoder", DenseDecoder(
                task, c_enc,
                n_channels=getattr(cfg, f"{task}_decoder_n_channels"),
                downsamplings=getattr(cfg, f"{task}_decoder_downsamplings"),
                n_blocks=getattr(cfg, f"{task}_decoder_n_blocks"),
                fusion=getattr(cfg, f"{task}_encoder_decoder_fusion"),
                skip_channels=skip_channels,
                upsampling=getattr(cfg, f"{task}_decoder_upsampling"),
                prediction_upsampling=cfg.upsampling_prediction,
                zero_init_residual=zero_init,
                head_decode_fusion=cfg.head_decode_fusion,
                **extra,
            ))
        if "scene" in cfg.tasks:
            self.scene_decoder = SceneClassificationHead(
                context_reduction_channels(cfg.context_module, c_enc),
                dataset_config.n_scene_classes_without_void,
            )

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        dt = self.compute_dtype
        feats, skips = self.encoder(
            {m: batch[m].to(dt) for m in ("rgb", "depth")})
        con_out, con_context = self.context_module(feats["rgb"])
        outputs: Dict[str, Any] = {}
        for task in ("semantic", "instance"):
            if task in self.cfg.tasks:
                outputs[task] = getattr(self, f"{task}_decoder")(
                    con_out, skips)
        if "scene" in self.cfg.tasks:
            outputs["scene"] = {"logits": self.scene_decoder(con_context[0])}
        return outputs


def build_model(
    cfg: ModelConfig,
    dataset_config: DatasetConfig,
    device: Optional[str] = None,
    seed: Optional[int] = 0,
) -> EMSANet:
    """The port's model on `device` (default 'cuda', which must exist),
    in eval mode and in `cfg.compute_dtype`, with random weights drawn
    from `seed` (`weights.random_init_`); pass seed=None to keep the
    module defaults, e.g. before loading converted weights."""
    from emsanet_tpu_torch.weights import random_init_

    dev = resolve_device(device)
    model = EMSANet(cfg, dataset_config)
    if seed is not None:
        random_init_(model, seed)
    # channels_last: conv weights in the layout of the NHWC activations
    model = model.to(device=dev, dtype=_DTYPES[cfg.compute_dtype],
                     memory_format=torch.channels_last)
    return model.eval()
