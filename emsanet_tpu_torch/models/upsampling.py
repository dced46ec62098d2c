"""x2 upsampling modules and resizes (counterpart:
`emsanet_tpu/models/upsampling.py`).

'learned-3x3-zeropad' is nearest x2 followed by a zero-padded depthwise
3x3 conv (`depthwise`, initialized to mimic bilinear). At inference with
`fused` (`fused_inference`), and in training with `train_polyphase`
(`train_polyphase_upsampling`; differentiable), it runs in its exact
polyphase form (`ops/polyphase_upsample.py`) where the input has at
least 60*80 pixels, the gate of the JAX package (`upsampling.py:120-126`);
otherwise the nearest + conv form runs. With
`defer_interleave`, the polyphase path returns the (N, 4C, H, W)
parity-domain output instead of interleaving it, which the semantic
head's consumer reads as `logits_polyphase`. With `defer_conv`
(`upsampling.py:137-138`), it returns `(x, depthwise weight)` without
convolving: postprocessing runs the stage in a kernel
(`ops/semantic_decode.py`, `ops/instance_head.py`). In train mode the
nearest + conv form runs unless `train_polyphase`, and with
`defer_conv_train`
(`upsampling.py:109-118`) the stage returns `(x, depthwise weight)` for
the fused head loss (`ops/semantic_train_head.py`). Tensors are NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emsanet_tpu_torch.ops.polyphase_upsample import (
    upsample2x_depthwise_polyphase,
    upsample2x_depthwise_polyphase_deferred,
)

BILINEAR_MIMIC_KERNEL = np.array(
    [[0.0625, 0.1250, 0.0625],
     [0.1250, 0.2500, 0.1250],
     [0.0625, 0.1250, 0.0625]], dtype=np.float32,
)
POLYPHASE_MIN_PIXELS = 60 * 80


def nearest_x2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`jax.image.resize(..., 'bilinear')`: half-pixel centres, edges
    clamped, and a widened (antialiased) kernel when downsampling, as the
    PPM's 5x5 branch is at inputs below 160x160 pixels. Computed in f32,
    or f64 for f64 (the antialiased kernel has no bf16 CPU
    implementation)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return F.interpolate(x.to(acc), size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True).to(x.dtype)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return F.interpolate(x, size=(height, width), mode="nearest-exact")


class Upsampling(nn.Module):
    """x2 upsampling: 'learned-3x3-zeropad', 'learned-3x3', 'bilinear',
    'nearest'."""

    def __init__(self, method: str, channels: int,
                 defer_interleave: bool = False, defer_conv: bool = False,
                 defer_conv_train: bool = False, fused: bool = False,
                 train_polyphase: bool = False):
        super().__init__()
        self.method = method
        self.fused = fused
        self.train_polyphase = train_polyphase
        self.defer_interleave = defer_interleave
        self.defer_conv = defer_conv
        self.defer_conv_train = defer_conv_train
        if method in ("learned-3x3-zeropad", "learned-3x3"):
            self.depthwise = nn.Conv2d(channels, channels, 3, groups=channels,
                                       bias=False)
            with torch.no_grad():
                self.depthwise.weight.copy_(torch.from_numpy(
                    np.broadcast_to(BILINEAR_MIMIC_KERNEL,
                                    (channels, 1, 3, 3)).copy()))
        elif method not in ("bilinear", "nearest"):
            raise ValueError(f"Unknown upsampling method '{method}'")

    def forward(self, x: torch.Tensor):
        n, c, h, w = x.shape
        if self.method == "nearest":
            return nearest_x2(x)
        if self.method == "bilinear":
            return resize_bilinear(x, 2 * h, 2 * w)
        weight = self.depthwise.weight
        zeropad = self.method == "learned-3x3-zeropad"
        if self.training and self.defer_conv_train and zeropad:
            return x, weight
        if zeropad and h * w >= POLYPHASE_MIN_PIXELS and (
                self.train_polyphase if self.training else self.fused):
            if not self.training:
                if self.defer_conv:
                    return x, weight
                if self.defer_interleave:
                    return upsample2x_depthwise_polyphase_deferred(x, weight)
            return upsample2x_depthwise_polyphase(x, weight)
        weight = weight.to(x.dtype)  # f32 parameters of a bf16 train model
        up = nearest_x2(x)
        if self.method == "learned-3x3":
            up = F.pad(up, (1, 1, 1, 1), mode="replicate")
            return F.conv2d(up, weight, groups=c)
        return F.conv2d(up, weight, padding=1, groups=c)
