"""Pyramid pooling context module (counterpart:
`emsanet_tpu/models/context.py`).

Returns `(fused_features, context_branches)`; the first branch (global
average pool reduced to C / n_bins channels) also feeds the scene head.
It takes the encoder's output width (2048 for the bottleneck backbones)
and the model's activation; its norms stay batchnorm, as the
reference's (`emsanet_tpu/models/context.py:135-152`). Tensors are NCHW.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emsanet_tpu_torch.models.layers import ConvNormAct
from emsanet_tpu_torch.models.upsampling import (
    resize_bilinear,
    resize_nearest,
)


def bins_for(name: str) -> Tuple[int, ...]:
    name = name.lower()
    if name in ("ppm", "appm"):
        return (1, 5)
    if name in ("ppm-1-2-4-8", "appm-1-2-4-8"):
        return (1, 2, 4, 8)
    raise ValueError(f"Unknown context module '{name}'")


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int):
    """torch's adaptive average pooling: cell i averages input rows
    floor(i*H/oh) .. ceil((i+1)*H/oh), the bins of the JAX package's
    `adaptive_avg_pool`."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))


class PyramidPoolingModule(nn.Module):
    """PPM: pooled branches (1x1 conv + BN + ReLU each), upsampled back,
    concatenated with the input and fused by a 1x1 conv."""

    def __init__(self, name: str, cin: int = 512, upsampling: str = "bilinear",
                 activation: str = "relu"):
        super().__init__()
        self.bins = bins_for(name)
        self.upsampling = upsampling
        reduction = cin // len(self.bins)
        for i in range(len(self.bins)):
            setattr(self, f"branch{i}", ConvNormAct(
                cin, reduction, (1, 1), activation=activation))
        self.fuse = ConvNormAct(cin + reduction * len(self.bins), cin, (1, 1),
                                activation=activation)

    def forward(self, x: torch.Tensor):
        n, c, h, w = x.shape
        branches: List[torch.Tensor] = [x]
        context: List[torch.Tensor] = []
        for i, b in enumerate(self.bins):
            pooled = getattr(self, f"branch{i}")(adaptive_avg_pool(x, b, b))
            context.append(pooled)
            if self.upsampling == "nearest":
                branches.append(resize_nearest(pooled, h, w))
            else:
                branches.append(resize_bilinear(pooled, h, w))
        fused = self.fuse(torch.cat(branches, dim=1))
        return fused, tuple(context)


class NoContextModule(nn.Module):
    """'none': pass-through, global pool still feeds the scene head."""

    def forward(self, x: torch.Tensor):
        return x, (x.mean(dim=(2, 3), keepdim=True),)


def get_context_module(name: str, cin: int, upsampling: str,
                       activation: str = "relu") -> nn.Module:
    if name == "none":
        return NoContextModule()
    return PyramidPoolingModule(name, cin, upsampling, activation)


def context_reduction_channels(name: str, cin: int) -> int:
    return cin if name == "none" else cin // len(bins_for(name))
