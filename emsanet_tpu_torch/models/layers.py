"""Shared layers: BatchNorm, conv+norm+act, SE attention, residual blocks.

Counterpart of `emsanet_tpu/models/layers.py`. Module and parameter
names follow the flax tree (`Conv_0`, `Norm_0.BatchNorm_0`, ...), so the
flax -> PyTorch weight map (`weights.py`) is close to the identity.
Tensors inside the model are NCHW (channels_last in memory); the
kernels take the NHWC view of the same memory.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from emsanet_tpu_torch.ops import nbt1d_chain as chain_ops
from emsanet_tpu_torch.ops.stem import BN_EPS, fold_bn


class BatchNorm(nn.Module):
    """Inference BatchNorm (flax `nn.BatchNorm` with running averages)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)

    def params(self):
        return self.weight, self.bias, self.running_mean, self.running_var


class Norm(nn.Module):
    """flax `Norm` wrapper: one child `BatchNorm_0`."""

    def __init__(self, c: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


def conv(cin: int, cout: int, kernel=(3, 3), stride=(1, 1), bias=False,
         groups: int = 1) -> nn.Conv2d:
    """Conv with symmetric padding k//2 (the JAX package's `_sym_pad`)."""
    kernel = tuple(kernel)
    return nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=tuple(k // 2 for k in kernel), bias=bias,
                     groups=groups)


class ConvNormAct(nn.Module):
    """conv (no bias) -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1)):
        super().__init__()
        self.Conv_0 = conv(cin, cout, kernel, stride)
        self.Norm_0 = Norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Norm_0(self.Conv_0(x)))


class SqueezeExcitation(nn.Module):
    """Global average pool -> FC(C/16) -> ReLU -> FC(C) -> sigmoid gate."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        hidden = max(c // reduction, 1)
        self.Dense_0 = nn.Linear(c, hidden)
        self.Dense_1 = nn.Linear(hidden, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))
        s = self.Dense_1(F.relu(self.Dense_0(s)))
        return x * torch.sigmoid(s)[:, :, None, None]


class NonBottleneck1D(nn.Module):
    """Factorized residual block (ERFNet NBt1D), inference form.

    The stride applies to the first 3x1/1x3 pair, with a 1x1-conv
    shortcut when the stride or width changes. With
    `zero_init_residual` the second norm is a bare `BatchNorm_0` (the
    flax naming of that variant). Dropout is an identity at inference.
    """

    def __init__(self, cin: int, features: int, stride: int = 1,
                 zero_init_residual: bool = False):
        super().__init__()
        self.features = features
        self.stride = stride
        self.zero_init_residual = zero_init_residual
        f = features
        self.Conv_0 = conv(cin, f, (3, 1), (stride, 1), bias=True)
        self.Conv_1 = conv(f, f, (1, 3), (1, stride), bias=True)
        self.Norm_0 = Norm(f)
        self.Conv_2 = conv(f, f, (3, 1), bias=True)
        self.Conv_3 = conv(f, f, (1, 3), bias=True)
        if zero_init_residual:
            self.BatchNorm_0 = BatchNorm(f)
        else:
            self.Norm_1 = Norm(f)
        self.has_shortcut = stride != 1 or cin != f
        if self.has_shortcut:
            self.Conv_4 = conv(cin, f, (1, 1), (stride, stride))
            norm_name = "Norm_1" if zero_init_residual else "Norm_2"
            setattr(self, norm_name, Norm(f))
            self._shortcut_norm = norm_name

    def second_norm(self) -> BatchNorm:
        return self.BatchNorm_0 if self.zero_init_residual else (
            self.Norm_1.BatchNorm_0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Conv_0(x))
        h = F.relu(self.Norm_0(self.Conv_1(h)))
        h = F.relu(self.Conv_2(h))
        h = self.second_norm()(self.Conv_3(h))
        residual = x
        if self.has_shortcut:
            residual = getattr(self, self._shortcut_norm)(self.Conv_4(x))
        return F.relu(h + residual)


class BasicBlock(nn.Module):
    """ResNet basic block (3x3 + 3x3) with flax naming."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 zero_init_residual: bool = False):
        super().__init__()
        del zero_init_residual  # not used by the flax BasicBlock either
        self.ConvNormAct_0 = ConvNormAct(cin, features, (3, 3),
                                         (stride, stride))
        self.Conv_0 = conv(features, features, (3, 3))
        self.Norm_0 = Norm(features)
        self.has_shortcut = stride != 1 or cin != features
        if self.has_shortcut:
            self.Conv_1 = conv(cin, features, (1, 1), (stride, stride))
            self.Norm_1 = Norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Norm_0(self.Conv_0(self.ConvNormAct_0(x)))
        residual = x
        if self.has_shortcut:
            residual = self.Norm_1(self.Conv_1(x))
        return F.relu(h + residual)


BLOCK_CLASSES = {"nonbottleneck1d": NonBottleneck1D, "basicblock": BasicBlock}


def stack_chain_params(
    blocks: Sequence[NonBottleneck1D], dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """K blocks -> the stacked layout of `ops.nbt1d_chain` (weights in
    `dtype`, biases and folded BN in float32)."""

    def w31(cv):  # (O, I, 3, 1) -> (3, I, O)
        return cv.weight[:, :, :, 0].permute(2, 1, 0)

    def w13(cv):  # (O, I, 1, 3) -> (3, I, O)
        return cv.weight[:, :, 0, :].permute(2, 1, 0)

    out = {k: [] for k in ("w31", "b31", "w13", "b13", "bn_scale",
                           "bn_shift")}
    for b in blocks:
        out["w31"].append(torch.stack([w31(b.Conv_0), w31(b.Conv_2)]))
        out["w13"].append(torch.stack([w13(b.Conv_1), w13(b.Conv_3)]))
        out["b31"].append(torch.stack([b.Conv_0.bias, b.Conv_2.bias]))
        out["b13"].append(torch.stack([b.Conv_1.bias, b.Conv_3.bias]))
        s1, t1 = fold_bn(*b.Norm_0.BatchNorm_0.params())
        s2, t2 = fold_bn(*b.second_norm().params())
        out["bn_scale"].append(torch.stack([s1, s2]))
        out["bn_shift"].append(torch.stack([t1, t2]))
    stacked = {k: torch.stack(v).detach() for k, v in out.items()}
    for k in ("w31", "w13"):
        stacked[k] = stacked[k].to(dtype).contiguous()
    for k in ("b31", "b13", "bn_scale", "bn_shift"):
        stacked[k] = stacked[k].float().contiguous()
    return stacked


def apply_blocks_fused(blocks: Sequence[nn.Module],
                       x: torch.Tensor) -> torch.Tensor:
    """Run a residual-block sequence, sending the stride-1 NBt1D tail to
    the chain kernel (`ops/nbt1d_chain.py`).

    The tail is the maximal trailing run of stride-1 NonBottleneck1D
    blocks whose input width equals their width. Unlike the JAX package,
    whose chain gate (`nbt1d_chain.py:46-71`) encodes a TPU v5e speed
    finding, every such tail takes the kernel.
    """
    tail_start = len(blocks)
    for i in reversed(range(len(blocks))):
        b = blocks[i]
        if isinstance(b, NonBottleneck1D) and b.stride == 1:
            tail_start = i
        else:
            break
    for b in blocks[:tail_start]:
        x = b(x)
    tail = list(blocks[tail_start:])
    if not tail:
        return x
    if x.shape[1] != tail[0].features:
        for b in tail:
            x = b(x)
        return x
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    y = chain_ops.nbt1d_chain(x_nhwc, _cached_chain_params(tail, x.dtype))
    return y.permute(0, 3, 1, 2)


def _cached_chain_params(tail: Sequence[NonBottleneck1D],
                         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """`stack_chain_params`, kept on the tail's first block between calls.

    Stacking and folding is ~30 small ops per chain; at batch 1 their
    launches cost more than the chain. The cache key holds every tensor's
    storage address and in-place version counter, so loading new weights
    or moving the model rebuilds it.
    """
    tensors = [t for b in tail for t in
               list(b.parameters()) + list(b.buffers())]
    key = (dtype, tuple((t.data_ptr(), t._version) for t in tensors))
    cached = getattr(tail[0], "_chain_cache", None)
    if cached is None or cached[0] != key:
        cached = (key, stack_chain_params(tail, dtype))
        tail[0]._chain_cache = cached
    return cached[1]
