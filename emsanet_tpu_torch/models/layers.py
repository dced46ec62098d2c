"""Shared layers: BatchNorm, conv+norm+act, SE attention, residual blocks.

Counterpart of `emsanet_tpu/models/layers.py`. Module and parameter
names follow the flax tree (`Conv_0`, `Norm_0.BatchNorm_0`, ...), so the
flax -> PyTorch weight map (`weights.py`) is close to the identity.
Tensors inside the model are NCHW (channels_last in memory); the
kernels take the NHWC view of the same memory.

Training keeps float32 parameters and casts them to the activations'
dtype at each conv and dense layer, as flax's `nn.Conv(dtype=...)` does
(`Conv2d`, `Linear`); the inference model is cast to its compute dtype
as a whole, where that cast is a no-op. In train mode (`module.train()`)
BatchNorm uses batch statistics with flax's semantics, and the stride-1
NBt1D tails of `apply_blocks_fused` go through the train pair kernels
(`ops/nbt1d_train.py`) where `fused_train` and the JAX package's gate
allow it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from emsanet_tpu_torch.ops import nbt1d_chain as chain_ops
from emsanet_tpu_torch.ops import nbt1d_train as train_ops
from emsanet_tpu_torch.ops import param_cache
from emsanet_tpu_torch.ops.stem import BN_EPS, fold_bn

# flax: running = momentum * running + (1 - momentum) * batch
BN_MOMENTUM = 0.9

_DROPOUT_GENERATOR: contextvars.ContextVar[Optional[torch.Generator]] = (
    contextvars.ContextVar("dropout_generator", default=None))


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Draw the dropout masks of the forward passes inside the block from
    `generator` (the counterpart of flax's 'dropout' rng), in this thread
    or task only; the default generator of the device is used without
    one."""
    token = _DROPOUT_GENERATOR.set(generator)
    try:
        yield
    finally:
        _DROPOUT_GENERATOR.reset(token)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype (parameters cast at use)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype (parameters cast at use)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`.

    Eval: the running averages. Train: the batch mean and the biased
    variance E[x^2] - E[x]^2 (clipped at 0), reduced in f32, normalize
    the input and update the running averages in place. Not
    `F.batch_norm(training=True)`: it updates `running_var` with the
    unbiased variance.
    """

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=BN_EPS)
        xf = x.to(train_ops.acc_dtype(x.dtype))
        mean = xf.mean((0, 2, 3))
        var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean, 0.0)
        self.update_running_stats(mean, var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + (
            self.bias[:, None, None])
        return y.to(x.dtype)

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_(
            mean.detach().to(self.running_mean.dtype) * (1.0 - BN_MOMENTUM))
        self.running_var.mul_(BN_MOMENTUM).add_(
            var.detach().to(self.running_var.dtype) * (1.0 - BN_MOMENTUM))

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
         groups: int = 1) -> Conv2d:
    """Conv with symmetric padding k//2 (the JAX package's `_sym_pad`)."""
    kernel = tuple(kernel)
    return Conv2d(cin, cout, kernel, stride=stride,
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
        self.Dense_0 = Linear(c, hidden)
        self.Dense_1 = Linear(hidden, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))
        s = self.Dense_1(F.relu(self.Dense_0(s)))
        return x * torch.sigmoid(s)[:, :, None, None]


class NonBottleneck1D(nn.Module):
    """Factorized residual block (ERFNet NBt1D), inference form.

    The stride applies to the first 3x1/1x3 pair, with a 1x1-conv
    shortcut when the stride or width changes. With
    `zero_init_residual` the second norm is a bare `BatchNorm_0` (the
    flax naming of that variant). Element-wise dropout sits between the
    second norm and the residual add; it is an identity at inference.
    """

    def __init__(self, cin: int, features: int, stride: int = 1,
                 zero_init_residual: bool = False, dropout_p: float = 0.0):
        super().__init__()
        self.features = features
        self.stride = stride
        self.dropout_p = dropout_p
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
        if self.training and self.dropout_p > 0.0:
            h = train_ops.dropout(h, self.dropout_p,
                                  _DROPOUT_GENERATOR.get())
        residual = x
        if self.has_shortcut:
            residual = getattr(self, self._shortcut_norm)(self.Conv_4(x))
        return F.relu(h + residual)


class BasicBlock(nn.Module):
    """ResNet basic block (3x3 + 3x3) with flax naming."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 zero_init_residual: bool = False, dropout_p: float = 0.0):
        super().__init__()
        # neither is used by the flax BasicBlock, which has no dropout site
        del zero_init_residual, dropout_p
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


def stack_chain_train_params(
    blocks: Sequence[NonBottleneck1D],
) -> Dict[str, torch.Tensor]:
    """K blocks -> the train pairs' inputs (`ops.nbt1d_train.chain_train`):
    w31/w13 (K, 2, 3, C_in, C_out), b31/b13/gamma/beta (K, 2, C), the
    BatchNorms unfolded. Differentiable in every parameter."""

    def taps(cv, vertical):  # (O, I, 3, 1) / (O, I, 1, 3) -> (3, I, O)
        w = cv.weight[:, :, :, 0] if vertical else cv.weight[:, :, 0, :]
        return w.permute(2, 1, 0)

    def pairs(fn):
        return torch.stack([torch.stack(fn(b)) for b in blocks])

    return {
        "w31": pairs(lambda b: [taps(b.Conv_0, True), taps(b.Conv_2, True)]),
        "w13": pairs(lambda b: [taps(b.Conv_1, False),
                                taps(b.Conv_3, False)]),
        "b31": pairs(lambda b: [b.Conv_0.bias, b.Conv_2.bias]),
        "b13": pairs(lambda b: [b.Conv_1.bias, b.Conv_3.bias]),
        "gamma": pairs(lambda b: [b.Norm_0.BatchNorm_0.weight,
                                  b.second_norm().weight]),
        "beta": pairs(lambda b: [b.Norm_0.BatchNorm_0.bias,
                                 b.second_norm().bias]),
    }


def _tail_fused_train(tail: Sequence[NonBottleneck1D],
                      x: torch.Tensor) -> torch.Tensor:
    """A stride-1 NBt1D tail in train mode through the pair kernels. The
    BatchNorms' running statistics are updated here, in place on the
    blocks' buffers."""
    dropout_p = tail[0].dropout_p
    assert all(b.dropout_p == dropout_p for b in tail)
    out, mean, var = train_ops.chain_train(
        x.permute(0, 2, 3, 1).contiguous(), stack_chain_train_params(tail),
        dropout_p=dropout_p, generator=_DROPOUT_GENERATOR.get())
    for i, b in enumerate(tail):
        b.Norm_0.BatchNorm_0.update_running_stats(mean[i, 0], var[i, 0])
        b.second_norm().update_running_stats(mean[i, 1], var[i, 1])
    return out.permute(0, 3, 1, 2)


def apply_blocks_fused(blocks: Sequence[nn.Module], x: torch.Tensor,
                       fused_train: bool = False) -> torch.Tensor:
    """Run a residual-block sequence, sending the stride-1 NBt1D tail to a
    kernel: at inference the chain kernel (`ops/nbt1d_chain.py`), in
    train mode, with `fused_train`, the train pairs (`ops/nbt1d_train.py`).

    The tail is the maximal trailing run of stride-1 NonBottleneck1D
    blocks whose input width equals their width. At inference, unlike
    the JAX package, whose chain gate (`nbt1d_chain.py:46-71`) encodes a
    TPU v5e speed finding, every such tail takes the kernel. In training
    the JAX package's gate (`nbt1d_train.pairs_supported`) decides, as
    there (`layers.py:378-382`).
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
    n, c, h, w = x.shape
    if c != tail[0].features or (
        tail[0].training
        and not (fused_train and train_ops.pairs_supported(h, w, c))
    ):
        for b in tail:
            x = b(x)
        return x
    if tail[0].training:
        return _tail_fused_train(tail, x)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    y = chain_ops.nbt1d_chain(x_nhwc, _cached_chain_params(tail, x.dtype))
    return y.permute(0, 3, 1, 2)


def _cached_chain_params(tail: Sequence[NonBottleneck1D],
                         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """`stack_chain_params`, kept on the tail's first block between calls
    (`param_cache`: rebuilt when a tensor moves or is written in place).

    Stacking and folding is ~30 small ops per chain; at batch 1 their
    launches cost more than the chain. In bf16 it also holds the kernel's
    K-major weights (`wt`).
    """
    def build():
        stacked = stack_chain_params(tail, dtype)
        if dtype == torch.bfloat16:
            stacked["wt"] = chain_ops.kmajor_weights(stacked, dtype)
        return stacked

    tensors = [t for b in tail for t in
               list(b.parameters()) + list(b.buffers())]
    return param_cache.cached(tail[0], ("chain", dtype), tensors, build)
