"""Train-mode NonBottleneck1D conv pairs, forward and backward.

Counterpart of `emsanet_tpu/ops/nbt1d_train.py`. One pair is

    y = conv1x3(relu(conv3x1(prologue(u)) + b31)) + b13

with the prologue the identity ('plain') or relu(s * u + t) ('affine',
the previous BatchNorm folded into a per-channel affine), zero padding
applied after the prologue, the intermediate and y rounded to the
compute dtype, and `sums` = [sum y, sum y^2] per channel in f32, taken
from the rounded y: the BatchNorm batch statistics of the pair's output.

`nbt1d_pair` is a `torch.autograd.Function` over two hand-written CUDA
kernels, `csrc/nbt1d_train.cu` (`pair_fwd`, `pair_bwd`): in bf16 on the
tensor cores, in f32 on the CUDA cores. On CPU tensors it runs
`pair_fwd_plain`, PyTorch ops differentiated by autograd
(`pair_bwd_plain` is that gradient). Tensors are NHWC: u, y (N, H, W, C)
in the compute dtype; w31, w13 (3, C_in, C_out); s, t, b31, b13 (C) f32.

`chain_train` runs K stride-1 blocks of a chain through the pairs, with
the BatchNorm affine from the pairs' sums and the block boundary (BN2
affine, dropout, residual add, ReLU) in plain PyTorch, as the JAX
package keeps it in XLA. The caller updates the BatchNorm running
statistics in place on the blocks' buffers (`models/layers.py`), so the
flax `sow` / `merge_fused_bn_updates` plumbing has no counterpart here.
The C=64 pixel-pair merge of the JAX package is a TPU lane-width rewrite
and is not ported: the kernels take C=64 directly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from emsanet_tpu_torch.ops import _native

# channel widths of the pair kernels (emsanet_tpu/ops/nbt1d_train.py)
SUPPORTED_CHANNELS = (64, 128, 256)
# the JAX package's gate of where chains take the pair kernels, copied as
# it stands so that both packages take the same path at every shape. It
# was sized on a TPU v5e, not on the H100 (PERF.md). Tests set it to 0.
MIN_PIXELS = 16384

Stacked = Dict[str, torch.Tensor]


def pairs_supported(h: int, w: int, c: int) -> bool:
    """`emsanet_tpu/ops/nbt1d_train.py::pairs_supported`, copied."""
    if c not in SUPPORTED_CHANNELS:
        return False
    if c == 64:
        if w % 16 != 0:
            return False
    elif w % 8 != 0:
        return False
    min_px = MIN_PIXELS * (4 if c >= 256 else 1)
    return h >= 8 and h * w >= min_px


# ---------------------------------------------------------------------------
# plain version


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a compute dtype: f32, or f64 for f64."""
    return torch.promote_types(dt, torch.float32)


def _round(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x rounded to dt, kept in x's dtype, with an identity gradient: the
    value the kernels store in dt, with the f32 gradient they form."""
    return x + (x.to(dt).to(x.dtype) - x).detach()


def pair_fwd_plain(mode: str, u, s, t, w31, b31, w13, b13):
    """(y, sums) in PyTorch ops. The convs run in f32 on operands rounded
    to the compute dtype (exact products, f32 sums). The prologue, the
    intermediate and y are rounded to the compute dtype where the kernels
    round them; their gradients stay f32, as in the kernels (and the JAX
    package's custom VJP), where bf16 gradients would drop the sums'
    cotangent against gy."""
    dt, acc = u.dtype, acc_dtype(u.dtype)
    v = u.permute(0, 3, 1, 2).to(acc)
    if mode == "affine":
        v = _round(F.relu(v * s[:, None, None] + t[:, None, None]), dt)
    k31 = w31.to(dt).to(acc).permute(2, 1, 0)[..., None]     # (O, I, 3, 1)
    k13 = w13.to(dt).to(acc).permute(2, 1, 0)[:, :, None]    # (O, I, 1, 3)
    a = _round(F.relu(F.conv2d(v, k31, b31.to(acc), padding=(1, 0))), dt)
    yf = _round(F.conv2d(a, k13, b13.to(acc), padding=(0, 1)), dt)
    sums = torch.stack([yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))])
    return yf.to(dt).permute(0, 2, 3, 1), sums


def pair_bwd_plain(mode: str, u, s, t, w31, b31, w13, b13, gy, gsums):
    """(gu, gs, gt, gw31, gb31, gw13, gb13): autograd of `pair_fwd_plain`
    (gs, gt zero in 'plain' mode)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)
                  for x in (u, s, t, w31, b31, w13, b13)]
        y, sums = pair_fwd_plain(mode, *leaves)
        grads = torch.autograd.grad(
            (y, sums), leaves, (gy.to(y.dtype), gsums.to(sums.dtype)),
            allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads))


# ---------------------------------------------------------------------------
# kernels


def _check(mode, u, vecs, weights):
    _native.require_cuda_tensor(u, "u", (torch.float32, torch.bfloat16), 4)
    n, h, w, c = u.shape
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"nbt1d_pair takes C in {SUPPORTED_CHANNELS}, "
                         f"got {c}")
    if mode not in ("plain", "affine"):
        raise ValueError(f"nbt1d_pair mode must be 'plain' or 'affine', got "
                         f"'{mode}'")
    for v in vecs:
        if tuple(v.shape) != (c,) or not v.is_cuda:
            raise ValueError(f"per-channel vectors must be CUDA tensors "
                             f"({c},)")
    for wt in weights:
        if tuple(wt.shape) != (3, c, c) or not wt.is_cuda:
            raise ValueError(f"weights must be CUDA tensors (3, {c}, {c})")
    return n, h, w, c


def _f32(*vs):
    return [v.detach().float().contiguous() for v in vs]


def _workspace(fn: str, dt: torch.dtype, n: int, h: int, w: int, c: int,
               device) -> torch.Tensor:
    """The kernels' f32 scratch for one call (partial sums)."""
    size = _native.bind("nbt1d_train", fn, 5, int_args=[0, 1, 2, 3, 4])(
        int(dt == torch.bfloat16), n, h, w, c)
    if size < 0:  # the bf16 kernels cannot be resident on this card
        _native.check(-size, fn)
    return torch.empty(size, device=device, dtype=torch.float32)


def _aligned(*ts):
    """The bf16 kernels copy 16-byte pieces: every operand must start on a
    16-byte boundary."""
    for x in ts:
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError("nbt1d_pair: operands must be 16-byte aligned")


def pair_fwd(mode: str, u, s, t, w31, b31, w13, b13):
    """The forward kernel: (y, sums)."""
    n, h, w, c = _check(mode, u, (s, t, b31, b13), (w31, w13))
    dt = u.dtype
    s, t, b31, b13 = _f32(s, t, b31, b13)
    w31, w13 = (x.detach().to(dt).contiguous() for x in (w31, w13))
    work = _workspace("nbt1d_train_fwd_workspace", dt, n, h, w, c, u.device)
    y = torch.empty_like(u)
    _aligned(u, w31, w13, y)
    sums = torch.empty((2, c), device=u.device, dtype=torch.float32)
    fn = _native.bind("nbt1d_train", "nbt1d_train_fwd_launch", 17,
                      int_args=[0, 1, 2, 3, 4, 5])
    err = fn(int(dt == torch.bfloat16), int(mode == "affine"), n, h, w, c,
             u.data_ptr(), s.data_ptr(), t.data_ptr(), w31.data_ptr(),
             b31.data_ptr(), w13.data_ptr(), b13.data_ptr(), y.data_ptr(),
             sums.data_ptr(), work.data_ptr(), _native.stream_ptr(u))
    _PAIR_FWD.launches += 1
    _native.check(err, "nbt1d_train_fwd")
    return y, sums


def pair_bwd(mode: str, u, s, t, w31, b31, w13, b13, gy, gsums):
    """The backward kernels: (gu, gs, gt, gw31, gb31, gw13, gb13), the
    vectors and weight gradients in f32. The intermediate gradients dy
    and da are kept in the compute dtype: in bf16 they are rounded before
    the tensor cores take them, as the TPU kernel rounds them for its
    matrix unit."""
    n, h, w, c = _check(mode, u, (s, t, b31, b13), (w31, w13))
    dt = u.dtype
    s, t, b31, b13 = _f32(s, t, b31, b13)
    gsums = gsums.detach().float().contiguous()
    gy = gy.detach().to(dt).contiguous()
    if tuple(gy.shape) != tuple(u.shape) or tuple(gsums.shape) != (2, c):
        raise ValueError("pair_bwd: gy must match u and gsums be (2, C)")
    w31, w13 = (x.detach().to(dt).contiguous() for x in (w31, w13))
    # the transposed convs read the weights tap-reversed, (C_out, C_in)
    w31t = w31.flip(0).transpose(1, 2).contiguous()
    w13t = w13.flip(0).transpose(1, 2).contiguous()
    work = _workspace("nbt1d_train_bwd_workspace", dt, n, h, w, c, u.device)
    a_act = torch.empty_like(u)  # the recomputed intermediate
    g_act = torch.empty((2,) + tuple(u.shape), device=u.device,
                        dtype=dt)  # dy, da
    gu = torch.empty_like(u)
    _aligned(u, gy, w31, w13, w31t, w13t, a_act, g_act, gu)
    gvec = torch.empty((4, c), device=u.device, dtype=torch.float32)
    gw31 = torch.empty((3, c, c), device=u.device, dtype=torch.float32)
    gw13 = torch.empty_like(gw31)
    fn = _native.bind("nbt1d_train", "nbt1d_train_bwd_launch", 25,
                      int_args=[0, 1, 2, 3, 4, 5])
    err = fn(int(dt == torch.bfloat16), int(mode == "affine"), n, h, w, c,
             u.data_ptr(), gy.data_ptr(), gsums.data_ptr(), s.data_ptr(),
             t.data_ptr(), w31.data_ptr(), b31.data_ptr(), w13.data_ptr(),
             b13.data_ptr(), w31t.data_ptr(), w13t.data_ptr(), gu.data_ptr(),
             gvec.data_ptr(), gw31.data_ptr(), gw13.data_ptr(),
             a_act.data_ptr(), g_act.data_ptr(), work.data_ptr(),
             _native.stream_ptr(u))
    _PAIR_BWD.launches += 1
    _native.check(err, "nbt1d_train_bwd")
    gs, gt, gb31, gb13 = gvec.unbind(0)
    return gu, gs, gt, gw31, gb31, gw13, gb13


class _Pair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mode, u, s, t, w31, b31, w13, b13):
        ctx.mode = mode
        ctx.save_for_backward(u, s, t, w31, b31, w13, b13)
        return pair_fwd(mode, u, s, t, w31, b31, w13, b13)

    @staticmethod
    def backward(ctx, gy, gsums):
        u, s, t, w31, b31, w13, b13 = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(u)
        if gsums is None:
            gsums = torch.zeros((2, u.shape[-1]), device=u.device)
        gu, gs, gt, gw31, gb31, gw13, gb13 = pair_bwd(
            ctx.mode, u, s, t, w31, b31, w13, b13, gy, gsums)
        return (None, gu, gs.to(s.dtype), gt.to(t.dtype), gw31.to(w31.dtype),
                gb31.to(b31.dtype), gw13.to(w13.dtype), gb13.to(b13.dtype))


def nbt1d_pair(mode: str, u, s, t, w31, b31, w13, b13
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pair: (y, sums), differentiable in every tensor argument."""
    if not u.is_cuda:
        return pair_fwd_plain(mode, u, s, t, w31, b31, w13, b13)
    return _Pair.apply(mode, u, s, t, w31, b31, w13, b13)


# the launch counts live on the function objects; the bodies reach them
# through these aliases, which wrapping the module attributes leaves alone
_PAIR_FWD = pair_fwd
_PAIR_FWD.launches = 0
_PAIR_BWD = pair_bwd
_PAIR_BWD.launches = 0


# ---------------------------------------------------------------------------
# chain orchestration


def bn_affine(gamma, beta, sums, count: int, eps: float):
    """Batch statistics and the normalization affine from a pair's sums:
    (s, t, mean, var), var the biased variance flax's BatchNorm uses for
    the normalization and the running update."""
    mean = sums[0] / count
    var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
    s = gamma * torch.rsqrt(var + eps)
    return s, beta - mean * s, mean, var


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout, flax's `nn.Dropout`: keep with 1 - p, scale
    the kept values by 1 / (1 - p)."""
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def chain_train(x: torch.Tensor, stacked: Stacked, dropout_p: float = 0.0,
                generator: Optional[torch.Generator] = None,
                eps: float = 1e-5):
    """K stride-1 NBt1D blocks in train mode through the pairs.

    x: (N, H, W, C) NHWC. stacked: `stack_chain_train_params`, w31/w13
    (K, 2, 3, C, C), b31/b13/gamma/beta (K, 2, C). Returns (out, batch
    mean (K, 2, C), batch var (K, 2, C)). Dropout (between BN2 and the
    residual add) runs where `dropout_p` > 0, drawn from `generator`.
    """
    n, h, w, c = x.shape
    count = n * h * w
    acc = acc_dtype(x.dtype)
    ones = torch.ones(c, device=x.device, dtype=acc)
    zeros = torch.zeros(c, device=x.device, dtype=acc)
    means, variances = [], []
    xk = x
    for i in range(stacked["w31"].shape[0]):
        p1, sums1 = nbt1d_pair(
            "plain", xk, ones, zeros, stacked["w31"][i, 0],
            stacked["b31"][i, 0], stacked["w13"][i, 0], stacked["b13"][i, 0])
        s1, t1, m1, v1 = bn_affine(stacked["gamma"][i, 0],
                                   stacked["beta"][i, 0], sums1, count, eps)
        p2, sums2 = nbt1d_pair(
            "affine", p1, s1, t1, stacked["w31"][i, 1],
            stacked["b31"][i, 1], stacked["w13"][i, 1], stacked["b13"][i, 1])
        s2, t2, m2, v2 = bn_affine(stacked["gamma"][i, 1],
                                   stacked["beta"][i, 1], sums2, count, eps)
        means.append(torch.stack([m1, m2]))
        variances.append(torch.stack([v1, v2]))
        # block boundary: BN2 affine + dropout + residual add + relu
        hblk = (p2.to(acc) * s2 + t2).to(x.dtype)
        if dropout_p > 0.0:
            hblk = dropout(hblk, dropout_p, generator)
        xk = F.relu(hblk + xk)
    return xk, torch.stack(means), torch.stack(variances)
