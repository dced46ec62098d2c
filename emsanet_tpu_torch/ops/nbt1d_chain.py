"""K stride-1 NonBottleneck1D blocks at inference (folded BatchNorm).

Counterpart of `emsanet_tpu/ops/nbt1d_chain.py::nbt1d_chain`. On a CUDA
tensor `nbt1d_chain` runs the whole chain in one call of the hand-written
`csrc/nbt1d_chain.cu` (bf16: `wgmma` convs fed by TMA, the C = 64 and
C = 128 pairs in one launch each, the wider pairs in two implicit-GEMM
launches, K split across blocks where a C = 512 map gives too few tiles;
f32: the whole pair on the CUDA cores with its intermediate in shared
memory); on a CPU tensor it runs `nbt1d_chain_plain`, the block-by-block
PyTorch loop. The launch count adds one per conv pair.

`stacked` holds the chain's parameters in the JAX package's layout
(`stack_chain_params` there): w31/w13 (K, 2, 3, C_in, C_out),
b31/b13/bn_scale/bn_shift (K, 2, C). x is NHWC. The bf16 kernels take
the weights K-major (`kmajor_weights`); `stacked["wt"]`, where present in
x's dtype, holds them already (`models/layers.py` caches them so).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from emsanet_tpu_torch.ops import _native

Stacked = Dict[str, torch.Tensor]


def nbt1d_chain_plain(x: torch.Tensor, stacked: Stacked) -> torch.Tensor:
    """Plain PyTorch: every conv a conv2d, block by block."""
    dt = x.dtype
    h = x.permute(0, 3, 1, 2)
    for k in range(stacked["w31"].shape[0]):
        y = h
        for i in range(2):
            w31 = stacked["w31"][k, i].permute(2, 1, 0)[..., None].to(dt)
            w13 = stacked["w13"][k, i].permute(2, 1, 0)[:, :, None].to(dt)
            y = F.relu(F.conv2d(y, w31, stacked["b31"][k, i].to(dt),
                                padding=(1, 0)))
            y = F.conv2d(y, w13, stacked["b13"][k, i].to(dt), padding=(0, 1))
            s = stacked["bn_scale"][k, i].to(dt)[None, :, None, None]
            t = stacked["bn_shift"][k, i].to(dt)[None, :, None, None]
            y = y * s + t
            if i == 1:
                y = y + h
            y = F.relu(y)
        h = y
    return h.permute(0, 2, 3, 1).contiguous()


def kmajor_weights(stacked: Stacked, dtype: torch.dtype) -> torch.Tensor:
    """w31 and w13 as one (K, 2, 2, 3, C_out, C_in) tensor in dtype:
    [block][pair][conv][tap], each tap's (C_out, C_in) matrix K-major, the
    layout of the bf16 kernels' weight operand."""
    wt = torch.stack([stacked["w31"], stacked["w13"]], dim=2)
    return wt.transpose(-1, -2).to(dtype).contiguous()


def nbt1d_chain(x: torch.Tensor, stacked: Stacked) -> torch.Tensor:
    """Run the K blocks of `stacked` over x (N, H, W, C)."""
    if not x.is_cuda:
        return nbt1d_chain_plain(x, stacked)
    _native.require_cuda_tensor(x, "x", (torch.float32, torch.bfloat16), 4)
    if x.data_ptr() % 16:
        raise ValueError("nbt1d_chain: x must be 16-byte aligned")
    n, h, w, c = x.shape
    if c % 64 or not 64 <= c <= 512:
        raise ValueError(f"nbt1d_chain takes C in [64, 512], a multiple of "
                         f"64; got {c}")
    k = stacked["w31"].shape[0]
    for key in ("w31", "w13"):
        if tuple(stacked[key].shape) != (k, 2, 3, c, c) or not (
            stacked[key].is_cuda
        ):
            raise ValueError(f"{key} must be a CUDA tensor "
                             f"({k}, 2, 3, {c}, {c})")
    vecs = {key: stacked[key].float().contiguous()
            for key in ("b31", "b13", "bn_scale", "bn_shift")}
    for key, v in vecs.items():
        if tuple(v.shape) != (k, 2, c) or not v.is_cuda:
            raise ValueError(f"{key} must be a CUDA tensor ({k}, 2, {c})")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        wt = stacked.get("wt")
        if wt is None or wt.dtype != x.dtype or tuple(wt.shape) != (
                k, 2, 2, 3, c, c):
            wt = kmajor_weights(stacked, x.dtype)
        w31 = w13 = None
    else:
        wt = None
        w31 = stacked["w31"].float().contiguous()
        w13 = stacked["w13"].float().contiguous()
    ws_floats = _native.bind("nbt1d_chain", "nbt1d_chain_workspace", 4,
                             int_args=[0, 1, 2, 3])(n, h, w, c) if bf16 else 0
    ws = torch.empty(max(ws_floats, 1), device=x.device, dtype=torch.float32)
    # scratch of x's size: the bf16 conv3x1 output, a block's first pair's
    # output, and the two block outputs the call alternates between
    t, mid, p0, p1 = (torch.empty_like(x) for _ in range(4))
    fn = _native.bind("nbt1d_chain", "nbt1d_chain_launch", 20,
                      int_args=[0, 1, 2, 3, 4, 5])
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    err = fn(int(bf16), n, h, w, c, k, x.data_ptr(), ptr(w31), ptr(w13),
             ptr(wt), vecs["b31"].data_ptr(), vecs["b13"].data_ptr(),
             vecs["bn_scale"].data_ptr(), vecs["bn_shift"].data_ptr(),
             t.data_ptr(), mid.data_ptr(), p0.data_ptr(), p1.data_ptr(),
             ws.data_ptr(), _native.stream_ptr(x))
    _NBT1D_CHAIN.launches += 2 * k  # one per conv pair
    _native.check(err, "nbt1d_chain")
    return p0 if k % 2 else p1


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_NBT1D_CHAIN = nbt1d_chain
_NBT1D_CHAIN.launches = 0
