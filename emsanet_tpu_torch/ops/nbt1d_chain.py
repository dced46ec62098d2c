"""K stride-1 NonBottleneck1D blocks at inference (folded BatchNorm).

Counterpart of `emsanet_tpu/ops/nbt1d_chain.py::nbt1d_chain`. On a CUDA
tensor `nbt1d_chain` launches the hand-written kernel
`csrc/nbt1d_chain.cu` twice per block, once per conv pair (in bf16 two
implicit-GEMM convs on the tensor cores, in f32 the whole pair on the CUDA
cores with its intermediate in shared memory); on a CPU tensor it runs
`nbt1d_chain_plain`, the block-by-block PyTorch loop.

`stacked` holds the chain's parameters in the JAX package's layout
(`stack_chain_params` there): w31/w13 (K, 2, 3, C_in, C_out),
b31/b13/bn_scale/bn_shift (K, 2, C). x is NHWC.
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
    w31 = stacked["w31"].to(x.dtype).contiguous()
    w13 = stacked["w13"].to(x.dtype).contiguous()
    vecs = {key: stacked[key].float().contiguous()
            for key in ("b31", "b13", "bn_scale", "bn_shift")}
    for key, v in vecs.items():
        if tuple(v.shape) != (k, 2, c) or not v.is_cuda:
            raise ValueError(f"{key} must be a CUDA tensor ({k}, 2, {c})")
    fn = _native.bind("nbt1d_chain", "nbt1d_pair_launch", 16,
                      int_args=[0, 1, 2, 3, 4])
    dtype_code = int(x.dtype == torch.bfloat16)
    stream = _native.stream_ptr(x)
    scratch = torch.empty_like(x) if dtype_code else None
    cur = x
    for blk in range(k):
        mid = torch.empty_like(x)
        out = torch.empty_like(x)
        for i, (src, dst, res) in enumerate(((cur, mid, None),
                                             (mid, out, cur))):
            err = fn(dtype_code, n, h, w, c, src.data_ptr(),
                     w31[blk, i].data_ptr(), vecs["b31"][blk, i].data_ptr(),
                     w13[blk, i].data_ptr(), vecs["b13"][blk, i].data_ptr(),
                     vecs["bn_scale"][blk, i].data_ptr(),
                     vecs["bn_shift"][blk, i].data_ptr(),
                     None if res is None else res.data_ptr(),
                     None if scratch is None else scratch.data_ptr(),
                     dst.data_ptr(), stream)
            _NBT1D_CHAIN.launches += 1
            _native.check(err, "nbt1d_pair")
        cur = out
    return cur


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_NBT1D_CHAIN = nbt1d_chain
_NBT1D_CHAIN.launches = 0
