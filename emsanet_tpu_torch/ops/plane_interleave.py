"""Parity-plane interleave of the decode-planes pipeline's final maps.

Counterpart of `emsanet_tpu/ops/plane_interleave.py::
interleave_planes_pallas` (pl.pallas_call at :85) and of the JAX
package's `postprocessing.interleave_plane` / `deinterleave_plane`
(:351-365). A parity-plane map is (N, 4, H/2, W/2), parity p*2+q; its
full-res form is (N, H, W) with pixel (2y+p, 2x+q) = plane p*2+q at
(y, x).

On CUDA tensors `interleave_planes` sends every f32 / int32 map with
width >= 2 through ONE launch of the hand-written kernel
`csrc/plane_interleave.cu` (a bitwise copy: f32 is exact); bool and other
dtypes take the plain `interleave_plane`, as on the TPU. On CPU tensors
every map takes `interleave_plane`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from emsanet_tpu_torch.ops import _native

MAX_MAPS_PER_LAUNCH = 16  # csrc/plane_interleave.cu kMaxMaps


def interleave_plane(planes: torch.Tensor) -> torch.Tensor:
    """(N, 4, H/2, W/2) parity planes (p*2+q) -> (N, H, W)."""
    n, _, h2, w2 = planes.shape
    a = planes.reshape(n, 2, 2, h2, w2).permute(0, 3, 1, 4, 2)
    return a.reshape(n, 2 * h2, 2 * w2)


def deinterleave_plane(full: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, 4, H/2, W/2) parity planes (p*2+q)."""
    n, h, w = full.shape
    a = full.reshape(n, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3)
    return a.reshape(n, 4, h // 2, w // 2)


def interleave_planes_plain(
    named: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """`interleave_plane` per map."""
    return {name: interleave_plane(x) for name, x in named.items()}


def _takes_kernel(x: torch.Tensor) -> bool:
    return x.dtype in (torch.float32, torch.int32) and x.shape[-1] >= 2


def interleave_planes(
    named: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Interleave every map of `named`; bit-exact with
    `interleave_planes_plain`. The 4-byte maps of one shape share one
    launch (one per 16 maps)."""
    if not any(x.is_cuda for x in named.values()):
        return interleave_planes_plain(named)
    words = [name for name, x in named.items() if _takes_kernel(x)]
    out = {name: interleave_plane(x) for name, x in named.items()
           if name not in words}
    if not words:
        return out
    n, four, h2, w2 = named[words[0]].shape
    for name in words:
        x = named[name]
        _native.require_cuda_tensor(x, name, (torch.float32, torch.int32), 4)
        if tuple(x.shape) != (n, four, h2, w2) or four != 4:
            raise ValueError("interleave_planes: every 4-byte map must be "
                             f"(N, 4, H/2, W/2) of one shape, got {name} "
                             f"{tuple(x.shape)}")
        out[name] = torch.empty((n, 2 * h2, 2 * w2), dtype=x.dtype,
                                device=x.device)
    fn = _native.bind("plane_interleave", "plane_interleave_launch", 7,
                      int_args=[0, 1, 2, 3])
    for i in range(0, len(words), MAX_MAPS_PER_LAUNCH):
        chunk = words[i:i + MAX_MAPS_PER_LAUNCH]
        ins = (ctypes.c_void_p * len(chunk))(
            *(named[name].data_ptr() for name in chunk))
        outs = (ctypes.c_void_p * len(chunk))(
            *(out[name].data_ptr() for name in chunk))
        err = fn(len(chunk), n, h2, w2, ins, outs,
                 _native.stream_ptr(named[chunk[0]]))
        _INTERLEAVE_PLANES.launches += 1
        _native.check(err, "interleave_planes")
    return {name: out[name] for name in named}


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_INTERLEAVE_PLANES = interleave_planes
_INTERLEAVE_PLANES.launches = 0
