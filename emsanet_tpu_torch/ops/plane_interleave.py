"""Parity-plane interleave of the decode-planes pipeline's final maps.

Counterpart of `emsanet_tpu/ops/plane_interleave.py::
interleave_planes_pallas` (pl.pallas_call at :85) and of the JAX
package's `postprocessing.interleave_plane` / `deinterleave_plane`
(:351-365). A parity-plane map is (N, 4, H/2, W/2), parity p*2+q; its
full-res form is (N, H, W) with pixel (2y+p, 2x+q) = plane p*2+q at
(y, x).

`interleave_planes` sends every f32 / int32 map and every 1-byte map
(bool, uint8, int8) with width >= 2 through the custom op
`emsanet::interleave_planes` (`_native.kernel_op`): on CUDA tensors ONE
launch of the hand-written kernel `csrc/plane_interleave.cu` (a bitwise
copy: f32 is exact), on CPU tensors `interleave_plane` per map; other
dtypes take the plain `interleave_plane`, as on the TPU. The op returns
one byte buffer that holds the outputs one after another, and each
output map is a view of it: a caller that keeps one
of them keeps the memory of all of them (about 61 MB for the
decode-planes frame's maps at b8), and `torch.save` of one writes the
whole buffer; `.clone()` a map to keep it alone.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from emsanet_tpu_torch.ops import _native

MAX_MAPS_PER_LAUNCH = 16  # csrc/plane_interleave.cu kMaxMaps
# element size of each dtype the kernel takes
KERNEL_DTYPES = {torch.float32: 4, torch.int32: 4, torch.bool: 1,
                 torch.uint8: 1, torch.int8: 1}
_Pointers = ctypes.c_void_p * MAX_MAPS_PER_LAUNCH
_Sizes = ctypes.c_int * MAX_MAPS_PER_LAUNCH


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


def _interleave_planes_cuda(maps: List[torch.Tensor]) -> torch.Tensor:
    """The kernel launches (the op's CUDA implementation): every map
    woven into one byte buffer, the maps one after another in the order
    given."""
    n, _, h2, w2 = maps[0].shape
    plane = n * 4 * h2 * w2  # elements of one output map
    buf = torch.empty(sum(KERNEL_DTYPES[x.dtype] for x in maps) * plane,
                      dtype=torch.uint8, device=maps[0].device)
    base = buf.data_ptr()
    ins, outs, sizes = [], [], []
    offset = 0  # bytes
    for x in maps:
        size = KERNEL_DTYPES[x.dtype]
        ins.append(x.data_ptr())
        outs.append(base + offset)
        sizes.append(size)
        offset += size * plane
    fn = _native.bind("plane_interleave", "plane_interleave_launch", 8,
                      int_args=[0, 1, 2, 3])
    stream = _native.stream_ptr(buf)
    for i in range(0, len(maps), MAX_MAPS_PER_LAUNCH):
        m = min(MAX_MAPS_PER_LAUNCH, len(maps) - i)
        err = fn(m, n, h2, w2, _Pointers(*ins[i:i + m]),
                 _Pointers(*outs[i:i + m]), _Sizes(*sizes[i:i + m]), stream)
        _INTERLEAVE_PLANES.launches += 1
        _native.check(err, "interleave_planes")
    return buf


def _interleave_planes_plain_bytes(maps: List[torch.Tensor]) -> torch.Tensor:
    """The op's CPU implementation: `interleave_plane` per map, in the
    kernel's byte layout."""
    return torch.cat([interleave_plane(x).reshape(-1).view(torch.uint8)
                      for x in maps])


_OP = _native.kernel_op(
    "interleave_planes", "(Tensor[] maps) -> Tensor",
    _interleave_planes_cuda, _interleave_planes_plain_bytes,
    lambda maps: maps[0].new_empty(
        (sum(KERNEL_DTYPES[x.dtype] for x in maps) * maps[0].numel(),),
        dtype=torch.uint8))


def interleave_planes(
    named: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Interleave every map of `named`; bit-exact with
    `interleave_planes_plain`. The kernel's maps (the op
    `emsanet::interleave_planes`) must share one shape and go through
    one launch per 16 maps; their outputs share one buffer (see the
    module's docstring)."""
    out, words, octets = {}, [], []
    shape = None
    for name, x in named.items():
        size = KERNEL_DTYPES.get(x.dtype)
        s = x.shape
        if size is None or s[-1] < 2:
            out[name] = interleave_plane(x)
            continue
        if shape is None:
            shape = s
        if (s != shape or len(s) != 4 or s[1] != 4
                or x.device != named[next(iter(named))].device
                or not x.is_contiguous()):
            raise ValueError("interleave_planes: every map of the kernel "
                             "must be a contiguous (N, 4, H/2, W/2) of one "
                             f"shape on one device, got {name} "
                             f"{tuple(s)} on {x.device}")
        (words if size == 4 else octets).append((name, x))
    if shape is None:
        return out
    n, _, h2, w2 = shape
    plane = n * 4 * h2 * w2  # elements of one output map
    # one allocation, the 4-byte maps first: every output then starts on a
    # 16-byte boundary wherever the 1-byte maps' rows allow their 16-byte
    # path; each output is a view of it in its own dtype
    kernel = words + octets
    buf = _OP([x for _, x in kernel])
    offset = 0  # bytes
    for name, x in kernel:
        size = KERNEL_DTYPES[x.dtype]
        out[name] = buf[offset:offset + size * plane].view(x.dtype).view(
            n, 2 * h2, 2 * w2)
        offset += size * plane
    return {name: out[name] for name in named}


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_INTERLEAVE_PLANES = interleave_planes
_INTERLEAVE_PLANES.launches = 0
