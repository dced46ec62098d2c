"""Segment reductions of the panoptic merge.

Counterpart of `emsanet_tpu/ops/segment_pallas.py`.
`segment_hist_and_sums` and `segment_lookup` are the custom ops
`emsanet::segment_hist_and_sums` and `emsanet::segment_lookup`
(`_native.kernel_op`). On CUDA tensors they launch the hand-written
kernels of `csrc/segment.cu`; on CPU tensors they run their plain
versions (scatter_add / gather with the one-hot semantics of
`emsanet_tpu/ops/segment_ops.py`: keys outside [0, S) contribute
nothing and look up 0).

The histogram kernel cuts each image into spans of whole tiles of
pixels, one block each, and writes one partial table per block to a
workspace that a second launch adds up in a fixed order. `hist_plan`
sizes the spans from the card's SM count and the kernel's blocks per SM;
the tile and the workspace's size come from `csrc/segment.cu`. The
lookup kernel takes 4 pixels a thread, in a grid of at most one wave
that stages each image's table once per block.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from emsanet_tpu_torch.ops import _native


def hist_plan(n: int, p: int, tile: int, sms: int,
              per_sm: int) -> Tuple[int, int]:
    """(blocks per image, tiles per block) of the histogram kernel for
    images of `p` pixels cut into tiles of `tile`: the fewest tiles per
    block that let every block of the N images be resident at once
    (`sms` x `per_sm` blocks; with more images than that, one block per
    image), and then as few blocks as cover each image's tiles. At least
    one of each."""
    tiles = max(1, -(-p // tile))
    room = max(1, sms * per_sm)
    per_block = min(tiles, -(-n * tiles // room))
    while per_block < tiles and n * -(-tiles // per_block) > room:
        per_block += 1
    return -(-tiles // per_block), per_block


_HIST_SHAPE: Dict[Tuple[int, int, int, int], Tuple[int, int, int, int]] = {}


def _hist_shape(device: torch.device, s: int, c: int,
                d: int) -> Tuple[int, int, int, int]:
    """(pixels per tile, SMs, blocks of the histogram kernel per SM,
    workspace floats per block) on `device`, asked once per device and
    table shape."""
    key = (device.index or 0, s, c, d)
    if key not in _HIST_SHAPE:
        tile = _native.bind("segment", "segment_hist_tile", 0, [])()
        block_floats = _native.bind("segment", "segment_hist_block_floats",
                                    3, int_args=[0, 1, 2])(s, c, d)
        fn = _native.bind("segment", "segment_hist_blocks_per_sm", 3,
                          int_args=[0, 1, 2])
        with torch.cuda.device(device):
            per_sm = fn(s, c, d)
        if per_sm < 0:
            _native.check(-per_sm, "segment_hist_and_sums (occupancy)")
        if per_sm == 0:
            raise ValueError(f"segment_hist_and_sums: a table of {s} segments"
                             f" x ({c} classes + {d}) does not fit in shared "
                             "memory")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _HIST_SHAPE[key] = (tile, sms, per_sm, block_floats)
    return _HIST_SHAPE[key]


def _in_range(keys: torch.Tensor, size: int) -> torch.Tensor:
    return (keys >= 0) & (keys < size)


def segment_hist_and_sums_plain(
    inst: torch.Tensor, sem: torch.Tensor, weights: torch.Tensor,
    vectors: torch.Tensor, num_segments: int, num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: scatter_add over combined keys."""
    n, p = inst.shape
    d = vectors.shape[-1]
    ok = _in_range(inst, num_segments)
    ok_h = ok & _in_range(sem, num_classes)
    key = torch.where(ok_h, inst * num_classes + sem, 0).long()
    w = torch.where(ok_h, weights.float(), 0.0)
    hist = torch.zeros((n, num_segments * num_classes), dtype=torch.float32,
                       device=inst.device).scatter_add_(1, key, w)
    seg = torch.where(ok, inst, 0).long()
    vec = torch.where(ok[..., None], vectors.float(), 0.0)
    sums = torch.zeros((n, num_segments, d), dtype=torch.float32,
                       device=inst.device)
    sums.scatter_add_(1, seg[..., None].expand(n, p, d), vec)
    return hist.view(n, num_segments, num_classes), sums


def _segment_hist_and_sums_cuda(
    inst: torch.Tensor, sem: torch.Tensor, weights: torch.Tensor,
    vectors: torch.Tensor, num_segments: int, num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launches (the op's CUDA implementation)."""
    _native.require_cuda_tensor(inst, "inst", (torch.int32,), 2)
    _native.require_cuda_tensor(sem, "sem", (torch.int32,), 2)
    _native.require_cuda_tensor(weights, "weights", (torch.float32,), 2)
    _native.require_cuda_tensor(vectors, "vectors", (torch.float32,), 3)
    n, p = inst.shape
    d = vectors.shape[-1]
    if sem.shape != inst.shape or weights.shape != inst.shape or tuple(
        vectors.shape[:2]
    ) != (n, p):
        raise ValueError("segment_hist_and_sums: inputs must share (N, P)")
    if d < 1 or num_segments < 1 or num_classes < 1:
        raise ValueError(f"segment_hist_and_sums: D, S and C must be >= 1, "
                         f"got D = {d}, S = {num_segments}, "
                         f"C = {num_classes}")
    hist = torch.empty((n, num_segments, num_classes), dtype=torch.float32,
                       device=inst.device)
    sums = torch.empty((n, num_segments, d), dtype=torch.float32,
                       device=inst.device)
    if n == 0:
        return hist, sums
    tile, sms, per_sm, block_floats = _hist_shape(
        inst.device, num_segments, num_classes, min(d, 2))
    blocks, tiles = hist_plan(n, p, tile, sms, per_sm)
    part = torch.empty((n, blocks, block_floats), dtype=torch.float32,
                       device=inst.device)
    fn = _native.bind("segment", "segment_hist_and_sums_launch", 15,
                      int_args=[0, 1, 2, 3, 4, 5, 6])
    for off in range(0, d, 2):
        vec, out = vectors, sums
        if d > 2:
            vec = vectors[..., off:off + 2].contiguous()
            out = torch.empty((n, num_segments, vec.shape[-1]),
                              dtype=torch.float32, device=inst.device)
        err = fn(n, p, num_segments, num_classes, vec.shape[-1], blocks,
                 tiles, inst.data_ptr(), sem.data_ptr(), weights.data_ptr(),
                 vec.data_ptr(), hist.data_ptr(), out.data_ptr(),
                 part.data_ptr(), _native.stream_ptr(inst))
        _native.check(err, "segment_hist_and_sums")
        if out is not sums:
            sums[..., off:off + 2] = out
    _SEGMENT_HIST_AND_SUMS.launches += 1
    return hist, sums


def _segment_hist_and_sums_fake(inst, sem, weights, vectors, num_segments,
                                num_classes):
    n = inst.shape[0]
    return (weights.new_empty((n, num_segments, num_classes)),
            weights.new_empty((n, num_segments, vectors.shape[-1])))


_HIST_OP = _native.kernel_op(
    "segment_hist_and_sums",
    "(Tensor inst, Tensor sem, Tensor weights, Tensor vectors, "
    "int num_segments, int num_classes) -> (Tensor, Tensor)",
    _segment_hist_and_sums_cuda, segment_hist_and_sums_plain,
    _segment_hist_and_sums_fake)


def segment_hist_and_sums(
    inst: torch.Tensor, sem: torch.Tensor, weights: torch.Tensor,
    vectors: torch.Tensor, num_segments: int, num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hist (N, S, C), vec_sums (N, S, D)) over pixels (the op
    `emsanet::segment_hist_and_sums`).

    inst/sem: (N, P) int32; weights: (N, P) f32; vectors: (N, P, D) f32.
    The kernel takes D = 1 or 2 (the merge's); larger D is cut into
    calls of two components, each writing the histogram again (the same
    bits).
    """
    return _HIST_OP(inst, sem, weights, vectors, num_segments, num_classes)


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_SEGMENT_HIST_AND_SUMS = segment_hist_and_sums
_SEGMENT_HIST_AND_SUMS.launches = 0


def segment_lookup_plain(inst: torch.Tensor,
                         tables: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: gather, 0 for keys outside the table."""
    n, p = inst.shape
    d, s = tables.shape[1], tables.shape[2]
    ok = _in_range(inst, s)
    key = torch.where(ok, inst, 0).long()[:, None, :].expand(n, d, p)
    out = torch.gather(tables.float(), 2, key)
    return torch.where(ok[:, None, :], out, 0.0)


_LOOKUP_LAUNCH = None  # the bound C function, set on the first launch


def _lookup_launch():
    global _LOOKUP_LAUNCH
    _LOOKUP_LAUNCH = _native.bind("segment", "segment_lookup_launch", 8,
                                  int_args=[0, 1, 2, 3])
    return _LOOKUP_LAUNCH


def _lookup_shape(inst: torch.Tensor,
                  tables: torch.Tensor) -> Tuple[int, int, int, int]:
    """(N, P, D, S); raises unless inst is (N, P) int32 and tables
    (N, D, S) f32 with D, S >= 1, both contiguous on one card."""
    shape, tshape = inst.shape, tables.shape
    if (len(shape) == 2 and len(tshape) == 3 and tshape[0] == shape[0]
            and tshape[1] > 0 and tshape[2] > 0
            and inst.dtype is torch.int32 and tables.dtype is torch.float32
            and inst.is_contiguous() and tables.is_contiguous()
            and tables.get_device() == inst.get_device()):
        return shape[0], shape[1], tshape[1], tshape[2]
    _native.require_cuda_tensor(inst, "inst", (torch.int32,), 2)
    _native.require_cuda_tensor(tables, "tables", (torch.float32,), 3)
    raise ValueError(f"segment_lookup: tables must be (N, D, S) with D, S >= 1"
                     f" on the keys' card; keys {tuple(shape)} on "
                     f"{inst.device}, tables {tuple(tshape)} on "
                     f"{tables.device}")


def _segment_lookup_cuda(inst: torch.Tensor,
                         tables: torch.Tensor) -> torch.Tensor:
    """The kernel launch (the op's CUDA implementation). Its host work
    is: one check that also reads the shapes (`_lookup_shape`: a chain
    of attribute reads), one `new_empty`, three `data_ptr` reads, the raw
    stream, one call of the C function bound on the first launch, the
    counter and the error check."""
    n, p, d, s = _lookup_shape(inst, tables)
    out = inst.new_empty((n, d, p), dtype=torch.float32)
    err = (_LOOKUP_LAUNCH or _lookup_launch())(
        n, p, d, s, inst.data_ptr(), tables.data_ptr(), out.data_ptr(),
        _native.stream_ptr(inst))
    _SEGMENT_LOOKUP.launches += 1
    _native.check(err, "segment_lookup")
    return out


_LOOKUP_OP = _native.kernel_op(
    "segment_lookup", "(Tensor inst, Tensor tables) -> Tensor",
    _segment_lookup_cuda, segment_lookup_plain,
    lambda inst, tables: tables.new_empty(
        (inst.shape[0], tables.shape[1], inst.shape[1])))


def segment_lookup(inst: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Per-pixel lookups: (N, P) keys + (N, D, S) tables -> (N, D, P) (the
    op `emsanet::segment_lookup`)."""
    return _LOOKUP_OP(inst, tables)


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_SEGMENT_LOOKUP = segment_lookup
_SEGMENT_LOOKUP.launches = 0
