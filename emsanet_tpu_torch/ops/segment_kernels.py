"""Segment reductions of the panoptic merge.

Counterpart of `emsanet_tpu/ops/segment_pallas.py`. On CUDA tensors
`segment_hist_and_sums` and `segment_lookup` launch the hand-written
kernels of `csrc/segment.cu`; on CPU tensors they run their plain
versions (scatter_add / gather with the one-hot semantics of
`emsanet_tpu/ops/segment_ops.py`: keys outside [0, S) contribute
nothing and look up 0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from emsanet_tpu_torch.ops import _native


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


def segment_hist_and_sums(
    inst: torch.Tensor, sem: torch.Tensor, weights: torch.Tensor,
    vectors: torch.Tensor, num_segments: int, num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hist (N, S, C), vec_sums (N, S, D)) over pixels.

    inst/sem: (N, P) int32; weights: (N, P) f32; vectors: (N, P, D) f32.
    """
    if not inst.is_cuda:
        return segment_hist_and_sums_plain(inst, sem, weights, vectors,
                                           num_segments, num_classes)
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
    hist = torch.empty((n, num_segments, num_classes), dtype=torch.float32,
                       device=inst.device)
    sums = torch.empty((n, num_segments, d), dtype=torch.float32,
                       device=inst.device)
    fn = _native.bind("segment", "segment_hist_and_sums_launch", 12,
                      int_args=[0, 1, 2, 3, 4])
    err = fn(n, p, num_segments, num_classes, d, inst.data_ptr(),
             sem.data_ptr(), weights.data_ptr(), vectors.data_ptr(),
             hist.data_ptr(), sums.data_ptr(), _native.stream_ptr(inst))
    _SEGMENT_HIST_AND_SUMS.launches += 1
    _native.check(err, "segment_hist_and_sums")
    return hist, sums


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


def segment_lookup(inst: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Per-pixel lookups: (N, P) keys + (N, D, S) tables -> (N, D, P)."""
    if not inst.is_cuda:
        return segment_lookup_plain(inst, tables)
    _native.require_cuda_tensor(inst, "inst", (torch.int32,), 2)
    _native.require_cuda_tensor(tables, "tables", (torch.float32,), 3)
    n, p = inst.shape
    d, s = tables.shape[1], tables.shape[2]
    if tables.shape[0] != n:
        raise ValueError("segment_lookup: tables must be (N, D, S)")
    out = torch.empty((n, d, p), dtype=torch.float32, device=inst.device)
    fn = _native.bind("segment", "segment_lookup_launch", 8,
                      int_args=[0, 1, 2, 3])
    err = fn(n, p, d, s, inst.data_ptr(), tables.data_ptr(), out.data_ptr(),
             _native.stream_ptr(inst))
    _SEGMENT_LOOKUP.launches += 1
    _native.check(err, "segment_lookup")
    return out


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_SEGMENT_LOOKUP = segment_lookup
_SEGMENT_LOOKUP.launches = 0
