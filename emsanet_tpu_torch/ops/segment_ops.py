"""Small-table lookup of the postprocessing (counterpart:
`emsanet_tpu/ops/segment_ops.py::small_table_lookup`).

The JAX package replaced gathers by compares because TPU gathers are
slow; on the card a gather is the plain form. The scatter/gather
references of that module (`segment_histogram_factored`,
`segment_gather`, `segment_sum_vectors`) are the plain versions in
`segment_kernels.py` here.
"""

from __future__ import annotations

import torch


def small_table_lookup(indices: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """table[indices], with 0 (False) for indices outside the table."""
    ok = (indices >= 0) & (indices < table.shape[0])
    out = table[torch.where(ok, indices, 0).long()]
    return torch.where(ok, out, torch.zeros((), dtype=table.dtype,
                                            device=table.device))
