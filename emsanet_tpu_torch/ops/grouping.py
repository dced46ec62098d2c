"""Pixel -> instance-center grouping (argmin over K centers).

Counterpart of `emsanet_tpu/ops/grouping.py::group_pixels_argmin`.
`group_pixels_argmin` is the custom op `emsanet::group_pixels_argmin`
(`_native.kernel_op`). On CUDA tensors it launches the hand-written kernel
`csrc/grouping.cu` (the valid centers staged once per block, 4 pixels
a thread); on CPU tensors it runs
`group_pixels_argmin_plain`, the JAX package's reference formula
(`group_pixels_argmin_reference`). Index and distance are bit-exact
between the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from emsanet_tpu_torch.ops import _native

INVALID_DIST = 1e12


def group_pixels_argmin_plain(
    voted: torch.Tensor, centers: torch.Tensor, centers_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (materializes the (N, P, K) distances)."""
    d = voted[:, :, None, :] - centers[:, None, :, :]
    dist = (d * d).sum(-1)
    dist = torch.where(centers_valid[:, None, :], dist,
                       torch.tensor(INVALID_DIST, dtype=dist.dtype,
                                    device=dist.device))
    # argmin returns the first of tied minima, as jnp.argmin does
    return torch.argmin(dist, dim=-1).to(torch.int32), dist.amin(dim=-1)


def _group_pixels_argmin_cuda(
    voted: torch.Tensor, centers: torch.Tensor, centers_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launch (the op's CUDA implementation)."""
    _native.require_cuda_tensor(voted, "voted", (torch.float32,), 3)
    _native.require_cuda_tensor(centers, "centers", (torch.float32,), 3)
    _native.require_cuda_tensor(centers_valid, "centers_valid",
                                (torch.bool,), 2)
    n, p, two = voted.shape
    k = centers.shape[1]
    if two != 2 or tuple(centers.shape) != (n, k, 2) or tuple(
        centers_valid.shape
    ) != (n, k) or not 1 <= k <= 1024:
        raise ValueError("group_pixels_argmin: voted (N, P, 2), centers "
                         "(N, K, 2), valid (N, K) with 1 <= K <= 1024")
    idx = torch.empty((n, p), device=voted.device, dtype=torch.int32)
    dist = torch.empty((n, p), device=voted.device, dtype=torch.float32)
    fn = _native.bind("grouping", "group_pixels_argmin_launch", 9,
                      int_args=[0, 1, 2])
    err = fn(n, p, k, voted.data_ptr(), centers.data_ptr(),
             centers_valid.data_ptr(), idx.data_ptr(), dist.data_ptr(),
             _native.stream_ptr(voted))
    _GROUP_PIXELS_ARGMIN.launches += 1
    _native.check(err, "group_pixels_argmin")
    return idx, dist


def _group_pixels_argmin_fake(voted, centers, centers_valid):
    n, p, _ = voted.shape
    return (voted.new_empty((n, p), dtype=torch.int32),
            voted.new_empty((n, p), dtype=torch.float32))


_OP = _native.kernel_op(
    "group_pixels_argmin",
    "(Tensor voted, Tensor centers, Tensor centers_valid) -> (Tensor, Tensor)",
    _group_pixels_argmin_cuda, group_pixels_argmin_plain,
    _group_pixels_argmin_fake)


def group_pixels_argmin(
    voted: torch.Tensor, centers: torch.Tensor, centers_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_idx (N, P) int32, best_dist_sq (N, P) f32) (the op
    `emsanet::group_pixels_argmin`).

    voted: (N, P, 2) f32; centers: (N, K, 2) f32; centers_valid: (N, K)
    bool.
    """
    return _OP(voted, centers, centers_valid)


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_GROUP_PIXELS_ARGMIN = group_pixels_argmin
_GROUP_PIXELS_ARGMIN.launches = 0
