"""Polyphase form of the learned-3x3-zeropad x2 upsampling (counterpart:
`emsanet_tpu/ops/polyphase_upsample.py`; see its docstring for the
identity).

Nearest x2 followed by a zero-padded depthwise 3x3 equals, exactly, four
parity filters at input resolution plus one depth-to-space. The four
parities run as ONE grouped conv with 4C outputs in the channel layout
c*4 + (p*2+q), which is also `F.pixel_shuffle`'s layout. These are plain
PyTorch convs: the JAX package computes them outside any Pallas kernel.
Tensors are NCHW here (the model's internal layout).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# _PARITY_MAP[p, di, a] = 1 iff upsampled tap a of output parity p reads
# input offset di-1.
_PARITY_MAP = np.zeros((2, 3, 3), dtype=np.float32)
_PARITY_MAP[0, 0, 0] = 1.0
_PARITY_MAP[0, 1, 1] = 1.0
_PARITY_MAP[0, 1, 2] = 1.0
_PARITY_MAP[1, 1, 0] = 1.0
_PARITY_MAP[1, 1, 1] = 1.0
_PARITY_MAP[1, 2, 2] = 1.0
# _SOURCES[(p*2+q)*9 + i*3 + j] = the taps a*3+b of the upsampled 3x3
# kernel that tap (i, j) of output parity (p, q) sums, padded with 9 (a
# zero) to four
_SOURCES = np.array([
    ([a * 3 + b for a in range(3) for b in range(3)
      if _PARITY_MAP[p, i, a] * _PARITY_MAP[q, j, b]] + [9] * 4)[:4]
    for p in range(2) for q in range(2) for i in range(3) for j in range(3)
])
# flat (parity, 3, 3) position of the four non-zero taps of each parity:
# tap a*2+b of parity p = pr*2+pc sits at row pr+a, column pc+b
_TAP_INDEX = np.array([p * 9 + (p // 2 + a) * 3 + p % 2 + b
                       for p in range(4) for a in (0, 1) for b in (0, 1)])


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(_SOURCES, _TAP_INDEX) on `device`, copied there once: a copy from
    pageable host memory makes the host wait for the device's queue, on
    every call."""
    return (torch.from_numpy(_SOURCES).to(device),
            torch.from_numpy(_TAP_INDEX).to(device))


def polyphase_kernels(weight: torch.Tensor) -> torch.Tensor:
    """(C, 1, 3, 3) depthwise weight -> (4C, 1, 3, 3) grouped parity weight
    with output channel c*4 + (p*2+q). Each parity tap is the sum of up to
    four taps of the weight, added in a fixed order (no einsum: planning
    its contraction costs ~0.3 ms of host time per call, and a matmul may
    round its operands to TF32)."""
    c = weight.shape[0]
    k = F.pad(weight.reshape(c, 9).float(), (0, 1))  # column 9 is 0
    g = k[:, _constants(weight.device)[0]]  # (C, 36, 4)
    kp = g[..., 0] + g[..., 1] + g[..., 2] + g[..., 3]
    return kp.reshape(c * 4, 1, 3, 3)


def parity_taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The four non-zero taps of each parity, for the kernels that fuse
    the final x2 stage (`csrc/common.cuh`): (4 parities, 4 taps, C) f32,
    tap a*2+b at row offset pr-1+a and column offset pc-1+b of parity
    p = pr*2+pc. Rounded to `dtype` and back, as the unfused conv casts
    its weight (the JAX kernels do the same, `semantic_decode.py:285-293`).
    """
    c = weight.shape[0]
    kp = polyphase_kernels(weight).reshape(c, 36).to(dtype).float()
    taps = kp[:, _constants(weight.device)[1]]  # (C, 16)
    return taps.t().contiguous().reshape(4, 4, c)


def upsample2x_depthwise_polyphase_deferred(
    x: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H, W) parity-domain output (no interleave)."""
    kp = polyphase_kernels(weight).to(x.dtype)
    return F.conv2d(x, kp, padding=1, groups=x.shape[1])


def upsample2x_depthwise_polyphase(x: torch.Tensor,
                                   weight: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), exact nearest-x2 + depthwise 3x3."""
    return F.pixel_shuffle(
        upsample2x_depthwise_polyphase_deferred(x, weight), 2
    )
