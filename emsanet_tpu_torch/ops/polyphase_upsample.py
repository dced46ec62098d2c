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


def polyphase_kernels(weight: torch.Tensor) -> torch.Tensor:
    """(C, 1, 3, 3) depthwise weight -> (4C, 1, 3, 3) grouped parity weight
    with output channel c*4 + (p*2+q)."""
    c = weight.shape[0]
    m = torch.from_numpy(_PARITY_MAP).to(weight.device, torch.float32)
    k = weight[:, 0].float()
    kp = torch.einsum("pia,qjb,cab->cpqij", m, m, k)
    return kp.reshape(c * 4, 1, 3, 3)


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
