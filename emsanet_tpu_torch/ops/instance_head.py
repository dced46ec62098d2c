"""Final instance-head x2 upsample fused with the output encodes.

Counterpart of `emsanet_tpu/ops/instance_head.py::instance_head_upsample`
(pl.pallas_call at :289) and `instance_head_upsample_interleaved`
(:375). The input is the instance head's deferred `decode_input`: x
(N, H/2, W/2, C) NHWC, C = 5 (center, offset y, offset x, orientation
sin, cos) or 3 without orientation, and the final stage's depthwise
weight (C, 1, 3, 3). Each channel is encoded by its ENC_* code (sigmoid
center, tanh offsets, identity orientation). The output is f32 and
channel-major: parity planes (N, C, 4, H/2, W/2), parity p*2+q, or
interleaved maps (N, C, H, W).

On CUDA tensors `instance_head_upsample` launches the hand-written
kernel `csrc/instance_head.cu`; on CPU tensors it runs the plain
version: the polyphase conv in the compute dtype, then the encodes in
f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from emsanet_tpu_torch.ops import _native
from emsanet_tpu_torch.ops.plane_interleave import interleave_plane
from emsanet_tpu_torch.ops.polyphase_upsample import (
    parity_taps,
    upsample2x_depthwise_polyphase_deferred,
)

ENC_IDENTITY, ENC_SIGMOID, ENC_TANH = 0, 1, 2
MAX_CHANNELS = 8  # csrc/instance_head.cu kMaxHeadChannels


def encodings_for(
    n_channels: int, sigmoid_for_center: bool, tanh_for_offset: bool
) -> Tuple[int, ...]:
    """Per-channel encode codes for the instance head channel layout
    (center, offset_y, offset_x[, orientation_sin, orientation_cos])."""
    enc = [ENC_SIGMOID if sigmoid_for_center else ENC_IDENTITY]
    enc += [ENC_TANH if tanh_for_offset else ENC_IDENTITY] * 2
    enc += [ENC_IDENTITY] * (n_channels - 3)
    return tuple(enc[:n_channels])


def instance_head_upsample_plain(
    x: torch.Tensor, weight: torch.Tensor, encodings: Sequence[int]
) -> torch.Tensor:
    """(N, H/2, W/2, C) -> (N, C, 4, H/2, W/2) f32 encoded planes."""
    y = upsample2x_depthwise_polyphase_deferred(x.permute(0, 3, 1, 2),
                                                weight)
    n, _, h2, w2 = y.shape
    v = y.reshape(n, -1, 4, h2, w2).float()
    parts = []
    for ch, code in enumerate(encodings):
        m = v[:, ch]
        if code == ENC_SIGMOID:
            m = torch.sigmoid(m)
        elif code == ENC_TANH:
            m = torch.tanh(m)
        parts.append(m)
    return torch.stack(parts, dim=1)


def instance_head_upsample_interleaved_plain(
    x: torch.Tensor, weight: torch.Tensor, encodings: Sequence[int]
) -> torch.Tensor:
    planes = instance_head_upsample_plain(x, weight, encodings)
    n, c, _, h2, w2 = planes.shape
    return interleave_plane(planes.reshape(n * c, 4, h2, w2)).reshape(
        n, c, 2 * h2, 2 * w2)


def instance_head(
    x: torch.Tensor, weight: torch.Tensor, encodings: Sequence[int],
    interleaved: bool = False,
) -> torch.Tensor:
    """Encoded maps, as planes (N, C, 4, H/2, W/2) or, with
    `interleaved`, as (N, C, H, W)."""
    if not x.is_cuda:
        if interleaved:
            return instance_head_upsample_interleaved_plain(x, weight,
                                                            encodings)
        return instance_head_upsample_plain(x, weight, encodings)
    _native.require_cuda_tensor(x, "x", (torch.float32, torch.bfloat16), 4)
    n, h2, w2, c = x.shape
    if (tuple(weight.shape) != (c, 1, 3, 3) or len(encodings) != c
            or not 1 <= c <= MAX_CHANNELS):
        raise ValueError(f"instance_head: x (N, H/2, W/2, C) with C <= "
                         f"{MAX_CHANNELS}, weight (C, 1, 3, 3) and C codes, "
                         f"got {tuple(x.shape)}, {tuple(weight.shape)} and "
                         f"{tuple(encodings)}")
    enc = 0
    for ch, code in enumerate(encodings):
        if code not in (ENC_IDENTITY, ENC_SIGMOID, ENC_TANH):
            raise ValueError(f"unknown encoding code {code}")
        enc |= code << (4 * ch)
    taps = parity_taps(weight.detach().to(x.device), x.dtype)
    shape = (n, c, 2 * h2, 2 * w2) if interleaved else (n, c, 4, h2, w2)
    out = torch.empty(shape, device=x.device, dtype=torch.float32)
    fn = _native.bind("instance_head", "instance_head_launch", 11,
                      int_args=[0, 1, 2, 3, 4, 5, 6])
    err = fn(int(x.dtype == torch.bfloat16), n, h2, w2, c, enc,
             int(interleaved), x.data_ptr(), taps.data_ptr(), out.data_ptr(),
             _native.stream_ptr(x))
    _INSTANCE_HEAD.launches += 1
    _native.check(err, "instance_head")
    return out


def instance_head_upsample(
    x: torch.Tensor, weight: torch.Tensor, encodings: Sequence[int]
) -> torch.Tensor:
    return instance_head(x, weight, encodings, interleaved=False)


def instance_head_upsample_interleaved(
    x: torch.Tensor, weight: torch.Tensor, encodings: Sequence[int]
) -> torch.Tensor:
    return instance_head(x, weight, encodings, interleaved=True)


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_INSTANCE_HEAD = instance_head
_INSTANCE_HEAD.launches = 0
