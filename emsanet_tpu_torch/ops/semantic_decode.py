"""Final semantic x2 upsample fused with the class decode.

Counterpart of `emsanet_tpu/ops/semantic_decode.py::
semantic_decode_fused_planes` (pl.pallas_call at :311) and
`semantic_decode_fused_interleaved` (:398). The input is the semantic
head's deferred `decode_input`: x (N, H/2, W/2, C) NHWC and the final
stage's depthwise weight (C, 1, 3, 3). The output is the 0-based class
index (int32) and the max-softmax score (f32) of every full-res pixel,
as parity planes (N, 4, H/2, W/2), parity p*2+q, or interleaved
(N, H, W).

`semantic_decode` is the custom op `emsanet::semantic_decode`
(`_native.kernel_op`). On CUDA tensors it launches the hand-written
kernel `csrc/semantic_decode.cu`; on CPU tensors it runs the plain
version: the
polyphase conv (`upsample2x_depthwise_polyphase_deferred`), then the
kernel's arithmetic in PyTorch ops (values in the compute dtype, the
difference to the max in f32, first maximum wins, score = 1 / sumexp).
"""

from __future__ import annotations

from typing import Tuple

import torch

from emsanet_tpu_torch.ops import _native
from emsanet_tpu_torch.ops.plane_interleave import interleave_plane
from emsanet_tpu_torch.ops.polyphase_upsample import (
    cached_parity_taps,
    upsample2x_depthwise_polyphase_deferred,
)

MAX_CLASSES = 512  # csrc/semantic_decode.cu kMaxDecodeClasses


def parity_logits(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(N, H/2, W/2, C) -> (N, C, 4, H/2, W/2) f32: the final stage's
    output in the compute dtype, as f32."""
    y = upsample2x_depthwise_polyphase_deferred(x.permute(0, 3, 1, 2),
                                                weight)
    n, _, h2, w2 = y.shape
    return y.reshape(n, -1, 4, h2, w2).float()


def semantic_decode_planes_plain(
    x: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    v = parity_logits(x, weight)
    idx = torch.argmax(v, dim=1).to(torch.int32)  # first maximum wins
    mx = v.amax(dim=1, keepdim=True)
    return idx, 1.0 / torch.exp(v - mx).sum(dim=1)


def semantic_decode_interleaved_plain(
    x: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    idx, score = semantic_decode_planes_plain(x, weight)
    return interleave_plane(idx), interleave_plane(score)


def bf16_near_ties(x: torch.Tensor, weight: torch.Tensor,
                   interleaved: bool = False) -> torch.Tensor:
    """Pixels where the plain version's top two class values are within
    one bf16 ulp (of the top value) of each other, as planes or
    interleaved. In bf16 the kernel's and the plain conv's f32 tap sums
    round to values at most one ulp apart, so only these pixels may
    decode to another class; the tolerance checks use this mask."""
    top2 = parity_logits(x, weight).topk(2, dim=1).values
    _, exponent = torch.frexp(top2[:, 0])
    ulp = torch.ldexp(torch.ones_like(top2[:, 0]), exponent - 8)
    near = (top2[:, 0] - top2[:, 1]) <= ulp
    return interleave_plane(near) if interleaved else near


def _semantic_decode_cuda(x: torch.Tensor, weight: torch.Tensor,
                          interleaved: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launch (the op's CUDA implementation)."""
    _native.require_cuda_tensor(x, "x", (torch.float32, torch.bfloat16), 4)
    n, h2, w2, c = x.shape
    if tuple(weight.shape) != (c, 1, 3, 3) or not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"semantic_decode: x (N, H/2, W/2, C) with C <= "
                         f"{MAX_CLASSES} and weight (C, 1, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    taps = cached_parity_taps(weight, x.dtype, x.device)
    shape = _out_shape(x, interleaved)
    idx = torch.empty(shape, device=x.device, dtype=torch.int32)
    score = torch.empty(shape, device=x.device, dtype=torch.float32)
    fn = _native.bind("semantic_decode", "semantic_decode_launch", 11,
                      int_args=[0, 1, 2, 3, 4, 5])
    err = fn(int(x.dtype == torch.bfloat16), n, h2, w2, c, int(interleaved),
             x.data_ptr(), taps.data_ptr(), idx.data_ptr(), score.data_ptr(),
             _native.stream_ptr(x))
    _SEMANTIC_DECODE.launches += 1
    _native.check(err, "semantic_decode")
    return idx, score


def _out_shape(x: torch.Tensor, interleaved: bool) -> Tuple[int, ...]:
    n, h2, w2, _ = x.shape
    return (n, 2 * h2, 2 * w2) if interleaved else (n, 4, h2, w2)


def _semantic_decode_plain(x, weight, interleaved):
    if interleaved:
        return semantic_decode_interleaved_plain(x, weight)
    return semantic_decode_planes_plain(x, weight)


def _semantic_decode_fake(x, weight, interleaved):
    shape = _out_shape(x, interleaved)
    return (x.new_empty(shape, dtype=torch.int32),
            x.new_empty(shape, dtype=torch.float32))


_OP = _native.kernel_op(
    "semantic_decode",
    "(Tensor x, Tensor weight, bool interleaved) -> (Tensor, Tensor)",
    _semantic_decode_cuda, _semantic_decode_plain, _semantic_decode_fake)


def semantic_decode(
    x: torch.Tensor, weight: torch.Tensor, interleaved: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32, score f32), as planes (N, 4, H/2, W/2) or, with
    `interleaved`, as (N, H, W) (the op `emsanet::semantic_decode`)."""
    return _OP(x, weight, interleaved)


def semantic_decode_planes(
    x: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return semantic_decode(x, weight, interleaved=False)


def semantic_decode_interleaved(
    x: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return semantic_decode(x, weight, interleaved=True)


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_SEMANTIC_DECODE = semantic_decode
_SEMANTIC_DECODE.launches = 0
