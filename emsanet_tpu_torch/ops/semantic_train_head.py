"""Train-mode semantic head loss: final x2 upsample + weighted CE, fused.

Counterpart of `emsanet_tpu/ops/semantic_train_head.py::
fused_semantic_head_loss`. In training with `fused_train_head`, the
semantic head defers its final 'learned-3x3-zeropad' x2 stage, and the
loss is computed from the half-res head output x (N, H/2, W/2, C) NHWC
and the stage's depthwise weight (C, 1, 3, 3), against the full-res
target (N, H, W) (0 = void): nearest x2, the zero-padded depthwise conv,
the weighted, label-smoothed cross entropy with the weighted-pixel-sum
reduction. The full-res logits never exist.

On CUDA tensors `fused_semantic_head_loss` is a `torch.autograd.Function`
over two hand-written kernels, `csrc/semantic_train_head.cu`
(`head_loss_fwd`: the sums of w * nll and of w; `head_loss_bwd`: dx and
the 16 polyphase taps' weight gradients, mapped back to the 3x3 kernel
here). On CPU tensors it runs the plain version,
`semantic_head_loss_reference`, differentiated by autograd.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from emsanet_tpu_torch.losses import cross_entropy_semantic_sums
from emsanet_tpu_torch.ops import _native
from emsanet_tpu_torch.ops.polyphase_upsample import (
    _PARITY_MAP,
    _TAP_INDEX,
    parity_taps,
)

MAX_CLASSES = 64  # csrc/semantic_train_head.cu kMaxLossClasses


def head_logits(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Full-res logits (N, H, W, C) in x's dtype: nearest x2, then the
    depthwise conv with the weight cast to that dtype."""
    up = x.permute(0, 3, 1, 2).repeat_interleave(2, 2).repeat_interleave(2, 3)
    y = F.conv2d(up, weight.to(x.dtype), padding=1, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def head_loss_fwd_plain(x, weight, target, class_weights=None,
                        label_smoothing: float = 0.0):
    """(sum of w * nll, sum of w), the plain version of `head_loss_fwd`."""
    return cross_entropy_semantic_sums(head_logits(x, weight), target,
                                       class_weights, label_smoothing)


def semantic_head_loss_reference(x, weight, target, class_weights=None,
                                 label_smoothing: float = 0.0):
    """The unfused train path's loss, differentiable by autograd."""
    s, w = head_loss_fwd_plain(x, weight, target, class_weights,
                               label_smoothing)
    return s / torch.clamp_min(w, 1e-12)


def head_loss_bwd_plain(x, weight, target, class_weights, label_smoothing,
                        gscale):
    """(dx, dweight): autograd of the plain sum of w * nll, times gscale."""
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        wl = weight.detach().float().requires_grad_(True)
        s, _ = head_loss_fwd_plain(xl, wl, target, class_weights,
                                   label_smoothing)
        dx, dw = torch.autograd.grad(s, (xl, wl), gscale.reshape(()).float())
    return dx, dw


# ---------------------------------------------------------------------------
# kernels


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """The parity map and the taps' flat positions on `device`, copied
    there once (a copy from pageable memory waits for the device)."""
    return (torch.from_numpy(_PARITY_MAP).to(device),
            torch.from_numpy(_TAP_INDEX).to(device))


def taps_grad_to_weight(dkp: torch.Tensor) -> torch.Tensor:
    """(4, 4, C) gradients of the polyphase taps -> (C, 1, 3, 3) gradient
    of the depthwise weight: kp[p, q, i, j] = sum_ab m[p, i, a] m[q, j, b]
    k[a, b] (`polyphase_kernels`), so dk[a, b] = sum m m dkp."""
    c = dkp.shape[-1]
    pmap, tap_index = _constants(dkp.device)
    d9 = torch.zeros((36, c), device=dkp.device, dtype=torch.float32)
    d9[tap_index] = dkp.reshape(16, c).float()
    d9 = d9.reshape(2, 2, 3, 3, c)
    dk = torch.einsum("pqijc,pia,qjb->abc", d9, pmap, pmap)
    return dk.permute(2, 0, 1)[:, None].contiguous()


def _prepare(x, weight, target, class_weights):
    _native.require_cuda_tensor(x, "x", (torch.float32, torch.bfloat16), 4)
    n, h2, w2, c = x.shape
    if tuple(weight.shape) != (c, 1, 3, 3) or not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"semantic head loss: x (N, H/2, W/2, C) with C <= "
                         f"{MAX_CLASSES} and weight (C, 1, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if tuple(target.shape) != (n, 2 * h2, 2 * w2) or not target.is_cuda:
        raise ValueError(f"target must be a CUDA tensor (N, H, W) = "
                         f"{(n, 2 * h2, 2 * w2)}, got {tuple(target.shape)}")
    target = target.to(torch.int32).contiguous()
    cw = (torch.ones(c, device=x.device) if class_weights is None
          else class_weights.detach().float().contiguous())
    if tuple(cw.shape) != (c,) or not cw.is_cuda:
        raise ValueError(f"class weights must be a CUDA tensor ({c},)")
    taps = parity_taps(weight.detach(), x.dtype)
    fn_ws = _native.bind("semantic_train_head",
                         "semantic_train_head_workspace", 4,
                         int_args=[0, 1, 2, 3])
    work = torch.empty(fn_ws(n, h2, w2, c), device=x.device,
                       dtype=torch.float32)
    return (n, h2, w2, c), target, cw, taps, work


def head_loss_fwd(x, weight, target, class_weights=None,
                  label_smoothing: float = 0.0):
    """The forward kernel: (sum of w * nll, sum of w), f32 scalars."""
    (n, h2, w2, c), target, cw, taps, work = _prepare(x, weight, target,
                                                      class_weights)
    sums = torch.empty(2, device=x.device, dtype=torch.float32)
    fn = _native.bind("semantic_train_head", "semantic_train_head_fwd_launch",
                      13, int_args=[0, 1, 2, 3, 4], float_args=[5])
    err = fn(int(x.dtype == torch.bfloat16), n, h2, w2, c,
             float(label_smoothing), x.data_ptr(), taps.data_ptr(),
             target.data_ptr(), cw.data_ptr(), sums.data_ptr(),
             work.data_ptr(), _native.stream_ptr(x))
    _HEAD_LOSS_FWD.launches += 1
    _native.check(err, "semantic_train_head_fwd")
    return sums[0], sums[1]


def head_loss_bwd(x, weight, target, class_weights, label_smoothing,
                  gscale):
    """The backward kernel: (dx in x's dtype, dweight (C, 1, 3, 3) f32)
    of the sum of w * nll, times gscale (a one-element f32 tensor on the
    device: the loss's cotangent over the sum of w)."""
    (n, h2, w2, c), target, cw, taps, work = _prepare(x, weight, target,
                                                      class_weights)
    gscale = gscale.detach().float().reshape(1).contiguous()
    x = x.contiguous()
    dx = torch.empty_like(x)
    dkp = torch.empty((4, 4, c), device=x.device, dtype=torch.float32)
    fn = _native.bind("semantic_train_head", "semantic_train_head_bwd_launch",
                      15, int_args=[0, 1, 2, 3, 4], float_args=[5])
    err = fn(int(x.dtype == torch.bfloat16), n, h2, w2, c,
             float(label_smoothing), x.data_ptr(), taps.data_ptr(),
             target.data_ptr(), cw.data_ptr(), gscale.data_ptr(),
             dx.data_ptr(), dkp.data_ptr(), work.data_ptr(),
             _native.stream_ptr(x))
    _HEAD_LOSS_BWD.launches += 1
    _native.check(err, "semantic_train_head_bwd")
    return dx, taps_grad_to_weight(dkp)


class _HeadLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, target, class_weights, label_smoothing):
        s, w = head_loss_fwd(x, weight, target, class_weights,
                             label_smoothing)
        w = torch.clamp_min(w, 1e-12)
        ctx.label_smoothing = label_smoothing
        ctx.save_for_backward(x, weight, target, class_weights, w)
        return s / w

    @staticmethod
    def backward(ctx, g):
        x, weight, target, class_weights, w = ctx.saved_tensors
        dx, dw = head_loss_bwd(x, weight, target, class_weights,
                               ctx.label_smoothing, g.float() / w)
        return dx, dw.to(weight.dtype), None, None, None


def fused_semantic_head_loss(
    x: torch.Tensor, weight: torch.Tensor, target: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """The semantic head's final x2 stage + weighted CE, as a scalar."""
    if not x.is_cuda:
        return semantic_head_loss_reference(x, weight, target, class_weights,
                                            label_smoothing)
    return _HeadLoss.apply(x.contiguous(), weight, target, class_weights,
                           float(label_smoothing))


# the launch counts live on the function objects; the bodies reach them
# through these aliases, which wrapping the module attributes leaves alone
_HEAD_LOSS_FWD = head_loss_fwd
_HEAD_LOSS_FWD.launches = 0
_HEAD_LOSS_BWD = head_loss_bwd
_HEAD_LOSS_BWD.launches = 0

