"""Fused stems of both encoders: 7x7/2 conv + BN + ReLU + 3x3/2 max pool.

Counterpart of `emsanet_tpu/ops/stem.py::fused_stems`. On a CUDA tensor
`fused_stems` launches the hand-written kernel `csrc/stem.cu` (one
launch for all modalities; the conv output stays in shared memory); on
a CPU tensor it runs `fused_stems_plain`, the same function in plain
PyTorch. Tensors are NHWC at this boundary, like the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from emsanet_tpu_torch.ops import _native

BN_EPS = 1e-5
BNParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fold_bn(weight, bias, mean, var, eps: float = BN_EPS):
    """Inference BatchNorm as y = x * s + t, in float32."""
    s = weight.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def fused_stems_plain(
    xs: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    bn_params: Sequence[BNParams],
) -> List[torch.Tensor]:
    """Plain PyTorch stems: conv2d + batch_norm + relu + max_pool2d."""
    outs = []
    for x, w, (g, b, mu, var) in zip(xs, weights, bn_params):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=2,
                     padding=3)
        y = F.batch_norm(y, mu.to(y.dtype), var.to(y.dtype), g.to(y.dtype),
                         b.to(y.dtype), training=False, eps=BN_EPS)
        y = F.max_pool2d(F.relu(y), 3, stride=2, padding=1)
        outs.append(y.permute(0, 2, 3, 1).contiguous())
    return outs


def fused_stems(
    xs: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    bn_params: Sequence[BNParams],
) -> List[torch.Tensor]:
    """Both stems in one launch.

    xs: per-modality inputs (N, H, W, C_m), same N/H/W and dtype;
    weights: per-modality conv weights (64, C_m, 7, 7) (no bias);
    bn_params: per-modality BatchNorm (weight, bias, running_mean,
    running_var). Returns per-modality (N, H/4, W/4, 64).
    """
    if not xs[0].is_cuda:
        return fused_stems_plain(xs, weights, bn_params)
    if not 1 <= len(xs) <= 2:
        raise ValueError("fused_stems takes one or two modalities")
    n, h, w, _ = xs[0].shape
    dtype = xs[0].dtype
    for i, x in enumerate(xs):
        _native.require_cuda_tensor(x, f"xs[{i}]",
                                    (torch.float32, torch.bfloat16), 4)
        if x.shape[:3] != xs[0].shape[:3] or x.dtype != dtype:
            raise ValueError("stem inputs must share N, H, W and dtype")
        if not 1 <= x.shape[3] <= 4:
            raise ValueError("stem inputs must have 1..4 channels")
        if tuple(weights[i].shape) != (64, x.shape[3], 7, 7):
            raise ValueError(f"weights[{i}] must be (64, {x.shape[3]}, 7, 7)")
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    hq, wq = (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
    args = []
    keep = []
    outs = []
    for x, wt, bn in zip(xs, weights, bn_params):
        w_k = wt.detach().float().permute(1, 2, 3, 0).contiguous()
        s, t = fold_bn(*(p.detach() for p in bn))
        out = torch.empty((n, hq, wq, 64), device=x.device, dtype=dtype)
        keep += [w_k, s, t]
        outs.append(out)
        args.append((x.data_ptr(), x.shape[3], w_k.data_ptr(), s.data_ptr(),
                     t.data_ptr(), out.data_ptr()))
    if len(args) == 1:
        args.append((0, 0, 0, 0, 0, 0))
    fn = _native.bind("stem", "fused_stems_launch", 18,
                      int_args=[0, 1, 2, 3, 4, 6, 12])
    err = fn(int(dtype == torch.bfloat16), n, h, w, len(xs),
             *args[0], *args[1], _native.stream_ptr(xs[0]))
    _FUSED_STEMS.launches += 1
    _native.check(err, "fused_stems")
    return outs


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_FUSED_STEMS = fused_stems
_FUSED_STEMS.launches = 0
