"""Fused stems of both encoders: 7x7/2 conv + BN + ReLU + 3x3/2 max pool.

Counterpart of `emsanet_tpu/ops/stem.py::fused_stems`. `fused_stems` is
the custom op `emsanet::fused_stems` (`_native.kernel_op`). On a CUDA
tensor it launches the hand-written kernel `csrc/stem.cu` (one
launch for all modalities; the conv output stays in shared memory; in
bf16 the conv runs on the tensor cores as a stride-1 4x4 conv over 2x2
space-to-depth packed pixels); on a CPU tensor it runs
`fused_stems_plain`, the same function in plain PyTorch. Tensors are
NHWC at this boundary, like the JAX package.

The packed layout, as the JAX package's `pack_stem_inputs` / `_pack_k4`
without their padding to 16 slots: packed pixel (py, px) holds
x[2py + a, 2px + b, c] at slot (a*2 + b)*C + c, 4C slots;
`pack_stem_input` and `packed_stem_weights` give it in plain PyTorch, and
a 4x4 conv of the one with the other (padding 2 before, 1 after) is the
7x7/2 conv.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from emsanet_tpu_torch.ops import _native, param_cache

BN_EPS = 1e-5
BNParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fold_bn(weight, bias, mean, var, eps: float = BN_EPS):
    """Inference BatchNorm as y = x * s + t, in float32."""
    s = weight.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def pack_stem_input(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 4C): 2x2 space-to-depth,
    slot (a*2 + b)*C + c, a zero row / column appended to an odd H / W."""
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    xp = x.reshape(n, (h + 1) // 2, 2, (w + 1) // 2, 2, c)
    return xp.permute(0, 1, 3, 2, 4, 5).reshape(n, (h + 1) // 2,
                                                (w + 1) // 2, 4 * c)


def packed_stem_weights(weight: torch.Tensor) -> torch.Tensor:
    """(64, C, 7, 7) -> (4, 4, 4C, 64) f32 [dy, dx, slot, f]:
    the 7x7 kernel zero-padded to 8x8 (a leading row and column) and cut
    into 2x2 blocks, the taps of the stride-1 4x4 conv over
    `pack_stem_input` with padding 2 before and 1 after."""
    f, c = weight.shape[:2]
    k8 = F.pad(weight.float(), (1, 0, 1, 0))  # (F, C, 8, 8)
    k4 = k8.reshape(f, c, 4, 2, 4, 2).permute(2, 4, 3, 5, 1, 0)
    return k4.reshape(4, 4, 4 * c, f)


def stem_mma_weights(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's weights: `packed_stem_weights` flattened to
    K = (dy, dx, slot) = 64C and cut into 4C steps of 16, (4C, 64, 16)
    bf16, each feature's 16 K values contiguous (the mma's B columns)."""
    k4 = packed_stem_weights(weight)
    f = k4.shape[-1]
    return (k4.reshape(-1, 16, f).transpose(1, 2).contiguous()
            .to(torch.bfloat16))


def prepared_stem_params(weight: torch.Tensor, bn: BNParams,
                         dtype: torch.dtype):
    """(kernel weights, BN scale, BN shift) of one modality, prepared once
    per parameter version (`param_cache`): in bf16 `stem_mma_weights`, in
    f32 the weight as [c][ky][kx][64]; the folded BatchNorm in f32."""

    def build():
        w = weight.detach()
        if dtype == torch.bfloat16:
            wk = stem_mma_weights(w)
        else:
            wk = w.float().permute(1, 2, 3, 0).contiguous()
        s, t = fold_bn(*(p.detach() for p in bn))
        return wk, s.contiguous(), t.contiguous()

    return param_cache.cached(weight.untyped_storage(), ("stem", dtype),
                              [weight, *bn], build)


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


def _unflatten_bn(bn: Sequence[torch.Tensor]) -> List[BNParams]:
    return [tuple(bn[i:i + 4]) for i in range(0, len(bn), 4)]


def _out_hw(h: int, w: int) -> Tuple[int, int]:
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def _fused_stems_cuda(xs: List[torch.Tensor], weights: List[torch.Tensor],
                      bn: List[torch.Tensor]) -> List[torch.Tensor]:
    """The kernel launch (the op's CUDA implementation)."""
    bn_params = _unflatten_bn(bn)
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
    hq, wq = _out_hw(h, w)
    args = []
    keep = []
    outs = []
    for x, wt, bnp in zip(xs, weights, bn_params):
        w_k, s, t = prepared_stem_params(wt, bnp, dtype)
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


def _fused_stems_fake(xs, weights, bn):
    n, h, w, _ = xs[0].shape
    hq, wq = _out_hw(h, w)
    return [x.new_empty((n, hq, wq, 64)) for x in xs]


_OP = _native.kernel_op(
    "fused_stems", "(Tensor[] xs, Tensor[] weights, Tensor[] bn) -> Tensor[]",
    _fused_stems_cuda,
    lambda xs, weights, bn: fused_stems_plain(xs, weights, _unflatten_bn(bn)),
    _fused_stems_fake)


def fused_stems(
    xs: Sequence[torch.Tensor],
    weights: Sequence[torch.Tensor],
    bn_params: Sequence[BNParams],
) -> List[torch.Tensor]:
    """Both stems in one launch (the op `emsanet::fused_stems`).

    xs: per-modality inputs (N, H, W, C_m), same N/H/W and dtype;
    weights: per-modality conv weights (64, C_m, 7, 7) (no bias);
    bn_params: per-modality BatchNorm (weight, bias, running_mean,
    running_var). Returns per-modality (N, H/4, W/4, 64).
    """
    return list(_OP(list(xs), list(weights),
                    [p for bn in bn_params for p in bn]))


# the launch count lives on the function object; the body reaches it
# through this alias, which wrapping the module attribute leaves alone
_FUSED_STEMS = fused_stems
_FUSED_STEMS.launches = 0
