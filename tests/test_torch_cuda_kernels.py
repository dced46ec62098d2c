"""Each hand-written CUDA kernel of emsanet_tpu_torch against its plain
PyTorch version, on the card.

Marked `cuda`: they skip without a GPU. This file imports no JAX, so it
runs on a machine with PyTorch for CUDA only:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerances (error relative to the largest magnitude): f32 with TF32 off
1e-4 (summation order), bf16 2e-2 (stem) / 3e-2 (a 2-block chain; the
plain version rounds every conv output to bf16, the kernel only the
pair's intermediate); grouping bit-exact; histogram exact; vector sums
1e-4 (f32 atomics in varying order); lookup exact.
"""

import numpy as np
import pytest
import torch

from emsanet_tpu_torch.ops import grouping, nbt1d_chain, segment_kernels, stem


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bn(rng, c):
    return (rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            rng.rand(c).astype(np.float32) + 0.5)


def _stem_case(seed, n, h, w):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, h, w, c).astype(np.float32) for c in (3, 1)]
    k7s = [(rng.randn(7, 7, c, 64) * 0.1).astype(np.float32) for c in (3, 1)]
    bns = [_bn(rng, 64) for _ in range(2)]
    return xs, k7s, bns


def _chain_case(seed, k, c, shape):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, c).astype(np.float32)
    std = (1.0 / (3 * c)) ** 0.5
    stacked = {
        "w31": (rng.randn(k, 2, 3, c, c) * std).astype(np.float32),
        "w13": (rng.randn(k, 2, 3, c, c) * std).astype(np.float32),
        "b31": (rng.randn(k, 2, c) * 0.1).astype(np.float32),
        "b13": (rng.randn(k, 2, c) * 0.1).astype(np.float32),
        "bn_scale": (rng.rand(k, 2, c) + 0.5).astype(np.float32),
        "bn_shift": (rng.randn(k, 2, c) * 0.1).astype(np.float32),
    }
    return x, stacked


def _grouping_case(seed, n, h, w, k=64):
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    loc = np.stack([ys, xs], -1).reshape(1, h * w, 2).astype(np.float32)
    off = rng.randint(-4, 5, (n, h * w, 2)).astype(np.float32)
    off[:, ::3] += rng.rand(n, (h * w + 2) // 3, 2).astype(np.float32)
    centers = rng.randint(0, max(h, w), (n, k, 2)).astype(np.float32)
    return loc + off, centers, rng.rand(n, k) > 0.3


def _segment_case(seed, n=2, p=5000, k=65, c=41, d=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, k, (n, p)).astype(np.int32),
            rng.randint(0, c, (n, p)).astype(np.int32),
            (rng.rand(n, p) > 0.5).astype(np.float32),
            rng.randn(n, p, d).astype(np.float32))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_stem_matches_plain(dtype, tol):
    _need_cuda()
    xs, k7s, bns = _stem_case(7, n=2, h=120, w=160)
    got = stem.fused_stems(
        [_t(x).cuda().to(dtype) for x in xs],
        [_t(k.transpose(3, 2, 0, 1)).cuda() for k in k7s],
        [tuple(_t(p).cuda() for p in bn) for bn in bns])
    want = stem.fused_stems_plain(
        [_t(x).cuda().to(dtype) for x in xs],
        [_t(k.transpose(3, 2, 0, 1)).cuda().to(dtype) for k in k7s],
        [tuple(_t(p).cuda() for p in bn) for bn in bns])
    for g, wnt in zip(got, want):
        err = (g.float() - wnt.float()).abs().max() / wnt.float().abs().max()
        assert float(err) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("c,shape", [
    (64, (2, 15, 20)), (128, (2, 15, 20)), (256, (2, 15, 20)),
    (512, (2, 15, 20)), (512, (1, 15, 20)), (64, (2, 120, 160)),
    (128, (1, 60, 80)),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_chain_matches_plain(c, shape, dtype, tol):
    """Covers both bf16 tilings: 128-pixel tiles (the 120x160 map) and
    64-pixel tiles with a ragged last tile (the small maps)."""
    _need_cuda()
    x, stacked = _chain_case(8, 2, c, shape)
    st = {k: _t(v).cuda() for k, v in stacked.items()}
    got = nbt1d_chain.nbt1d_chain(_t(x).cuda().to(dtype), st)
    want = nbt1d_chain.nbt1d_chain_plain(_t(x).cuda().to(dtype), st)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= tol


@pytest.mark.cuda
def test_cuda_grouping_and_segments_match_plain():
    _need_cuda()
    voted, centers, valid = _grouping_case(9, 2, 96, 128)
    got = grouping.group_pixels_argmin(*(_t(a).cuda() for a in
                                         (voted, centers, valid)))
    want = grouping.group_pixels_argmin_plain(*(_t(a).cuda() for a in
                                                (voted, centers, valid)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    inst, sem, w, vec = _segment_case(10)
    args = [_t(a).cuda() for a in (inst, sem, w, vec)]
    gh, gs = segment_kernels.segment_hist_and_sums(*args, 65, 41)
    wh, ws = segment_kernels.segment_hist_and_sums_plain(*args, 65, 41)
    assert torch.equal(gh, wh)
    torch.testing.assert_close(gs, ws, atol=1e-4, rtol=1e-5)
    tables = torch.randn((2, 2, 65), device="cuda")
    assert torch.equal(segment_kernels.segment_lookup(args[0], tables),
                       segment_kernels.segment_lookup_plain(args[0], tables))
