"""Each hand-written CUDA kernel of emsanet_tpu_torch against its plain
PyTorch version, on the card.

Marked `cuda`: they skip without a GPU. This file imports no JAX, so it
runs on a machine with PyTorch for CUDA only:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerances (error relative to the largest magnitude): f32 with TF32 off
1e-4 (summation order), bf16 2e-2 (stem) / 3e-2 (a 2-block chain; the
plain version rounds every conv output to bf16, the kernel only the
pair's intermediate); grouping bit-exact; histogram exact; vector sums
1e-4 (f32 atomics in varying order); lookup exact. Semantic decode: f32
index exact and score 1e-5 relative; bf16 index different on at most
1e-4 of the pixels and only where the plain version's top two values are
within one bf16 ulp, score 1e-2 absolute where the index agrees (inputs
are bf16-representable, so f32 tap products are exact). Instance head:
f32 1e-5, bf16 2e-2. Plane interleave: bit-exact.

Train kernels (each output's error relative to its largest magnitude;
the plain versions' backward is autograd of plain PyTorch ops). NBt1D
pair forward: y bf16 5e-2 / f32 1e-4, sums bf16 1e-3 / f32 1e-4 (a y
whose f32 sum lands on the other side of a bf16 rounding boundary moves
by one bf16 ulp; over the few hundred pixels per channel of these shapes
that reaches 1.2e-4 of the sums; on the flagship's 153600 it stays under
1e-4, chip_smoke.py); backward: every gradient bf16 5e-2 / f32 1e-3.
Semantic head loss: loss
bf16 1e-2 / f32 1e-5 (the kernel rounds the summed polyphase taps to
bf16, the plain conv each 3x3 tap); dx 5e-2 / 1e-4, dweight 5e-2 / 1e-3.
"""

import numpy as np
import pytest
import torch

from emsanet_tpu_torch.ops import (
    grouping,
    instance_head,
    nbt1d_chain,
    nbt1d_train,
    plane_interleave,
    segment_kernels,
    semantic_decode,
    semantic_train_head,
    stem,
)


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


def _head_case(seed, n, h2, w2, c, dtype):
    """Head output and depthwise weight, bf16-representable."""
    rng = np.random.RandomState(seed)
    x = _t((rng.randn(n, h2, w2, c) * 3).astype(np.float32))
    w = _t(rng.randn(c, 1, 3, 3).astype(np.float32))
    return (x.cuda().bfloat16().to(dtype), w.cuda().bfloat16().to(dtype))


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 60, 80, 40), (1, 33, 70, 37),
                                   (1, 8, 12, 5),
                                   # more classes than one staged chunk;
                                   # 512 needs > 48 KB of shared memory
                                   (1, 9, 40, 100), (1, 5, 33, 512)])
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_semantic_decode_matches_plain(shape, interleaved, dtype):
    _need_cuda()
    x, w = _head_case(11, *shape, dtype)
    before = semantic_decode.semantic_decode.launches
    gi, gs = semantic_decode.semantic_decode(x, w, interleaved)
    assert semantic_decode.semantic_decode.launches == before + 1
    plain = (semantic_decode.semantic_decode_interleaved_plain if interleaved
             else semantic_decode.semantic_decode_planes_plain)
    wi, ws = plain(x, w)
    torch.cuda.synchronize()
    assert gi.shape == wi.shape and gi.dtype == torch.int32
    same = gi == wi
    if dtype == torch.float32:
        assert bool(same.all())
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=0)
    else:
        assert float((~same).float().mean()) <= 1e-4
        near = semantic_decode.bf16_near_ties(x, w, interleaved)
        assert not bool((~same & ~near).any())
        assert float((gs - ws).abs()[same].max()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [5, 3])
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_instance_head_matches_plain(c, interleaved, dtype, tol):
    _need_cuda()
    x, w = _head_case(12, 2, 60, 80, c, dtype)
    enc = instance_head.encodings_for(c, True, True)
    got = instance_head.instance_head(x, w, enc, interleaved)
    plain = (instance_head.instance_head_upsample_interleaved_plain
             if interleaved else instance_head.instance_head_upsample_plain)
    want = plain(x, w, enc)
    err = (got - want).abs().max() / want.abs().max()
    assert got.shape == want.shape and float(err) <= tol


@pytest.mark.cuda
def test_cuda_interleave_planes_matches_plain():
    _need_cuda()
    rng = np.random.RandomState(13)
    shape = (2, 4, 30, 40)
    named = {
        "score": _t(rng.randn(*shape).astype(np.float32)).cuda(),
        "idx": _t(rng.randint(-2**31, 2**31 - 1, shape).astype(
            np.int32)).cuda(),
        "fg": _t(rng.rand(*shape) > 0.5).cuda(),
    }
    named["nan"] = torch.full(shape, float("nan"), device="cuda")
    before = plane_interleave.interleave_planes.launches
    got = plane_interleave.interleave_planes(named)
    assert plane_interleave.interleave_planes.launches == before + 1
    want = plane_interleave.interleave_planes_plain(named)
    for key in named:
        g, w = got[key], want[key]
        assert g.dtype == w.dtype
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), key


# ---------------------------------------------------------------------------
# training kernels


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _pair_case(seed, shape, dtype):
    """u, s, t, w31, b31, w13, b13, gy, gsums on the card; u, gy and the
    weights bf16-representable. The cotangent of the sums adds per pixel
    about as much as gy, as a BatchNorm's does: far smaller, and bf16 gy
    would swallow it in the plain autograd but not in the kernel."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    std = (1.0 / (3 * c)) ** 0.5

    def rep(a):
        return _t(a.astype(np.float32)).cuda().bfloat16().to(dtype)

    def f32(a):
        return _t(a.astype(np.float32)).cuda()

    return (rep(rng.randn(*shape)), f32(rng.rand(c) + 0.5),
            f32(rng.randn(c) * 0.1), rep(rng.randn(3, c, c) * std),
            f32(rng.randn(c) * 0.1), rep(rng.randn(3, c, c) * std),
            f32(rng.randn(c) * 0.1), rep(rng.randn(*shape)),
            f32(rng.randn(2, c) * 0.1))


PAIR_SHAPES = [(2, 16, 32, 64), (1, 24, 16, 128), (1, 8, 20, 256),
               (2, 120, 160, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAIR_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "affine"])
@pytest.mark.parametrize("dtype,tol,stol,btol", [
    (torch.float32, 1e-4, 1e-4, 1e-3), (torch.bfloat16, 5e-2, 1e-3, 5e-2)])
def test_cuda_nbt1d_pair_matches_plain(shape, mode, dtype, tol, stol, btol):
    _need_cuda()
    u, s, t, w31, b31, w13, b13, gy, gsums = _pair_case(14, shape, dtype)
    args = (mode, u, s, t, w31, b31, w13, b13)
    before = (nbt1d_train.pair_fwd.launches, nbt1d_train.pair_bwd.launches)
    y, sums = nbt1d_train.pair_fwd(*args)
    wy, wsums = nbt1d_train.pair_fwd_plain(*args)
    assert y.dtype == dtype and y.shape == u.shape
    assert _rel(y, wy) <= tol
    assert _rel(sums, wsums) <= stol
    got = nbt1d_train.pair_bwd(*args, gy, gsums)
    want = nbt1d_train.pair_bwd_plain(*args, gy, gsums)
    assert (nbt1d_train.pair_fwd.launches,
            nbt1d_train.pair_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    for name, g, w in zip(("gu", "gs", "gt", "gw31", "gb31", "gw13", "gb13"),
                          got, want):
        assert g.shape == w.shape, name
        if mode == "plain" and name in ("gs", "gt"):
            assert float(g.abs().max()) == 0.0, name
            continue
        assert _rel(g, w) <= btol, name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "affine"])
def test_cuda_nbt1d_pair_autograd_matches_plain_autograd(mode):
    _need_cuda()
    u, s, t, w31, b31, w13, b13, gy, gsums = _pair_case(
        15, (2, 16, 32, 64), torch.float32)
    leaves = [x.clone().requires_grad_(True)
              for x in (u, s, t, w31, b31, w13, b13)]
    y, sums = nbt1d_train.nbt1d_pair(mode, *leaves)
    ((y * gy).sum() + (sums * gsums).sum()).backward()
    want = nbt1d_train.pair_bwd_plain(mode, u, s, t, w31, b31, w13, b13, gy,
                                      gsums)
    for leaf, w in zip(leaves, want):
        assert leaf.grad is not None
        if float(w.abs().max()) > 0:
            assert _rel(leaf.grad, w) <= 1e-3


def _loss_case(seed, n, h2, w2, c, dtype):
    rng = np.random.RandomState(seed)
    x = _t((rng.randn(n, h2, w2, c) * 2).astype(np.float32))
    w = _t((rng.randn(c, 1, 3, 3) * 0.3 + 0.1).astype(np.float32))
    tgt = rng.randint(0, c + 1, (n, 2 * h2, 2 * w2))
    tgt = np.where(rng.rand(*tgt.shape) < 0.2, 0, tgt).astype(np.int32)
    cw = _t((rng.rand(c) + 0.5).astype(np.float32))
    return (x.cuda().bfloat16().to(dtype), w.cuda(), _t(tgt).cuda(),
            cw.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 40, 40), (1, 9, 33, 5),
                                   (1, 5, 7, 64), (2, 60, 80, 40)])
@pytest.mark.parametrize("ls", [0.0, 0.1])
@pytest.mark.parametrize("dtype,tol,dxtol,dktol", [
    (torch.float32, 1e-5, 1e-4, 1e-3), (torch.bfloat16, 1e-2, 5e-2, 5e-2)])
def test_cuda_semantic_head_loss_matches_plain(shape, ls, dtype, tol, dxtol,
                                               dktol):
    _need_cuda()
    x, w, tgt, cw = _loss_case(16, *shape, dtype)
    s, wsum = semantic_train_head.head_loss_fwd(x, w, tgt, cw, ls)
    ws, wwsum = semantic_train_head.head_loss_fwd_plain(x, w, tgt, cw, ls)
    assert _rel(s / wsum, ws / wwsum) <= tol
    assert _rel(wsum, wwsum) <= 1e-6
    gscale = torch.tensor([0.7], device="cuda") / wsum
    dx, dw = semantic_train_head.head_loss_bwd(x, w, tgt, cw, ls, gscale)
    wdx, wdw = semantic_train_head.head_loss_bwd_plain(x, w, tgt, cw, ls,
                                                       gscale)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _rel(dx, wdx) <= dxtol
    assert dw.shape == w.shape and _rel(dw, wdw) <= dktol


@pytest.mark.cuda
def test_cuda_semantic_head_loss_autograd_matches_reference():
    _need_cuda()
    x, w, tgt, cw = _loss_case(17, 2, 12, 40, 40, torch.float32)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    loss = semantic_train_head.fused_semantic_head_loss(xl, wl, tgt, cw, 0.1)
    loss.backward()
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ref = semantic_train_head.semantic_head_loss_reference(xr, wr, tgt, cw,
                                                           0.1)
    ref.backward()
    assert _rel(loss.detach(), ref.detach()) <= 1e-5
    assert _rel(xl.grad, xr.grad) <= 1e-4
    assert _rel(wl.grad, wr.grad) <= 1e-3
