"""Each hand-written CUDA kernel of emsanet_tpu_torch against its plain
PyTorch version, on the card.

Marked `cuda`: they skip without a GPU. This file imports no JAX, so it
runs on a machine with PyTorch for CUDA only:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerances (error relative to the largest magnitude): f32 with TF32 off
1e-4 (summation order), bf16 2e-2 (stem) / 3e-2 (a 2-block chain; the
plain version rounds every conv output to bf16, the kernel only the
pair's intermediate); grouping bit-exact; histogram exact; vector sums
1e-4 of their largest magnitude (the kernel's fixed order of sums is not
the plain scatter_add's); lookup exact. Semantic decode: f32
index exact and score 1e-5 relative; bf16 index different on at most
1e-4 of the pixels and only where the plain version's top two values are
within one bf16 ulp, score 1e-2 absolute where the index agrees (inputs
are bf16-representable, so f32 tap products are exact). Instance head:
f32 1e-5, bf16 2e-2. Plane interleave: bit-exact. Decoder trunk (three
modules of conv_in, K NBt1D blocks, x2 upsample and skip fusion; 2 + 4K
convs each): f32 1e-4, bf16 5e-2 (kernel and plain version round at the
same points, but an f32 sum in another order can land on the other side
of a bf16 rounding boundary, and each module carries such a one-ulp flip
through its 2 + 4K layers, as the chain's bound).

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
The bf16 chain, the bf16 decoder trunk (split K), the segment
histogram and the head-loss forward and backward add their partial sums
in a fixed order, and the stem, the semantic decode and the instance
head sum each output in a fixed order: two calls give the same bits.
"""

import numpy as np
import pytest
import torch
import torch_kernel_cases
import torch_segment_maps

from emsanet_tpu_torch.ops import (
    decoder_trunk,
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


def _stem_case(seed, n, h, w, chans=(3, 1)):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, h, w, c).astype(np.float32) for c in chans]
    k7s = [(rng.randn(7, 7, c, 64) * 0.1).astype(np.float32) for c in chans]
    bns = [_bn(rng, 64) for _ in chans]
    return xs, k7s, bns


def _stem_run(fn, xs, k7s, bns, dtype, plain=False):
    """fn (the kernel or the plain version) on the case's tensors on the
    card; the plain version takes the weights in the compute dtype."""
    return fn([_t(x).cuda().to(dtype) for x in xs],
              [_t(k.transpose(3, 2, 0, 1)).cuda().to(
                  dtype if plain else torch.float32) for k in k7s],
              [tuple(_t(p).cuda() for p in bn) for bn in bns])


def _stem_err(got, want):
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want))


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
def test_cuda_raw_stream_accessor_matches_current_stream():
    """Every wrapper launches on `_native.stream_ptr`: the CUDA build's
    private raw-stream accessor must exist and name the current stream,
    on the default stream and on a side stream."""
    _need_cuda()
    from emsanet_tpu_torch.ops import _native

    assert _native._RAW_STREAM is not None
    x = torch.zeros(1, device="cuda")
    assert _native.stream_ptr(x) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _native.stream_ptr(x) == side.cuda_stream


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
@pytest.mark.parametrize("n,h,w", [(2, 480, 640),
                                   # H, W not multiples of any tile, odd W
                                   (1, 123, 77), (2, 61, 90)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_stem_shapes_match_plain(n, h, w, dtype, tol):
    _need_cuda()
    case = _stem_case(13, n, h, w)
    got = _stem_run(stem.fused_stems, *case, dtype)
    want = _stem_run(stem.fused_stems_plain, *case, dtype, plain=True)
    assert [tuple(g.shape) for g in got] == [tuple(x.shape) for x in want]
    assert _stem_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("chans", [(3,), (1,), (2,), (4,), (4, 3), (2, 1)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_stem_channels_match_plain(chans, dtype, tol):
    """One modality or two, with C = 1..4 (4C packed slots; odd C stages
    a second, shifted copy of the tile)."""
    _need_cuda()
    case = _stem_case(14, 2, 64, 96, chans)
    got = _stem_run(stem.fused_stems, *case, dtype)
    want = _stem_run(stem.fused_stems_plain, *case, dtype, plain=True)
    assert len(got) == len(chans)
    assert _stem_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("chans", [(4, 3), (3, 4), (2, 1), (1, 2), (3, 1)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_stem_modality_switch_matches_plain(chans, dtype, tol):
    """Two modalities at 480x640 b2: 880 tiles, so every block of the
    persistent bf16 grid stages several tiles ahead into its second buffer,
    and some switch modality mid-run. A staging buffer holds a tile of
    either modality (in_bytes(3) > in_bytes(4), in_bytes(1) >
    in_bytes(2))."""
    _need_cuda()
    case = _stem_case(16, 2, 480, 640, chans)
    got = _stem_run(stem.fused_stems, *case, dtype)
    want = _stem_run(stem.fused_stems_plain, *case, dtype, plain=True)
    assert _stem_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stem_repeats_bitwise(dtype):
    _need_cuda()
    case = _stem_case(15, 2, 480, 640)
    first = _stem_run(stem.fused_stems, *case, dtype)
    again = _stem_run(stem.fused_stems, *case, dtype)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


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


# the flagship's chain sites at b1 (15x20 at C = 512 splits K across
# blocks; C = 64 and 128 run the fused pairs), and ragged maps (13 rows:
# a partial tile row; 40 columns in the fused pairs' 14-column tiles)
CHAIN_SITES = [(512, (1, 15, 20)), (256, (1, 30, 40)), (128, (1, 60, 80)),
               (64, (1, 120, 160)), (128, (1, 13, 40)), (64, (1, 13, 40))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,shape", CHAIN_SITES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_chain_sites_match_plain(c, shape, dtype, tol):
    _need_cuda()
    x, stacked = _chain_case(9, 2, c, shape)
    st = {k: _t(v).cuda() for k, v in stacked.items()}
    got = nbt1d_chain.nbt1d_chain(_t(x).cuda().to(dtype), st)
    want = nbt1d_chain.nbt1d_chain_plain(_t(x).cuda().to(dtype), st)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("c,shape", CHAIN_SITES[:4])
def test_cuda_chain_bf16_repeats_bitwise(c, shape):
    """No float atomics: the split-K partials are added in a fixed order."""
    _need_cuda()
    x, stacked = _chain_case(10, 2, c, shape)
    st = {k: _t(v).cuda() for k, v in stacked.items()}
    xb = _t(x).cuda().bfloat16()
    assert torch.equal(nbt1d_chain.nbt1d_chain(xb, st),
                       nbt1d_chain.nbt1d_chain(xb, st))


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


def _grouping_check(voted, centers, valid):
    """The kernel equals the plain version bit for bit (idx and dist), and
    a second call gives the same bits; one launch per call."""
    args = [_t(a).cuda() for a in (voted, centers, valid)]
    before = grouping.group_pixels_argmin.launches
    got = grouping.group_pixels_argmin(*args)
    again = grouping.group_pixels_argmin(*args)
    assert grouping.group_pixels_argmin.launches == before + 2
    want = grouping.group_pixels_argmin_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[0], again[0])
    assert torch.equal(got[1].view(torch.int32), again[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", torch_kernel_cases.EDGE_CASES)
def test_cuda_grouping_edge_cases_match_plain(case):
    _need_cuda()
    _grouping_check(*torch_kernel_cases.edge_case(case))


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [64, 45, 8])
@pytest.mark.parametrize("n", [1, 8])
def test_cuda_grouping_frame_matches_plain(n, n_valid):
    _need_cuda()
    voted = torch_kernel_cases.frame_votes(20 + n, n)
    centers, valid = torch_kernel_cases.center_set(30 + n_valid, n, n_valid)
    _grouping_check(voted, centers, valid)


def _hist_case(case, n, p, d):
    if case == "frame":
        return torch_segment_maps.frame_like(17, n, 480, p // 480, d=d)
    if case == "frame-planes":
        return torch_segment_maps.frame_like(18, n, 480, p // 480, d=d,
                                             order="parity")
    if case == "one-key":
        return torch_segment_maps.one_key(19, n, p, d)
    return torch_segment_maps.uniform(20, n, p, d=d)


def _hist_check(case, n, p, d):
    """Kernel against plain: histogram equal, sums within 1e-4 of their
    largest magnitude, two calls bit-identical, one launch each."""
    args = [_t(a).cuda() for a in _hist_case(case, n, p, d)]
    before = segment_kernels.segment_hist_and_sums.launches
    gh, gs = segment_kernels.segment_hist_and_sums(*args, 65, 41)
    again = segment_kernels.segment_hist_and_sums(*args, 65, 41)
    assert segment_kernels.segment_hist_and_sums.launches == before + 2
    wh, ws = segment_kernels.segment_hist_and_sums_plain(*args, 65, 41)
    torch.cuda.synchronize()
    assert torch.equal(gh, wh)
    assert float((gs - ws).abs().max() / ws.abs().max()) <= 1e-4
    assert torch.equal(gh, again[0]) and torch.equal(gs, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "frame-planes", "one-key",
                                  "uniform"])
@pytest.mark.parametrize("n", [1, 8])
def test_cuda_segment_hist_flagship_matches_plain(case, n):
    """The merge's call at 480x640: a frame-like map (row-major and
    parity-major), one key on every pixel, uniformly random keys; at b1
    and b8 each image spans many blocks."""
    _need_cuda()
    _hist_check(case, n, 480 * 640, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "uniform"])
@pytest.mark.parametrize("n", [1, 8])
def test_cuda_segment_hist_fractional_weights(case, n):
    """Weights that are not whole votes (uniform in [0, 2), a few exact
    integers among them) take the kernel's float path: histogram and
    sums within 1e-5 and 1e-4 of their largest magnitudes, two calls
    bit-identical."""
    _need_cuda()
    inst, sem, _, vec = _hist_case(case, n, 480 * 640, 2)
    rng = np.random.RandomState(22)
    w = (rng.rand(*inst.shape) * 2).astype(np.float32)
    w[:, ::7] = np.round(w[:, ::7])
    args = [_t(a).cuda() for a in (inst, sem, w, vec)]
    gh, gs = segment_kernels.segment_hist_and_sums(*args, 65, 41)
    again = segment_kernels.segment_hist_and_sums(*args, 65, 41)
    wh, ws = segment_kernels.segment_hist_and_sums_plain(*args, 65, 41)
    torch.cuda.synchronize()
    assert float((gh - wh).abs().max() / wh.abs().max()) <= 1e-5
    assert float((gs - ws).abs().max() / ws.abs().max()) <= 1e-4
    assert torch.equal(gh, again[0]) and torch.equal(gs, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "one-key", "uniform"])
@pytest.mark.parametrize("p,d", [(480 * 643, 2),   # P % 4 == 0, ragged tile
                                 (480 * 641, 2),   # P odd: scalar loads
                                 (480 * 67, 1), (480 * 65, 1),
                                 # a pass per two components
                                 (480 * 643, 3), (480 * 641, 4)])
def test_cuda_segment_hist_ragged_matches_plain(case, p, d):
    """P not a multiple of the kernel's 1024-pixel tile, D = 1 to 4."""
    _need_cuda()
    _hist_check(case, 3, p, d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 60, 80, 40), (1, 33, 70, 37),
                                   (1, 8, 12, 5), (1, 17, 31, 19),
                                   (1, 6, 9, 16),
                                   # many 8-class stages; at 512 the f32
                                   # kernel needs > 48 KB of shared memory
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
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_semantic_decode_repeats_bitwise(interleaved, dtype):
    """The flagship's b8 shape; no atomics, a fixed order per pixel."""
    _need_cuda()
    x, w = _head_case(16, 8, 240, 320, 40, dtype)
    first = semantic_decode.semantic_decode(x, w, interleaved)
    again = semantic_decode.semantic_decode(x, w, interleaved)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


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
@pytest.mark.parametrize("shape", [(8, 240, 320, 5), (1, 240, 320, 3),
                                   (1, 17, 31, 5), (2, 9, 66, 5)])
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_instance_head_frame_matches_plain(shape, interleaved, dtype,
                                                tol):
    """The frame's b8 and b1 (no orientation) shapes, and ragged ones
    (odd width: element stores; a width of 66 leaves a block's last
    threads partly outside). Two calls give the same bits."""
    _need_cuda()
    x, w = _head_case(21, *shape, dtype)
    enc = instance_head.encodings_for(shape[-1], True, True)
    before = instance_head.instance_head.launches
    got = instance_head.instance_head(x, w, enc, interleaved)
    again = instance_head.instance_head(x, w, enc, interleaved)
    assert instance_head.instance_head.launches == before + 2
    plain = (instance_head.instance_head_upsample_interleaved_plain
             if interleaved else instance_head.instance_head_upsample_plain)
    want = plain(x, w, enc)
    torch.cuda.synchronize()
    err = (got - want).abs().max() / want.abs().max()
    assert got.shape == want.shape and float(err) <= tol
    assert torch.equal(got, again)


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


def _frame_maps(seed, shape):
    return {key: _t(x).cuda() for key, x in
            torch_kernel_cases.frame_planes(seed, shape).items()}


def _interleave_check(named, launches):
    before = plane_interleave.interleave_planes.launches
    got = plane_interleave.interleave_planes(named)
    assert plane_interleave.interleave_planes.launches == before + launches
    want = plane_interleave.interleave_planes_plain(named)
    torch.cuda.synchronize()
    assert list(got) == list(named)
    for key in named:
        g, w = got[key], want[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), key


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_cuda_interleave_planes_frame_maps_one_launch(n):
    """The frame's 7 maps at 640x480, the bool map in the same launch."""
    _need_cuda()
    _interleave_check(_frame_maps(n, (n, 4, 240, 320)), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 30, 41), (1, 4, 3, 12),
                                   (3, 4, 5, 2)])
def test_cuda_interleave_planes_ragged_widths(shape):
    """Odd W/2 (the scalar path of every map), a W/2 that keeps the word
    maps on the 16-byte path but not the bool map, and the least width;
    plus maps that start off an 8-byte boundary, and a uint8 map."""
    _need_cuda()
    named = _frame_maps(7, shape)
    numel = int(np.prod(shape))
    named["shifted_f32"] = torch.randn(numel + 1, device="cuda")[1:].view(
        shape)
    named["shifted_bool"] = (torch.rand(numel + 3, device="cuda")
                             > 0.5)[3:].view(shape)
    named["uint8"] = torch.randint(0, 256, shape, device="cuda",
                                   dtype=torch.uint8)
    _interleave_check(named, 1)


@pytest.mark.cuda
def test_cuda_interleave_planes_17_maps_two_launches():
    _need_cuda()
    named = {f"m{i}": torch.randn((2, 4, 6, 8), device="cuda")
             for i in range(16)}
    named["fg"] = torch.rand((2, 4, 6, 8), device="cuda") > 0.5
    _interleave_check(named, 2)


@pytest.mark.cuda
def test_cuda_interleave_planes_width_one_takes_the_plain_path():
    _need_cuda()
    named = {"a": torch.randn((2, 4, 5, 1), device="cuda"),
             "fg": torch.rand((2, 4, 5, 1), device="cuda") > 0.5}
    _interleave_check(named, 0)


def _trunk_case(seed, n_dec, n, h0, w0, c0, chans, skip_chans, k, dtype):
    """Context output, skips and stacked parameters of `decoder_trunk`
    (ops/decoder_trunk.py layout) on the card, weights scaled so that the
    maps stay of order 1 through the modules."""
    rng = np.random.RandomState(seed)

    def draw(shape, std):
        return _t((rng.randn(n_dec, *shape) * std).astype(np.float32)).cuda()

    def uniform(shape, lo, hi):
        return _t(rng.uniform(lo, hi, (n_dec, *shape)).astype(
            np.float32)).cuda()

    ctx = _t(rng.randn(n, h0, w0, c0).astype(np.float32)).cuda().to(dtype)
    skips, per_module = [], []
    h, w, c_in = h0, w0, c0
    for c, cs in zip(chans, skip_chans):
        h, w = 2 * h, 2 * w
        skips.append(_t(rng.randn(n, h, w, cs).astype(np.float32)).cuda()
                     .to(dtype))
        bn_scale = uniform((k, 2, c), 0.5, 1.5)
        bn_scale[:, :, 1] *= 0.2  # the residual branch's last norm
        ups = uniform((4, 4, c), 0.0, 0.5)
        per_module.append({
            "cin_w": draw((3, 3, c_in, c), (9 * c_in) ** -0.5).to(dtype),
            "cin_s": uniform((c,), 0.5, 1.5), "cin_t": draw((c,), 0.1),
            "blk_w31": draw((k, 2, 3, c, c), (3 * c) ** -0.5).to(dtype),
            "blk_w13": draw((k, 2, 3, c, c), (3 * c) ** -0.5).to(dtype),
            "blk_b31": draw((k, 2, c), 0.1), "blk_b13": draw((k, 2, c), 0.1),
            "blk_bn_scale": bn_scale, "blk_bn_shift": draw((k, 2, c), 0.1),
            "ups": ups,
            "proj_w": draw((cs, c), cs ** -0.5).to(dtype),
            "proj_s": uniform((c,), 0.5, 1.5), "proj_t": draw((c,), 0.1),
        })
        c_in = c
    return ctx, skips, per_module


_TRUNK_CASES = [
    # small: D 2, b2, a 2x5 context, K 2 (C_s 8: a K chunk of one 8-wide
    # channel group, zero-filled past it; bf16 splits that divide neither
    # the K steps nor the tiles evenly)
    (2, 2, 2, 5, 64, (128, 64, 64), (32, 16, 8), 2),
    # the flagship at b1: 15x20x512 context, skips 256 / 128 / 64, K 3
    (2, 1, 15, 20, 512, (512, 256, 128), (256, 128, 64), 3),
    # the flagship at b2
    (2, 2, 15, 20, 512, (512, 256, 128), (256, 128, 64), 3),
    # the flagship's widths on a 2x2 context: every phase has a few items,
    # so bf16 splits every K loop
    (2, 1, 2, 2, 512, (512, 256, 128), (256, 128, 64), 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _TRUNK_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_cuda_decoder_trunk_matches_plain(case, dtype, tol):
    _need_cuda()
    ctx, skips, per_module = _trunk_case(18, *case, dtype)
    before = decoder_trunk.decoder_trunk.launches
    got = decoder_trunk.decoder_trunk(ctx, skips, per_module)
    assert decoder_trunk.decoder_trunk.launches == before + 1
    want = decoder_trunk.decoder_trunk_plain(ctx, skips, per_module)
    torch.cuda.synchronize()
    n_dec, n, h0, w0, _, chans = case[:6]
    assert got.dtype == dtype
    assert tuple(got.shape) == (n_dec, n, 8 * h0, 8 * w0, chans[-1])
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", _TRUNK_CASES)
def test_cuda_decoder_trunk_bf16_repeats_bitwise(case):
    """Split partials are added in split order: two calls give the same
    bits, and a launch with phase stamps the same output."""
    _need_cuda()
    ctx, skips, per_module = _trunk_case(19, *case, torch.bfloat16)
    first = decoder_trunk.decoder_trunk(ctx, skips, per_module)
    again = decoder_trunk.decoder_trunk(ctx, skips, per_module)
    stamped, phases = decoder_trunk.decoder_trunk_phase_ns(ctx, skips,
                                                           per_module)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first, stamped)
    assert len(phases) == len(case[5]) * (2 + 4 * case[7])
    assert all(p["work"] > 0 and p["wait"] >= 0 for p in phases)
    for p in phases:  # block 0's first unit: its steps in order
        seen = [v for v in p["unit"] if v is not None]
        assert seen and seen == sorted(seen) and seen[-1] <= p["work"]


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


# (1, 13, 40, 64): H and W not multiples of the bf16 kernels' 8 x 16 tile
PAIR_SHAPES = [(2, 16, 32, 64), (1, 24, 16, 128), (1, 8, 20, 256),
               (2, 120, 160, 64), (1, 13, 40, 64)]


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


def relu_flips(mode, u, s, t, w31, b31, gu, want, tol):
    """Accounts for the ReLU mask flips of the pair's first conv in gu.

    Where a pre-activation z of the first conv lies within f32 rounding of
    0, the kernel and the plain version, each with its own summation
    order, can mask it differently. A flip at pixel (n, h, w), channel c
    moves da there by some delta, and so gu at rows h - 1, h, h + 1 of
    column w by delta * w31[0..2, :, c] (times s (v > 0) in affine mode).
    The candidates are the channels whose |z| (float64) is at most
    gamma_K times the sum of its K = 3 C + 1 terms' magnitudes, the bound
    on f32 rounding in any order, at the pixels next to an element of gu
    off by more than tol of the max of want. Each candidate's delta is
    fitted by least squares and its effect removed.

    Returns (the flips whose effect exceeds tol of that max, as (n, c, h,
    w, delta, z, rounding bound); the largest error left, relative to the
    max)."""
    import torch.nn.functional as F

    f64 = torch.float64
    nb, hh, _, c = u.shape
    v = u.permute(0, 3, 1, 2).float()
    if mode == "affine":
        v = F.relu(v * s[:, None, None] + t[:, None, None])
    v = v.to(u.dtype).to(f64)  # the prologue rounded, as both round it
    k31 = w31.to(f64).permute(2, 1, 0)[..., None]  # (O, I, 3, 1)
    z = F.conv2d(v, k31, b31.to(f64), padding=(1, 0))
    terms = F.conv2d(v.abs(), k31.abs(), b31.to(f64).abs(), padding=(1, 0))
    kk = (3 * c + 1) * 2.0 ** -24
    bound = terms * (kk / (1 - kk))
    cand = z.abs() <= bound  # (N, C, H, W)
    fac = torch.ones_like(v) if mode == "plain" else (
        (v > 0).to(f64) * s.to(f64)[:, None, None])
    fac = fac.permute(0, 2, 3, 1).cpu()  # (N, H, W, C_in)
    err = (gu.to(f64) - want.to(f64)).cpu()
    top = float(want.float().abs().max())
    w31d = w31.to(f64).cpu()
    big = (err.abs() > tol * top).any(-1).nonzero().tolist()
    centres = sorted({(n, h + dh, w) for n, h, w in big for dh in (-1, 0, 1)
                      if 0 <= h + dh < hh})
    flips = []
    for n, h, w in centres:
        chans = cand[n, :, h, w].nonzero().flatten().tolist()
        if not chans:
            continue
        rows = [r for r in (h - 1, h, h + 1) if 0 <= r < hh]
        taps = [r - h + 1 for r in rows]  # dv[h + d - 1] takes w31[d]
        basis = torch.stack([(w31d[taps][:, :, ch] * fac[n, rows, w])
                             .reshape(-1) for ch in chans], 1)
        delta = torch.linalg.lstsq(
            basis, err[n, rows, w].reshape(-1, 1)).solution.flatten()
        err[n, rows, w] -= (basis @ delta).reshape(len(rows), c)
        for i, ch in enumerate(chans):
            if abs(float(delta[i])) * float(basis[:, i].abs().max()) > \
                    tol * top:
                flips.append((n, ch, h, w, float(delta[i]),
                              float(z[n, ch, h, w]),
                              float(bound[n, ch, h, w])))
    return flips, float(err.abs().max()) / top


# The shapes at which each block of the persistent bf16 kernels walks
# several tiles through the streamed weights (more tiles than the card
# holds blocks), and the one case among them whose gu misses the bound by
# ReLU mask flips: there gu is held to the bound once the flips, at most
# two, are accounted for (relu_flips), and no more than two flips' worth
# of elements (2 x 3 x C) may lie beyond it.
MANY_TILE_SHAPES = [(2, 60, 80, 128), (2, 60, 40, 256)]
RELU_FLIP_CASES = {((2, 60, 80, 128), "plain", torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MANY_TILE_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "affine"])
@pytest.mark.parametrize("dtype,tol,stol,btol", [
    (torch.float32, 1e-4, 1e-4, 1e-3), (torch.bfloat16, 5e-2, 1e-3, 5e-2)])
def test_cuda_nbt1d_pair_many_tiles_matches_plain(shape, mode, dtype, tol,
                                                  stol, btol):
    """The bounds of `test_cuda_nbt1d_pair_matches_plain` on every output,
    gu of RELU_FLIP_CASES excepted (see there)."""
    _need_cuda()
    u, s, t, w31, b31, w13, b13, gy, gsums = _pair_case(14, shape, dtype)
    args = (mode, u, s, t, w31, b31, w13, b13)
    y, sums = nbt1d_train.pair_fwd(*args)
    wy, wsums = nbt1d_train.pair_fwd_plain(*args)
    assert _rel(y, wy) <= tol
    assert _rel(sums, wsums) <= stol
    got = nbt1d_train.pair_bwd(*args, gy, gsums)
    want = nbt1d_train.pair_bwd_plain(*args, gy, gsums)
    torch.cuda.synchronize()
    for name, g, w in zip(("gu", "gs", "gt", "gw31", "gb31", "gw13", "gb13"),
                          got, want):
        if mode == "plain" and name in ("gs", "gt"):
            assert float(g.abs().max()) == 0.0, name
        elif name == "gu" and (shape, mode, dtype) in RELU_FLIP_CASES:
            beyond = int(((g.float() - w.float()).abs() >
                          btol * w.float().abs().max()).sum())
            assert beyond <= 2 * 3 * shape[-1]
            flips, left = relu_flips(mode, u, s, t, w31, b31, g, w, btol)
            assert len(flips) <= 2 and left <= btol, (flips, left)
        else:
            assert _rel(g, w) <= btol, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 120, 160, 64), (1, 24, 16, 128),
                                   (1, 13, 40, 64), (2, 60, 40, 256)])
@pytest.mark.parametrize("mode", ["plain", "affine"])
def test_cuda_nbt1d_pair_bf16_repeats_bitwise(shape, mode):
    """Two bf16 calls on the same inputs give the same bits: every sum is
    taken in a fixed order, with no float atomics."""
    _need_cuda()
    u, s, t, w31, b31, w13, b13, gy, gsums = _pair_case(
        16, shape, torch.bfloat16)
    args = (mode, u, s, t, w31, b31, w13, b13)
    first, second = (nbt1d_train.pair_fwd(*args) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    first, second = (nbt1d_train.pair_bwd(*args, gy, gsums)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _loss_case(seed, n, h2, w2, c, dtype, void=0.2):
    rng = np.random.RandomState(seed)
    x = _t((rng.randn(n, h2, w2, c) * 2).astype(np.float32))
    w = _t((rng.randn(c, 1, 3, 3) * 0.3 + 0.1).astype(np.float32))
    tgt = rng.randint(0, c + 1, (n, 2 * h2, 2 * w2))
    tgt = np.where(rng.rand(*tgt.shape) < void, 0, tgt).astype(np.int32)
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
@pytest.mark.parametrize("shape", [(2, 60, 80, 40), (1, 20, 30, 13)])
@pytest.mark.parametrize("void", [0.2, 0.9])
@pytest.mark.parametrize("dtype,dxtol,dktol", [
    (torch.float32, 1e-4, 1e-3), (torch.bfloat16, 5e-2, 5e-2)])
def test_cuda_semantic_head_loss_bwd_chunks(shape, void, dtype, dxtol, dktol):
    """The backward's class chunks (8 classes): C = 40, and C = 13 with a
    partial last chunk; void-heavy labels leave most positions at weight
    0. Two calls give the same bits."""
    _need_cuda()
    x, w, tgt, cw = _loss_case(18, *shape, dtype, void=void)
    _, wsum = semantic_train_head.head_loss_fwd(x, w, tgt, cw, 0.1)
    gscale = torch.tensor([0.7], device="cuda") / wsum
    dx, dw = semantic_train_head.head_loss_bwd(x, w, tgt, cw, 0.1, gscale)
    dx2, dw2 = semantic_train_head.head_loss_bwd(x, w, tgt, cw, 0.1, gscale)
    wdx, wdw = semantic_train_head.head_loss_bwd_plain(x, w, tgt, cw, 0.1,
                                                       gscale)
    torch.cuda.synchronize()
    assert _rel(dx, wdx) <= dxtol
    assert _rel(dw, wdw) <= dktol
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 60, 80, 40), (1, 20, 30, 13),
                                   (1, 5, 7, 64), (2, 33, 70, 64)])
@pytest.mark.parametrize("void", [0.2, 0.9])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_semantic_head_loss_fwd_repeats(shape, void, dtype, tol):
    """The forward's persistent grid over 8 x 32 tiles: ragged maps, C up
    to 64, void-heavy labels (most positions skip both passes). Block
    sums are added in a fixed order: two calls give the same bits."""
    _need_cuda()
    x, w, tgt, cw = _loss_case(20, *shape, dtype, void=void)
    s, wsum = semantic_train_head.head_loss_fwd(x, w, tgt, cw, 0.1)
    s2, wsum2 = semantic_train_head.head_loss_fwd(x, w, tgt, cw, 0.1)
    ws, wwsum = semantic_train_head.head_loss_fwd_plain(x, w, tgt, cw, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(s, s2) and torch.equal(wsum, wsum2)
    assert _rel(s / wsum, ws / wwsum) <= tol
    assert _rel(wsum, wwsum) <= 1e-6


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
