"""The port's kernel ops (emsanet_tpu_torch/ops) against the JAX kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels
run as their own tests run them (stem and chain auto-interpret off-TPU,
grouping and segment kernels with interpret=True). Inputs come from a
numpy seed and reach both packages as numpy arrays.

Tolerances: stem and chain at f32, atol 1e-4 / rtol 1e-3 (conv
accumulation order differs); grouping index bit-exact; histogram exact
(0/1 votes); vector sums 1e-5 (summation order); lookup exact.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_kernel_cases

from emsanet_tpu.ops import grouping as jax_grouping
from emsanet_tpu.ops import segment_pallas as jax_segment
from emsanet_tpu.ops.nbt1d_chain import nbt1d_chain as jax_chain
from emsanet_tpu.ops.stem import fused_stems as jax_stems
from emsanet_tpu_torch.ops import grouping, nbt1d_chain, segment_kernels, stem


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bn(rng, c):
    return (rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            rng.rand(c).astype(np.float32) + 0.5)


def _stem_case(seed, n=1, h=32, w=128):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, h, w, c).astype(np.float32) for c in (3, 1)]
    k7s = [(rng.randn(7, 7, c, 64) * 0.1).astype(np.float32) for c in (3, 1)]
    bns = [_bn(rng, 64) for _ in range(2)]
    return xs, k7s, bns


def _port_stems(xs, k7s, bns, device="cpu", dtype=torch.float32):
    return stem.fused_stems(
        [_t(x).to(device, dtype) for x in xs],
        [_t(k.transpose(3, 2, 0, 1)).to(device) for k in k7s],
        [tuple(_t(p).to(device) for p in bn) for bn in bns],
    )


@pytest.mark.parametrize("h,w", [(32, 128), (48, 128)])
def test_stem_plain_matches_jax(h, w):
    xs, k7s, bns = _stem_case(0, h=h, w=w)
    want = jax_stems(tuple(jnp.asarray(x) for x in xs),
                     tuple(jnp.asarray(k) for k in k7s),
                     tuple(tuple(jnp.asarray(p) for p in bn) for bn in bns))
    got = _port_stems(xs, k7s, bns)
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == tuple(wnt.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                   atol=1e-4, rtol=1e-3)


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


@pytest.mark.parametrize("c,k,shape", [
    (64, 2, (1, 8, 16)),
    (128, 3, (2, 6, 8)),
    (256, 2, (1, 4, 6)),
])
def test_chain_plain_matches_jax(c, k, shape):
    x, stacked = _chain_case(1, k, c, shape)
    want = jax_chain(jnp.asarray(x),
                     {key: jnp.asarray(v) for key, v in stacked.items()})
    got = nbt1d_chain.nbt1d_chain(_t(x), {key: _t(v) for key, v in
                                          stacked.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-3)


def _grouping_case(seed, n=2, h=24, w=32, k=64):
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    loc = np.stack([ys, xs], -1).reshape(1, h * w, 2).astype(np.float32)
    # integer-valued offsets make exact distance ties between centers
    off = rng.randint(-4, 5, (n, h * w, 2)).astype(np.float32)
    off[:, ::3] += rng.rand(n, (h * w + 2) // 3, 2).astype(np.float32)
    voted = loc + off
    centers = rng.randint(0, max(h, w), (n, k, 2)).astype(np.float32)
    valid = rng.rand(n, k) > 0.3
    return voted, centers, valid


def test_grouping_plain_matches_jax_bit_exact():
    voted, centers, valid = _grouping_case(2)
    want_i, want_d = jax_grouping.group_pixels_argmin(
        jnp.asarray(voted), jnp.asarray(centers), jnp.asarray(valid),
        interpret=True)
    ref_i, ref_d = jax_grouping.group_pixels_argmin_reference(
        jnp.asarray(voted), jnp.asarray(centers), jnp.asarray(valid))
    got_i, got_d = grouping.group_pixels_argmin(
        _t(voted), _t(centers), _t(valid))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))


@pytest.mark.parametrize("case", torch_kernel_cases.EDGE_CASES)
def test_grouping_edge_cases_plain_matches_jax_bit_exact(case):
    """All centers invalid, one valid at index 0 or K-1, valid centers
    that are no prefix of K, valid centers at >= 1e12 behind (and ahead
    of) invalid ones, K = 1 and 65, P not a multiple of 4."""
    voted, centers, valid = torch_kernel_cases.edge_case(case)
    args = [jnp.asarray(a) for a in (voted, centers, valid)]
    want_i, want_d = jax_grouping.group_pixels_argmin(*args, interpret=True)
    ref_i, ref_d = jax_grouping.group_pixels_argmin_reference(*args)
    got_i, got_d = grouping.group_pixels_argmin(
        _t(voted), _t(centers), _t(valid))
    for want in (want_i, ref_i):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want))
    for want in (want_d, ref_d):
        np.testing.assert_array_equal(got_d.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    if case in ("all-invalid", "k1-invalid"):
        assert not got_i.any() and bool((got_d == 1e12).all())


def _segment_case(seed, n=2, p=5000, k=65, c=41, d=2):
    rng = np.random.RandomState(seed)
    inst = rng.randint(0, k, (n, p)).astype(np.int32)
    sem = rng.randint(0, c, (n, p)).astype(np.int32)
    w = (rng.rand(n, p) > 0.5).astype(np.float32)
    vec = rng.randn(n, p, d).astype(np.float32)
    return inst, sem, w, vec


def test_hist_and_sums_plain_matches_jax():
    inst, sem, w, vec = _segment_case(3)
    want_h, want_s = jax_segment.segment_hist_and_sums(
        *(jnp.asarray(a) for a in (inst, sem, w, vec)),
        num_segments=65, num_classes=41, interpret=True)
    got_h, got_s = segment_kernels.segment_hist_and_sums(
        *(_t(a) for a in (inst, sem, w, vec)),
        num_segments=65, num_classes=41)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=1e-5, rtol=1e-5)


def test_hist_ignores_out_of_range_keys():
    inst = _t(np.array([[0, 1, 5, -1, 1]], np.int32))
    sem = _t(np.array([[1, 2, 0, 0, 9]], np.int32))
    w = torch.ones((1, 5))
    vec = torch.ones((1, 5, 1))
    hist, sums = segment_kernels.segment_hist_and_sums(
        inst, sem, w, vec, num_segments=3, num_classes=3)
    want = np.zeros((1, 3, 3), np.float32)
    want[0, 0, 1] = want[0, 1, 2] = 1.0
    np.testing.assert_array_equal(hist.numpy(), want)
    np.testing.assert_array_equal(sums.numpy()[0, :, 0], [1.0, 2.0, 0.0])


def test_lookup_plain_matches_jax():
    rng = np.random.RandomState(4)
    inst = rng.randint(0, 65, (2, 5000)).astype(np.int32)
    tables = rng.randn(2, 2, 65).astype(np.float32)
    want = jax_segment.segment_lookup(jnp.asarray(inst), jnp.asarray(tables),
                                      interpret=True)
    got = segment_kernels.segment_lookup(_t(inst), _t(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_version():
    before = (stem.fused_stems.launches, nbt1d_chain.nbt1d_chain.launches,
              grouping.group_pixels_argmin.launches,
              segment_kernels.segment_hist_and_sums.launches,
              segment_kernels.segment_lookup.launches)
    inst, sem, w, vec = _segment_case(5, p=64)
    segment_kernels.segment_hist_and_sums(
        *(_t(a) for a in (inst, sem, w, vec)), num_segments=65,
        num_classes=41)
    segment_kernels.segment_lookup(_t(inst), torch.zeros((2, 2, 65)))
    voted, centers, valid = _grouping_case(6, h=4, w=4)
    grouping.group_pixels_argmin(_t(voted), _t(centers), _t(valid))
    after = (stem.fused_stems.launches, nbt1d_chain.nbt1d_chain.launches,
             grouping.group_pixels_argmin.launches,
             segment_kernels.segment_hist_and_sums.launches,
             segment_kernels.segment_lookup.launches)
    assert after == before


class _FakeCard:
    """A tensor stand-in on card 3 for `_native.stream_ptr`."""

    device = "cuda:3"

    def get_device(self):
        return 3


def test_stream_ptr_takes_the_raw_accessor(monkeypatch):
    from emsanet_tpu_torch.ops import _native

    monkeypatch.setattr(_native, "_RAW_STREAM", lambda dev: 1000 + dev)
    assert _native.stream_ptr(_FakeCard()) == 1003


def test_stream_ptr_falls_back_without_the_raw_accessor(monkeypatch):
    from emsanet_tpu_torch.ops import _native

    class Stream:
        cuda_stream = 77

    asked = []
    monkeypatch.setattr(_native, "_RAW_STREAM", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: asked.append(dev) or Stream())
    assert _native.stream_ptr(_FakeCard()) == 77
    assert asked == ["cuda:3"]
