"""The panoptic merge's segment histogram and the polyphase tap cache,
on the CPU.

- The histogram's plain version (`ops/segment_kernels.py::
  segment_hist_and_sums_plain`, the CUDA wrapper's CPU path and the card
  tests' oracle) against the JAX package's Pallas kernel
  (`emsanet_tpu/ops/segment_pallas.py::segment_hist_and_sums`, in
  interpret mode) on frame-like key maps (`torch_segment_maps.py`):
  P not a multiple of the TPU kernel's 4096-pixel tile, keys and classes
  out of range, 1 to 3 vector components. Votes are 0/1, so the histogram is exact; vector sums to
  1e-5 relative to their largest magnitude (summation order).
- The kernel's grid plan (`hist_plan`): every pixel in exactly one
  block's span, every block resident at once, each image split over
  enough blocks to cover an H100's SMs at b1.
- `polyphase_upsample.cached_parity_taps`, which the semantic decode
  and the instance head both take their taps from: built once per weight
  version.
"""

import numpy as np
import pytest
import torch

from torch_segment_maps import frame_like, one_key, parity_major, uniform

from emsanet_tpu.ops import segment_pallas
from emsanet_tpu_torch.ops import instance_head, semantic_decode
from emsanet_tpu_torch.ops.polyphase_upsample import (
    cached_parity_taps,
    parity_taps,
)
from emsanet_tpu_torch.ops.segment_kernels import (
    hist_plan,
    segment_hist_and_sums,
    segment_hist_and_sums_plain,
)

S, C = 65, 41
H100_SMS = 132


def _against_jax(case, s=S, c=C):
    inst, sem, w, vec = case
    want_h, want_s = segment_pallas.segment_hist_and_sums(
        inst, sem, w, vec, num_segments=s, num_classes=c, interpret=True)
    got_h, got_s = segment_hist_and_sums_plain(
        *(torch.from_numpy(a) for a in case), s, c)
    assert got_h.shape == (inst.shape[0], s, c)
    assert got_s.shape == (inst.shape[0], s, vec.shape[-1])
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    want_s = np.asarray(want_s)
    err = np.abs(got_s.numpy() - want_s).max() / np.abs(want_s).max()
    assert err <= 1e-5


@pytest.mark.parametrize("order", ["row", "parity"])
@pytest.mark.parametrize("n,h,w,d", [(2, 48, 64, 2), (1, 62, 74, 2),
                                     (1, 40, 52, 1), (1, 36, 58, 3)])
def test_hist_plain_matches_pallas_on_frame_like_maps(n, h, w, d, order):
    """P = 3072, 4588, 2080 and 2088: none a multiple of 4096."""
    _against_jax(frame_like(3, n, h, w, d=d, order=order))


@pytest.mark.parametrize("case", ["one_key", "uniform"])
def test_hist_plain_matches_pallas_on_worst_cases(case):
    p = 4096 + 1000
    maps = one_key(4, 2, p) if case == "one_key" else uniform(4, 2, p)
    _against_jax(maps)


def test_frame_like_map_shape():
    """The helper's frame: ~80% of the pixels in segment 0, instances in
    coherent regions, keys -1 and S, classes -1, 0, C - 1 and C."""
    inst, sem, w, vec = frame_like(5, 2, 96, 128)
    share0 = float((inst == 0).mean())
    assert 0.7 <= share0 <= 0.85
    for key in (-1, S):
        assert (inst == key).any()
    for cls in (-1, 0, C - 1, C):
        assert (sem == cls).any()
    assert set(np.unique(w)) <= {0.0, 1.0}
    assert np.abs(vec[inst == 0]).sum(-1).min() > 0
    # runs: neighbouring pixels share their key far more often than not
    assert float((inst[:, 1:] == inst[:, :-1]).mean()) > 0.9
    planes = parity_major(inst.reshape(2, 96, 128), 96, 128)
    assert float((planes[:, 1:] == planes[:, :-1]).mean()) > 0.9


def test_hist_wrapper_cpu_path_is_plain():
    case = [torch.from_numpy(a) for a in frame_like(6, 2, 32, 40)]
    before = segment_hist_and_sums.launches
    got = segment_hist_and_sums(*case, S, C)
    want = segment_hist_and_sums_plain(*case, S, C)
    assert segment_hist_and_sums.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# an H100 at 4, 3 and 1 blocks per SM, and a small card
CARDS = [(H100_SMS, 4), (H100_SMS, 3), (H100_SMS, 1), (8, 2)]
SIZES = [(1, 307200), (2, 307200), (8, 307200), (16, 307200),
         (1, 307204), (3, 5000), (1, 1), (1, 0), (1000, 2048)]
TILE = 1024  # the kernel's (csrc/segment.cu kHistTile); the plan takes any


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("n,p", SIZES)
@pytest.mark.parametrize("tile", [TILE, 4096])
def test_hist_plan_covers_every_pixel_once(n, p, card, tile):
    blocks, per_block = hist_plan(n, p, tile, *card)
    tiles = max(1, -(-p // tile))
    assert blocks >= 1 and per_block >= 1
    # spans of per_block tiles: together they hold every tile, and the
    # last block's span starts inside the image
    assert blocks * per_block >= tiles
    assert (blocks - 1) * per_block < tiles
    room = card[0] * card[1]
    if n <= room:  # all blocks at once, and no smaller span would do
        assert n * blocks <= room
        if per_block > 1:
            assert n * -(-tiles // (per_block - 1)) > room


@pytest.mark.parametrize("per_sm", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_hist_plan_fills_the_card(n, per_sm):
    """A 640x480 frame: at b1, b2 and b8 every SM of an H100 gets a block,
    and all of them fit at once."""
    blocks, _ = hist_plan(n, 307200, TILE, H100_SMS, per_sm)
    assert H100_SMS <= n * blocks <= H100_SMS * per_sm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cached_parity_taps_once_per_version(dtype):
    w = torch.from_numpy(np.random.RandomState(7).randn(5, 1, 3, 3)
                         .astype(np.float32))
    cpu = torch.device("cpu")
    first = cached_parity_taps(w, dtype, cpu)
    assert cached_parity_taps(w, dtype, cpu) is first
    assert torch.equal(first, parity_taps(w, dtype))
    with torch.no_grad():
        w.mul_(-2.0)  # in place: the version moves
    second = cached_parity_taps(w, dtype, cpu)
    assert second is not first
    assert torch.equal(second, parity_taps(w, dtype))
    assert cached_parity_taps(w.detach(), dtype, cpu) is second


def test_decode_and_instance_head_share_the_tap_cache():
    """Both wrappers take their taps from the one function, so a weight
    passed to both is prepared once per dtype and device."""
    assert instance_head.cached_parity_taps is cached_parity_taps
    assert semantic_decode.cached_parity_taps is cached_parity_taps
    w = torch.ones(3, 1, 3, 3)
    cpu = torch.device("cpu")
    bf16 = cached_parity_taps(w, torch.bfloat16, cpu)
    f32 = cached_parity_taps(w, torch.float32, cpu)
    assert bf16 is not f32
    assert cached_parity_taps(w, torch.bfloat16, cpu) is bf16
