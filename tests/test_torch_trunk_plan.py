"""The bf16 decoder-trunk kernel's phase plan (`ops/decoder_trunk.py::
trunk_plan`): the K split of each phase and the workspace it needs, for a
given grid. Pure Python, no card: the plan is what the wrapper hands the
kernel (csrc/decoder_trunk.cu), which takes split s's K steps as
`TrunkPhase.split_steps(s)` gives them."""

import pytest

from emsanet_tpu_torch.ops.decoder_trunk import (
    _CHANNEL_TILE,
    _PIXEL_TILE,
    MIN_SPLIT_STEPS,
    TrunkPhase,
    plan_workspace,
    trunk_plan,
)

FLAGSHIP = dict(n_dec=2, h0=15, w0=20, c_context=512,
                n_channels=(512, 256, 128), skip_channels=(256, 128, 64),
                n_blocks=3)
SMALL = dict(n_dec=2, h0=2, w0=5, c_context=64, n_channels=(128, 64, 64),
             skip_channels=(32, 16, 8), n_blocks=2)
CASES = {
    "flagship b1": dict(FLAGSHIP, n=1),
    "flagship b2": dict(FLAGSHIP, n=2),
    "flagship b8": dict(FLAGSHIP, n=8),
    "flagship 2x2": dict(FLAGSHIP, n=1, h0=2, w0=2),
    "small": dict(SMALL, n=2),
}
# an H100 at 3, 2 and 1 blocks per SM, and a small grid
GRIDS = (396, 264, 132, 7)


def _plan(case, grid):
    return trunk_plan(grid=grid, **CASES[case])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_splits_take_whole_k_steps(case, grid):
    """Every split takes a contiguous, non-empty range of whole 64-wide K
    steps; the splits of a phase cover its K loop once."""
    for p in _plan(case, grid):
        assert 1 <= p.split <= p.steps, p
        ranges = [p.split_steps(s) for s in range(p.split)]
        assert ranges[0][0] == 0 and ranges[-1][1] == p.steps, p
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2, p
        assert all(hi > lo for lo, hi in ranges), p
        if p.split > 1:
            assert min(hi - lo for lo, hi in ranges) >= MIN_SPLIT_STEPS


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_no_phase_needs_a_second_wave_unless_k_cannot_split(case, grid):
    """items x split fits the grid; a phase with more items than blocks
    runs unsplit (splitting its K would only add waves), and a phase that
    leaves blocks idle is split as far as the grid and its K steps
    allow."""
    for p in _plan(case, grid):
        if p.items >= grid:
            assert p.split == 1, p
            continue
        assert p.items * p.split <= grid, p
        can_grow = (p.items * (p.split + 1) <= grid
                    and p.steps // (p.split + 1) >= MIN_SPLIT_STEPS)
        assert not can_grow, p


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_workspace_covers_the_largest_split_phase(case, grid):
    phases = _plan(case, grid)
    floats, tickets = plan_workspace(phases)
    for p in phases:
        if p.split > 1:
            assert floats >= p.items * p.split * _PIXEL_TILE * _CHANNEL_TILE
            assert tickets >= p.items
    if all(p.split == 1 for p in phases):
        assert (floats, tickets) == (0, 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_phases_follow_the_kernel(case):
    """Per module conv_in, 4 K block convs (one split for all four), the
    projection; items and K steps from the shapes."""
    cfg = CASES[case]
    phases = _plan(case, 396)
    per = 2 + 4 * cfg["n_blocks"]
    assert len(phases) == len(cfg["n_channels"]) * per
    h, w, c_in = cfg["h0"], cfg["w0"], cfg["c_context"]
    for i, (c, cs) in enumerate(zip(cfg["n_channels"],
                                    cfg["skip_channels"])):
        mod = phases[per * i:per * (i + 1)]
        m_tiles = -(-cfg["n"] * h * w // 64)
        assert mod[0] == TrunkPhase(f"m{i} conv_in",
                                    cfg["n_dec"] * m_tiles * (c // 64),
                                    9 * -(-c_in // 64), mod[0].split)
        assert len({(p.items, p.steps, p.split) for p in mod[1:-1]}) == 1
        assert mod[1].steps == 3 * (c // 64)
        assert mod[-1].items == cfg["n_dec"] * -(
            -cfg["n"] * 4 * h * w // 64) * (c // 64)
        assert mod[-1].steps == -(-cs // 64)
        h, w, c_in = 2 * h, 2 * w, c


def test_flagship_b1_splits_on_an_h100():
    """At b1 on 396 blocks (132 SMs, 3 blocks each) the module-1 and
    module-2 phases leave blocks idle and are split; module 3 fills the
    grid with its own items."""
    phases = {p.name: p for p in _plan("flagship b1", 396)}
    assert (phases["m0 conv_in"].items, phases["m0 conv_in"].split) == (80, 4)
    assert phases["m0 b0.0 3x1"].split == 4
    assert phases["m1 conv_in"].split == 2 and phases["m1 b2.1 1x3"].split == 2
    assert phases["m2 conv_in"].items == 300 and phases["m2 conv_in"].split == 1
    assert all(phases[f"m{i} proj+up"].split == 1 for i in range(3))
