"""The end-to-end arithmetic, the kernels' operations and bytes, and the
model FLOPs behind `mfu`, against hand-worked numbers."""

import pytest
import torch

from harness import kernel_spec
from harness.loop import percentile, run_loop, window_stats


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeEvent:
    """Completes at `done_at` on the fake clock."""

    def __init__(self, clock, done_at):
        self.clock, self.done_at = clock, done_at

    def synchronize(self):
        self.clock.t = max(self.clock.t, self.done_at)


def test_closed_loop_keeps_at_most_in_flight():
    clock = FakeClock()
    device_free = [0.0]
    starts = []

    def submit(i, rec):
        starts.append(clock.t)
        clock.t += 0.001  # host enqueue
        device_free[0] = max(device_free[0], clock.t) + 0.010
        return FakeEvent(clock, device_free[0])

    recs = run_loop(submit, 2, count=6, clock=clock)
    assert len(recs) == 6
    # the third request waits for the first to end
    assert starts[2] >= recs[0]["end"]
    # the device ran back to back: request i ended at 1 ms + 10 (i + 1) ms
    assert [r["end"] for r in recs] == pytest.approx(
        [0.001 + 0.010 * (i + 1) for i in range(6)])


def test_loop_stops_at_the_window_end():
    clock = FakeClock()

    def submit(i, rec):
        clock.t += 0.004
        return None

    recs = run_loop(submit, 2, until=0.010, clock=clock)
    assert len(recs) == 3  # submitted at 0, 4 and 8 ms


def test_window_rate_and_tail_with_a_stall():
    # 20 requests of 32 frames, 10 ms each back to back, one stalled to
    # 200 ms; the loop's last wait returned at 0.39 s
    recs, t = [], 0.0
    for i in range(20):
        d = 0.200 if i == 7 else 0.010
        recs.append({"start": t, "end": t + d, "host_ms": 1.0})
        t += d
    s = window_stats(recs, 0.0, t, 32)
    assert s["completed"] == s["attempted"] == 20
    assert s["seconds"] == pytest.approx(0.39)
    assert s["items_per_s"] == pytest.approx(32 * 20 / 0.39)
    # p95 over all 20 requests: the 19th smallest of 20 (nearest rank)
    # is 10 ms; the stall is the 20th
    assert s["latency_ms_p95"] == pytest.approx(10.0)
    recs2 = [dict(r) for r in recs]
    recs2[3]["end"] = recs2[3]["start"] + 0.2
    s2 = window_stats(recs2, 0.0, t, 32)
    assert s2["latency_ms_p95"] == pytest.approx(200.0)
    # a loop whose time is up at 45 ms: it sends nothing more, waits for
    # the requests in flight, and the window closes after that wait, so
    # every request sent counts, over all of the time
    clock = FakeClock()
    device_free = [0.0]

    def submit(i, rec):
        clock.t += 0.004
        device_free[0] = max(device_free[0], clock.t) + 0.010
        return FakeEvent(clock, device_free[0])

    recs3 = run_loop(submit, 2, until=0.045, clock=clock)
    s3 = window_stats(recs3, 0.0, clock(), 32)
    assert s3["seconds"] == pytest.approx(recs3[-1]["end"]) and clock() > 0.045
    assert s3["items_per_s"] == pytest.approx(32 * len(recs3) / clock())
    assert all(r["end"] >= r["start"] for r in recs3)


def test_percentile_nearest_rank():
    assert percentile([1, 2, 3, 4], 50) == 2
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([5.0], 95) == 5.0


def test_chain_and_pair_operations_and_bytes():
    # chain: x (8, 60, 80, 128) bf16, K = 3 blocks: 4 three-tap convs,
    # 12 C^2 multiply-adds a pixel and block, 2 operations each
    ops, byts = kernel_spec.chain((8, 60, 80, 128), 3, 2)
    assert ops == 3 * 12 * 128 * 128 * 2 * 8 * 60 * 80
    assert byts == 2 * 8 * 60 * 80 * 128 * 2 + 3 * 12 * 128 * 128 * 2
    # pair forward: 12 C^2 operations a pixel; backward 36 C^2
    px = 8 * 120 * 160
    ops_f, byts_f = kernel_spec.pair((8, 120, 160, 64), 2, backward=False)
    assert ops_f == 12 * 64 * 64 * px
    assert byts_f == 2 * px * 64 * 2 + 6 * 64 * 64 * 2
    ops_b, byts_b = kernel_spec.pair((8, 120, 160, 64), 2, backward=True)
    assert ops_b == 36 * 64 * 64 * px
    assert byts_b == 3 * px * 64 * 2 + 6 * 64 * 64 * 2 + 6 * 64 * 64 * 4


def _hand_flops_esanet(h, w):
    """ESANet-R34-NBt1D forward FLOPs (2 a multiply-add), layer by layer,
    for one h x w frame."""
    def conv(cout, cin_per_group, k, ho, wo):
        return 2 * cout * cin_per_group * k * ho * wo

    def se(c):  # two dense layers C -> C/16 -> C
        return 2 * (2 * c * (c // 16))

    total = 0
    for cin in (3, 1):  # stems
        total += conv(64, cin, 49, h // 2, w // 2)
    total += 2 * se(64)  # fusion after the stems
    hh, ww = h // 4, w // 4
    c = 64
    for n, f, s in zip((3, 4, 6, 3), (64, 128, 256, 512), (1, 2, 2, 2)):
        ho, wo = hh // s, ww // s
        for _ in range(2):  # rgb and depth
            cin = c
            for b in range(n):
                st = s if b == 0 else 1
                hi = hh if b == 0 else ho
                total += conv(f, cin, 3, hi // st, ww if b == 0 else wo)
                total += conv(f, f, 3, ho, wo) * 3
                if st != 1 or cin != f:
                    total += conv(f, cin, 1, ho, wo)
                cin = f
        total += 2 * se(f)
        hh, ww, c = ho, wo, f
    # context: bins 1 and 5 (512 -> 256), fuse 1024 -> 512
    total += conv(256, 512, 1, 1, 1) + conv(256, 512, 1, 5, 5)
    total += conv(512, 1024, 1, hh, ww)
    # semantic decoder
    cin = 512
    skips = {16: 256, 8: 128, 4: 64}
    for f, ds in zip((512, 256, 128), (16, 8, 4)):
        total += conv(f, cin, 9, hh, ww) + 3 * 4 * conv(f, f, 3, hh, ww)
        hh, ww = 2 * hh, 2 * ww
        total += conv(f, 1, 9, hh, ww) + conv(f, skips[ds], 1, hh, ww)
        cin = f
    total += conv(40, 128, 9, hh, ww)
    total += conv(40, 1, 9, 2 * hh, 2 * ww) + conv(40, 1, 9, 4 * hh, 4 * ww)
    return total


def test_model_flops_against_hand_count():
    from emsanet_tpu_torch.config import flagship_config
    from emsanet_tpu_torch.datasets.metadata import get_dataset_config
    from emsanet_tpu_torch.models.emsanet import EMSANet
    from harness.flops import forward_flops
    from harness.manifest import resolve

    cell = resolve("esanet-nyuv2.label-b32")
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cell.config["model"].items()}
    model = EMSANet(flagship_config(**fields), get_dataset_config("nyuv2"))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    h, w = 64, 96
    assert forward_flops(shapes, cell.config, h, w) == _hand_flops_esanet(h, w)


def test_fp8_rounding_is_coarser_than_bf16():
    from reference.emsanet import fp8_round

    x = torch.linspace(-3, 3, 1001)
    err8 = (fp8_round(x) - x).abs().max()
    err16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert 4 * err16 < err8 < 0.2
