"""The manifest resolves every cell's files by name, and a configuration,
a traffic mix and a per-layer metric added as files resolve with no
code edit."""

import json
import shutil
import sys

import pytest

import harness
from harness import manifest
from harness.trace import Trace


def test_every_cell_resolves():
    mani = manifest.load_manifest()
    for w in mani["workloads"]:
        cell = manifest.resolve(w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(harness.runner_for(cell.traffic["kind"]))
        assert cell.checks, f"{w['name']} has no limits"
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))


def test_manifest_names_files_that_exist():
    mani = manifest.load_manifest()
    for c in mani["configs"]:
        assert (manifest.ROOT / c["file"]).is_file()
        assert c["file"].startswith(mani["paths"][0] + "/")
    for m in mani["per_layer"]:
        assert (manifest.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in {x["name"] for x in mani["workloads"]}


def test_added_files_resolve_without_code_edit(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mani = manifest.load_manifest()
    cfg = json.loads((bench / "configs" /
                      "emsanet-r34-nbt1d-nyuv2.json").read_text())
    cfg["name"] = "extra-config"
    (bench / "configs" / "extra-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "label-b32.json").read_text())
    traffic.update(batch=8, in_flight=1)
    (bench / "traffic" / "extra-mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "extra_metric.label.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (bench / "checks" / "extra-config.extra-mix.json").write_text(
        json.dumps({"semantic_gap": {"limit": 1.0}}))
    mani["configs"].append({
        "name": "extra-config", "source": "https://example.org/x",
        "file": "benchmark/configs/extra-config.json", "reduced": [],
        "why": "added as files"})
    mani["workloads"].append({
        "name": "extra-config.extra-mix", "config": "extra-config",
        "traffic": "extra-mix", "chips": 1, "why": "added as files"})
    mani["per_layer"].append({
        "name": "extra_metric.label", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "frames_per_s",
        "workloads": ["extra-config.extra-mix"]})
    for m in mani["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("extra-config.extra-mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(mani))

    cell = manifest.resolve("extra-config.extra-mix", root=tmp_path,
                            bench_dir=bench)
    assert cell.traffic["batch"] == 8
    assert cell.config["name"] == "extra-config"
    assert cell.checks == {"semantic_gap": {"limit": 1.0}}
    assert [m["name"] for m in cell.per_layer] == ["extra_metric.label"]
    assert cell.reader("extra_metric.label")(None) == 42.0
    assert "frames_per_s" in {m["name"] for m in cell.end_to_end}


def test_a_traffic_kind_added_as_a_file_finds_its_runner(tmp_path,
                                                        monkeypatch):
    (tmp_path / "extra_kind.py").write_text(
        "def run(cell, seed, seconds, trace, device):\n    return 'ran'\n")
    monkeypatch.setattr(harness, "__path__",
                        [*harness.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "harness.extra_kind", raising=False)
    assert harness.runner_for("extra_kind")(None, 0, 0, False, "cpu") == "ran"
    with pytest.raises(ImportError):
        harness.runner_for("no_such_kind")


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        manifest.resolve("no-such-cell")


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _trace():
    """Two requests of a synthetic trace: each a model span holding an
    encoder span, a chain op, and kernels launched before, inside and
    after the model."""
    ev = [_event("user_annotation", "bench.window", 0, 1000)]
    corr = 0

    def kernel(launch, start, dur, name="k"):
        nonlocal corr
        corr += 1
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", launch, 1,
                         correlation=corr))
        ev.append(_event("kernel", name, start, dur, tid=7,
                         correlation=corr))

    for r, base in enumerate((0, 500)):
        ev.append(_event("user_annotation", "bench.request", base + 10, 400))
        ev.append(_event("user_annotation", "bench.model", base + 50, 200))
        ev.append(_event("user_annotation", "bench.encoder", base + 60, 90))
        ev.append(_event("cpu_op", "emsanet::nbt1d_chain", base + 70, 20,
                         **{"Input Dims": [[2, 4, 4, 64], [3, 2, 3, 64, 64]],
                            "Input type": ["c10::BFloat16", "float"]}))
        kernel(base + 20, base + 100, 10)        # prep
        kernel(base + 75, base + 120, 40, "chain")  # encoder, in the op
        kernel(base + 200, base + 170, 30)       # decoders
        kernel(base + 300, base + 300, 20)       # post
    ev.append(_event("gpu_memcpy", "Memcpy DtoH", 420, 30, tid=7))
    return Trace(ev)


def test_trace_attribution_and_device_time():
    from harness.layers import request_parts

    t = _trace()
    parts = request_parts(t)
    assert [len(parts[k]) for k in ("prep", "encoder", "decoders", "post")] \
        == [2, 2, 2, 2]
    assert Trace.device_us(parts["encoder"]) == 80
    chain = t.in_window_ops("emsanet::nbt1d_chain")
    assert [k["name"] for k in t.launched_in(chain)] == ["chain", "chain"]
    # kernels 10+40+30+20 per request, plus one 30 us memcpy that overlaps
    # nothing: busy 2 * 100 + 30 of the 1000 us window
    assert t.busy_us() == 230
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(770e-6)


def test_readers_on_a_synthetic_trace():
    t = _trace()
    cell = manifest.resolve("emsanet-nyuv2.label-b32")

    class Ctx:
        trace = t
        stats = {"host_ms": [10.0, 30.0], "items_per_s": 100.0,
                 "seconds": 1.0, "completed": 1000}
        peaks = {"bf16_flops": 1e15, "f32_flops": 1e14, "bytes_per_s": 1e12}
        requests = 2

        @staticmethod
        def flops_per_item():
            return 2e12

    read = cell.reader
    assert read("host_ms.label")(Ctx) == 20.0
    assert read("launches.label")(Ctx) == 4.0
    assert read("device_ms.encoders.label")(Ctx) == pytest.approx(0.05)
    assert read("device_ms.decoders.label")(Ctx) == pytest.approx(0.03)
    assert read("device_ms.postprocess.label")(Ctx) == pytest.approx(0.02)
    # busy 230 us of the 1000 us window
    assert read("idle_pct.label")(Ctx) == pytest.approx(77.0)
    assert read("mfu.label")(Ctx) == pytest.approx(20.0)
    # chain: x (2, 4, 4, 64), K = 3 blocks, bf16: ops 3*4*3*64^2*2*32 =
    # 9437184 (9.437 ns at 1e15/s); bytes 2*2*4*4*64*2 + 3*4*3*64^2*2 =
    # 303104 (303.1 ns at 1e12/s): bound by bytes, over 40 us a call
    assert read("nbt1d_chain_roofline")(Ctx) == pytest.approx(
        100 * 303104e-12 / 40e-6)


def test_busy_never_exceeds_the_window():
    """Device records that overlap one another, start before the window
    or end after it count once, and only inside the window."""
    ev = [_event("user_annotation", "bench.window", 100, 400)]
    for start, dur in ((0, 150), (120, 50), (140, 100), (450, 300),
                       (600, 10)):
        ev.append(_event("kernel", "k", start, dur, tid=7))
    ev.append(_event("gpu_memcpy", "Memcpy HtoD", 200, 30, tid=8))
    t = Trace(ev)
    # [100, 240) and [450, 500): 140 + 50 us
    assert t.busy_us() == 190
    assert 0 < t.busy_us() <= 400

    class Ctx:
        trace = t

    cell = manifest.resolve("emsanet-nyuv2.label-b32")
    assert cell.reader("idle_pct.label")(Ctx) == pytest.approx(52.5)


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    """The sweep gives each gap the innermost op open on the window's
    thread at its start, as a scan of every op does."""
    import random

    rng = random.Random(7)
    ev = [_event("user_annotation", "bench.window", 0, 10000)]
    ops = []

    def nest(a, b, depth):  # ops nested inside [a, b)
        t = a
        while t < b - 20 and depth < 4:
            dur = rng.randint(10, max(11, (b - t) // 2))
            ops.append(_event("cpu_op", f"op{depth}.{len(ops)}", t, dur))
            nest(t + 1, t + dur - 1, depth + 1)
            t += dur + rng.randint(0, 30)

    nest(0, 10000, 0)
    ev += ops
    t = 0
    while t < 10000:
        dur = rng.randint(5, 60)
        ev.append(_event("kernel", "k", t, dur, tid=7))
        t += dur + rng.randint(1, 80)
    trace = Trace(ev)
    want = {}
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace.device)
    at = 0
    for s_, t_ in [*busy, (10000, 10000)]:
        if s_ > at:
            inside = [e for e in ops if e["ts"] <= at < e["ts"] + e["dur"]]
            label = (min(inside, key=lambda e: e["dur"])["name"] if inside
                     else "host: outside any op")
            want[label] = want.get(label, 0.0) + (min(s_, 10000) - at)
        at = max(at, t_)
    top = sorted(want.items(), key=lambda kv: -kv[1])[:10]
    assert trace.idle_gaps() == [[k, pytest.approx(v / 1e6)] for k, v in top]
