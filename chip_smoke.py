#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build: compile every kernel of `emsanet_tpu_torch/csrc` (one nvcc per
     source, all at once).
  2. main path: the flagship frame (R34-NBt1D dual encoder, semantic +
     instance + orientation + scene, panoptic; 640x480, bf16, random
     weights from a seed; raw uint8/uint16 inputs -> device prep ->
     forward -> postprocess) at batch 1 and batch 8, with every launch
     counter set to 0 just before and read just after; each kernel must
     have launched. The kernels' inputs are captured on the way.
  3. kernels vs plain: every kernel against its plain PyTorch version on
     the captured inputs, in bf16 and again in f32 (TF32 off), with the
     tolerances below.
  4. outputs: finite values of the expected shapes, and a small frame
     (96x128, R18, f32) on the card agrees with the same frame run by the
     plain versions on the CPU.
  5. timing: frames at b1 and b8, and each kernel, its plain version and
     its library yardstick, with CUDA events.
  6. profile: one frame at b1 and one at b8 under torch.profiler; device
     time by kernel name and the device's busy share of the frame's wall
     time
     (chiprun_out/chip_smoke_profile.txt).

Tolerances (error relative to the largest magnitude of the plain
result): stem bf16 2e-2, f32 1e-4; NBt1D chain bf16 5e-2 (K blocks; the
plain version rounds every conv output to bf16, the kernel only the
conv pair's intermediate), f32 1e-4; grouping index and distance
bit-exact; histogram exact; vector sums 1e-4 (f32 atomics in varying
order); lookup exact.

Output: progress lines, the card's name and power limit, one JSON line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor, f32 FMA
BATCHES = (1, 8)
KERNELS = (
    ("fused_stems", "stem", "emsanet_tpu_torch/csrc/stem.cu",
     "emsanet_tpu/ops/stem.py:348"),
    ("nbt1d_chain", "nbt1d_chain", "emsanet_tpu_torch/csrc/nbt1d_chain.cu",
     "emsanet_tpu/ops/nbt1d_chain.py:434"),
    ("group_pixels_argmin", "grouping", "emsanet_tpu_torch/csrc/grouping.cu",
     "emsanet_tpu/ops/grouping.py:99"),
    ("segment_hist_and_sums", "segment_kernels",
     "emsanet_tpu_torch/csrc/segment.cu",
     "emsanet_tpu/ops/segment_pallas.py:102"),
    ("segment_lookup", "segment_kernels", "emsanet_tpu_torch/csrc/segment.cu",
     "emsanet_tpu/ops/segment_pallas.py:165"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# capture of the kernels' inputs on the main path


class Capture:
    """Wraps each kernel wrapper (module attribute) to record its inputs."""

    def __init__(self, modules):
        self.modules = modules
        self.calls = {name: [] for name, *_ in KERNELS}
        self._orig = {}

    def __enter__(self):
        for name, mod, *_ in KERNELS:
            m = self.modules[mod]
            orig = getattr(m, name)
            self._orig[name] = (m, orig)

            def wrapped(*args, __orig=orig, __name=name, **kwargs):
                self.calls[__name].append((args, kwargs))
                return __orig(*args, **kwargs)

            setattr(m, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (m, orig) in self._orig.items():
            setattr(m, name, orig)


def counts(modules):
    return {name: getattr(modules[mod], name).launches
            for name, mod, *_ in KERNELS}


def reset_counts(modules):
    for name, mod, *_ in KERNELS:
        getattr(modules[mod], name).launches = 0


# ---------------------------------------------------------------------------
# per-kernel work: plain version, bytes and operations of one call


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_spec(name, args, kwargs, ops_mod):
    """(kernel_fn, plain_fn, library_fn or None, bytes, ops, ops dtype)."""
    import torch

    stem, chain, grouping, seg = ops_mod
    if name == "fused_stems":
        xs, ws, bns = args
        outs_b = sum(x.shape[0] * ((x.shape[1] + 3) // 4)
                     * ((x.shape[2] + 3) // 4) * 64 * x.element_size()
                     for x in xs)
        ops = sum(2 * 64 * x.shape[3] * 49 * x.shape[0]
                  * ((x.shape[1] + 1) // 2) * ((x.shape[2] + 1) // 2)
                  for x in xs)
        byts = _nbytes(*xs) + sum(w.numel() * 4 for w in ws) + outs_b
        return (lambda: stem.fused_stems(xs, ws, bns),
                lambda: stem.fused_stems_plain(xs, ws, bns), None,
                byts, ops, str(xs[0].dtype).split(".")[1])
    if name == "nbt1d_chain":
        x, st = args
        n, h, w, c = x.shape
        k = st["w31"].shape[0]
        byts = 2 * _nbytes(x) + k * 4 * 3 * c * c * x.element_size()
        ops = k * 4 * 3 * c * c * 2 * n * h * w
        return (lambda: chain.nbt1d_chain(x, st),
                lambda: chain.nbt1d_chain_plain(x, st), None,
                byts, ops, str(x.dtype).split(".")[1])
    if name == "group_pixels_argmin":
        voted, centers, valid = args
        n, p, _ = voted.shape
        kk = centers.shape[1]
        byts = _nbytes(voted, centers, valid) + n * p * 8
        return (lambda: grouping.group_pixels_argmin(voted, centers, valid),
                lambda: grouping.group_pixels_argmin_plain(voted, centers,
                                                           valid),
                None, byts, n * p * kk * 6, "float32")
    if name == "segment_hist_and_sums":
        inst, sem, w, vec = args[:4]
        s = kwargs["num_segments"]
        c = kwargs["num_classes"]
        n, p = inst.shape
        d = vec.shape[-1]
        byts = _nbytes(inst, sem, w, vec) + n * s * (c + d) * 4
        # yardstick: one index_add_ into a flat (N*S*(C+D)) table, the
        # weight at column sem and vector component j at column C+j of row
        # n*S+inst; the flat indices are built here, outside the timing
        rows = ((torch.arange(n, device=inst.device)[:, None] * s
                 + inst.long()) * (c + d)).reshape(-1)
        flat = torch.cat([rows + sem.long().reshape(-1)]
                         + [rows + c + j for j in range(d)])
        vals = torch.cat([w.reshape(-1)] + [vec[..., j].reshape(-1)
                                            for j in range(d)])
        table = torch.zeros(n * s * (c + d), device=inst.device)
        return (lambda: seg.segment_hist_and_sums(inst, sem, w, vec, s, c),
                lambda: seg.segment_hist_and_sums_plain(inst, sem, w, vec, s,
                                                        c),
                lambda: table.index_add_(0, flat, vals),
                byts, n * p * (1 + d), "float32")
    if name == "segment_lookup":
        inst, tables = args
        n, p = inst.shape
        d = tables.shape[1]
        index = inst.long()[:, None, :].expand(n, d, p).contiguous()
        byts = _nbytes(inst, tables) + n * d * p * 4
        return (lambda: seg.segment_lookup(inst, tables),
                lambda: seg.segment_lookup_plain(inst, tables),
                lambda: torch.gather(tables, 2, index), byts, 0, "float32")
    raise KeyError(name)


def rel_err(a, b):
    a = a.float()
    b = b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def compare(name, args, kwargs, ops_mod, dtype_label):
    """Kernel vs plain on one call's inputs: (relative error, largest
    absolute difference); raises on disagreement."""
    import torch

    kfn, pfn, *_ = kernel_spec(name, args, kwargs, ops_mod)
    got, want = kfn(), pfn()
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [
        (got, want)]
    abs_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in pairs)
    if name == "fused_stems":
        tol = 2e-2 if dtype_label == "bf16" else 1e-4
        err = max(rel_err(g, w) for g, w in zip(got, want))
    elif name == "nbt1d_chain":
        tol = 5e-2 if dtype_label == "bf16" else 1e-4
        err = rel_err(got, want)
    elif name == "group_pixels_argmin":
        tol = 0.0
        err = 0.0 if (torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1])) else 1.0
    elif name == "segment_hist_and_sums":
        tol = 1e-4
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{name}: histogram differs")
        err = rel_err(got[1], want[1])
    else:
        tol = 0.0
        err = 0.0 if torch.equal(got, want) else 1.0
    if not err <= tol:
        raise AssertionError(f"{name} ({dtype_label}): error {err:.3e} > "
                             f"tolerance {tol:.1e}")
    return err, abs_err


def to_f32(name, args):
    """The same call's inputs with the activations in f32."""
    import torch

    if name == "fused_stems":
        xs, ws, bns = args
        return ([x.float() for x in xs], ws, bns)
    if name == "nbt1d_chain":
        x, st = args
        return (x.float(), {k: v.float() for k, v in st.items()})
    return args


# ---------------------------------------------------------------------------


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from emsanet_tpu_torch.bench import (
            build_flagship,
            make_frame,
            random_raw_inputs,
            time_cuda,
        )
        from emsanet_tpu_torch.ops import (
            _native,
            grouping,
            nbt1d_chain,
            segment_kernels,
            stem,
        )
    except ImportError as e:
        print(f"chip_smoke: the emsanet_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)  # parameters reach the plain versions
    modules = {"stem": stem, "nbt1d_chain": nbt1d_chain,
               "grouping": grouping, "segment_kernels": segment_kernels}
    ops_mod = (stem, nbt1d_chain, grouping, segment_kernels)
    os.makedirs(OUT_DIR, exist_ok=True)
    card = gpu_name_and_limit()
    t_start = time.time()

    # -- 1. build ----------------------------------------------------------
    t0 = time.time()
    logs = _native.build_all()
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for src, text in logs.items():
            f.write(f"== {src}\n{text}\n")
    log(f"[build] {len(_native.SOURCES)} kernel sources in "
        f"{time.time() - t0:.1f} s")

    # -- 2. main path ------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg, ds = build_flagship(480, 640, "bfloat16", "resnet34",
                                    "cuda", seed=0)
    frame = make_frame(model, cfg, ds)
    inputs = {b: random_raw_inputs(b, 480, 640, seed=b, device="cuda")
              for b in BATCHES}
    for b in BATCHES:  # warm-up: lazy init, cuDNN heuristics
        frame(inputs[b])
    torch.cuda.synchronize()

    reset_counts(modules)
    results = {}
    with Capture(modules) as cap:
        for b in BATCHES:
            results[b] = frame(inputs[b])
        torch.cuda.synchronize()
    launches = counts(modules)
    log(f"[main path] launches per kernel over b1 + b8 frames: "
        f"{json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    captured = {name: [] for name in cap.calls}
    for name, calls in cap.calls.items():
        half = len(calls) // len(BATCHES)  # calls of the b1 frame first
        per_batch = {1: calls[:half], 8: calls[half:]}
        captured[name] = per_batch

    # -- 4a. outputs of the flagship frames -------------------------------
    for b, res in results.items():
        for key, v in res.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"b{b}: non-finite values in {key}")
        for key, shape in (("semantic_segmentation_idx", (b, 480, 640)),
                           ("panoptic_segmentation_deeplab", (b, 480, 640)),
                           ("instance_centers_yx", (b, 64, 2)),
                           ("scene_class_idx", (b,))):
            if tuple(res[key].shape) != shape:
                raise AssertionError(f"b{b}: {key} has shape "
                                     f"{tuple(res[key].shape)}, not {shape}")
    r8 = results[8]
    log(f"[outputs] b8: valid centers per image "
        f"{r8['instance_centers_valid'].sum(1).tolist()}, instance pixel "
        f"share {float((r8['instance_segmentation'] > 0).float().mean()):.3f}"
        f", classes seen {int(r8['semantic_segmentation_idx'].unique().numel())}")

    # -- 3. kernels vs plain on the captured inputs ------------------------
    errors = {}
    max_abs = {name: 0.0 for name, *_ in KERNELS}  # b8 in bf16, for JSON
    for name, *_ in KERNELS:
        for b in BATCHES:
            for args, kwargs in captured[name][b]:
                for label, a in (("bf16", args),
                                 ("f32", to_f32(name, args))):
                    err, abs_err = compare(name, a, kwargs, ops_mod, label)
                    key = f"{name}/{label}"
                    errors[key] = max(errors.get(key, 0.0), err)
                    if b == 8 and label == "bf16":
                        max_abs[name] = max(max_abs[name], abs_err)
    log(f"[kernels vs plain] max relative errors: {json.dumps(errors)}")

    # -- 4b. small frame: card (kernels, f32) vs CPU (plain versions) ------
    small_cuda, scfg, sds = build_flagship(96, 128, "float32", "resnet18",
                                           "cuda", seed=1)
    small_cpu, _, _ = build_flagship(96, 128, "float32", "resnet18", "cpu",
                                     seed=1)
    sin = random_raw_inputs(2, 96, 128, seed=3, device="cpu")
    out_cuda = make_frame(small_cuda, scfg, sds, False)(
        {k: v.cuda() for k, v in sin.items()})
    out_cpu = make_frame(small_cpu, scfg, sds, False)(sin)
    worst = 0.0
    for task in ("semantic", "instance", "scene"):
        for key, v in out_cpu[task].items():
            if key == "side_outputs":
                continue
            worst = max(worst, rel_err(out_cuda[task][key].cpu(), v))
    if worst > 1e-3:
        raise AssertionError(f"small frame: card vs CPU error {worst:.3e}")
    post_cuda = make_frame(small_cuda, scfg, sds)(
        {k: v.cuda() for k, v in sin.items()})
    post_cpu = make_frame(small_cpu, scfg, sds)(sin)
    for key in ("semantic_segmentation_idx", "instance_segmentation",
                "panoptic_segmentation_deeplab"):
        agree = float((post_cuda[key].cpu() == post_cpu[key]).float().mean())
        if agree < 0.99:
            raise AssertionError(f"small frame: {key} agrees on only "
                                 f"{agree:.4f} of the pixels")
    log(f"[outputs] small frame card vs CPU: raw outputs max rel err "
        f"{worst:.2e}; postprocessed maps agree")

    # -- 5. timing ---------------------------------------------------------
    frame_ms = {}
    for b in BATCHES:
        frame_ms[b] = time_cuda(lambda: frame(inputs[b]), 3, 20)
    log(f"[frame] ms per batch: b1 {frame_ms[1]:.3f}, b8 {frame_ms[8]:.3f} "
        f"({frame_ms[8] / 8:.3f} per frame)")

    entries = []
    detail = {}
    for name, _, source, replaces in KERNELS:
        per_b = {}
        for b in BATCHES:
            calls = captured[name][b]
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": None, "bound_by": None}
            sites = []
            for args, kwargs in calls:
                kfn, pfn, lfn, byts, ops, odt = kernel_spec(
                    name, args, kwargs, ops_mod)
                ms = time_cuda(kfn, 2, 10)
                plain = time_cuda(pfn, 2, 10)
                t_bytes = byts / PEAK_BYTES * 1e3
                t_ops = ops / PEAK_OPS[odt] * 1e3
                bound = max(t_bytes, t_ops)
                tot["ms"] += ms
                tot["plain_ms"] += plain
                tot["bound_ms"] += bound
                by = "bytes" if t_bytes >= t_ops else "operations"
                tot["bound_by"] = by if tot["bound_by"] in (None, by) else (
                    "operations")
                if lfn is not None:
                    lib = time_cuda(lfn, 2, 10)
                    tot["library_ms"] = (tot["library_ms"] or 0.0) + lib
                if name == "nbt1d_chain":
                    x = args[0]
                    sites.append({"shape": list(x.shape),
                                  "K": int(args[1]["w31"].shape[0]),
                                  "ms": ms, "plain_ms": plain,
                                  "bound_ms": bound})
            per_b[b] = dict(tot, calls=len(calls), sites=sites)
        detail[name] = per_b
        b8 = per_b[8]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_abs[name], "ms": b8["ms"],
            "plain_ms": b8["plain_ms"],
            "bound_ms": b8["bound_ms"], "bound_by": b8["bound_by"],
            "library_ms": b8["library_ms"],
        })
    for name, per_b in detail.items():
        b1 = per_b[1]
        log(f"[kernel b1] {name}: ms {b1['ms']:.4f} plain {b1['plain_ms']:.4f}"
            f" bound {b1['bound_ms']:.4f} calls {b1['calls']}")
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": card, "frame_ms": frame_ms, "detail": detail,
                   "launches": launches, "errors": errors}, f, indent=1)
    # -- 6. profile ----------------------------------------------------------
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"{card}\n")
        for b in BATCHES:
            wall_ms, rows = profile_frame(frame, inputs[b])
            busy_ms = sum(r[0] for r in rows)
            f.write(f"b{b} frame under torch.profiler: wall {wall_ms:.3f} ms,"
                    f" device busy {busy_ms:.3f} ms\n")
            for ms, count, key in rows:
                f.write(f"{ms:10.4f} ms {count:6d}x  {key}\n")
            top = ", ".join(f"{key[:48]} {ms:.3f}" for ms, _, key in rows[:6])
            log(f"[profile b{b}] wall {wall_ms:.3f} ms, device busy "
                f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%); top "
                f"kernels (ms): {top}" if busy_ms > 0 else
                f"[profile b{b}] no device time recorded: not measured")
    log(f"[done] {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_frame(frame, batch):
    """(wall ms, [(device ms, count, kernel name)]) of one frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return wall_ms, sorted(rows, reverse=True)


def main() -> int:
    try:
        return run()
    except Exception:  # report the failing phase, exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
