#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build: compile every kernel of `emsanet_tpu_torch/csrc` (one nvcc per
     source, all at once).
  2. main path, per head mode (`interleave`, `decode`, `decode-both`,
     `decode-planes`): the flagship frame (R34-NBt1D dual encoder,
     semantic + instance + orientation + scene, panoptic; 640x480, bf16,
     random weights from seed 0; raw uint8/uint16 inputs -> device prep ->
     forward -> postprocess) at batch 1 and batch 8, with every launch
     counter set to 0 just before the mode's two frames and read just
     after; each kernel on the mode's path must have launched. The
     kernels' inputs are captured on the way.
  3. kernels vs plain: every kernel against its plain PyTorch version on
     the captured inputs of every mode, in bf16 and again in f32 (TF32
     off), with the tolerances below.
  4. outputs: finite values of the expected shapes; a small frame (96x128,
     R18, f32; no head defers there) and a 128x160 R18 f32 frame in
     `decode-planes` and in `decode-both` (the heads defer: the final x2
     stage's input, 64x80, passes the 60*80 polyphase gate) on the card
     agree with the same frames run by the plain versions on the CPU, on
     at least 0.99 of the pixels of each postprocessed map. Logged, not
     gated: the share of b8 pixels (and of center slots) where the
     `decode*` modes and `interleave` agree. They may legitimately differ:
     the random weights saturate the center heatmap, and its tied
     plateaus break by mode (bf16 or f32 sigmoid, row-major or
     parity-major top-k order).
  5. timing: each mode's frame at b1 and b8 (the median of 5 rounds over
     the modes in turn), and each kernel, its plain version and its
     library yardstick, with CUDA events, on the captured
     inputs of `decode-planes` (the mode `emsanet_tpu_torch.bench` picks
     below batch 16); the interleaved variants of the semantic decode and
     instance head kernels on those of `decode` / `decode-both`.
  6. profile: each mode's frame at b1 and at b8 under torch.profiler;
     device time by kernel name, the device's busy share of the profiled
     and of the timed frame, and whether ATen's depthwise conv kernel
     still runs
     (chiprun_out/chip_smoke_profile.txt).

Tolerances (error relative to the largest magnitude of the plain result
unless stated): stem bf16 2e-2, f32 1e-4; NBt1D chain bf16 5e-2 (K
blocks; the plain version rounds every conv output to bf16, the kernel
only the conv pair's intermediate), f32 1e-4; grouping index and
distance bit-exact; histogram exact; vector sums 1e-4 (f32 atomics in
varying order); lookup exact; semantic decode f32 index exact and score
1e-5 relative, bf16 index different on at most 1e-4 of the pixels and
only where the plain version's top two values are within one bf16 ulp,
score 1e-2 absolute where the index agrees; instance head f32 1e-5, bf16
2e-2; plane interleave bit-exact.

Output: progress lines, the card's name and power limit, one JSON line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor, f32 FMA
BATCHES = (1, 8)
MODES = ("interleave", "decode", "decode-both", "decode-planes")
TIMING_MODE = "decode-planes"
FRAME_ROUNDS = 5
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
    ("semantic_decode", "semantic_decode",
     "emsanet_tpu_torch/csrc/semantic_decode.cu",
     "emsanet_tpu/ops/semantic_decode.py:311"),
    ("instance_head", "instance_head",
     "emsanet_tpu_torch/csrc/instance_head.cu",
     "emsanet_tpu/ops/instance_head.py:289"),
    ("interleave_planes", "plane_interleave",
     "emsanet_tpu_torch/csrc/plane_interleave.cu",
     "emsanet_tpu/ops/plane_interleave.py:85"),
)
COMMON = {"fused_stems", "nbt1d_chain", "group_pixels_argmin",
          "segment_hist_and_sums", "segment_lookup"}
PATH_KERNELS = {  # the kernels each mode's frame must launch
    "interleave": COMMON,
    "decode": COMMON | {"semantic_decode"},
    "decode-both": COMMON | {"semantic_decode", "instance_head"},
    "decode-planes": COMMON | {"semantic_decode", "instance_head",
                               "interleave_planes"},
}
NEW_KERNELS = {"semantic_decode", "instance_head", "interleave_planes"}


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


def _words(named):
    """The maps that `interleave_planes` sends through its kernel."""
    import torch

    return [x for x in named.values()
            if x.dtype in (torch.float32, torch.int32) and x.shape[-1] >= 2]


def kernel_spec(name, args, kwargs, ops_mod):
    """(kernel_fn, plain_fn, library_fn or None, bytes, ops, ops dtype)."""
    import torch
    import torch.nn.functional as F

    stem, chain, grouping, seg, sdec, ihead, pint = ops_mod
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
    if name == "semantic_decode":
        x, weight, interleaved = args
        n, h2, w2, c = x.shape
        byts = _nbytes(x, weight) + n * 4 * h2 * w2 * 8  # idx + score
        # per output pixel and class: 4 taps (8), max + argmax (1),
        # subtract + exp + add (3)
        plain = (sdec.semantic_decode_interleaved_plain if interleaved
                 else sdec.semantic_decode_planes_plain)
        return (lambda: sdec.semantic_decode(x, weight, interleaved),
                lambda: plain(x, weight), None,
                byts, n * 4 * h2 * w2 * c * 12, "float32")
    if name == "instance_head":
        x, weight, enc, interleaved = args
        n, h2, w2, c = x.shape
        byts = _nbytes(x, weight) + n * c * 4 * h2 * w2 * 4
        plain = (ihead.instance_head_upsample_interleaved_plain if interleaved
                 else ihead.instance_head_upsample_plain)
        # per output element: 4 taps (8) and the encode (~4)
        return (lambda: ihead.instance_head(x, weight, enc, interleaved),
                lambda: plain(x, weight, enc), None,
                byts, n * c * 4 * h2 * w2 * 12, "float32")
    if name == "interleave_planes":
        (named,) = args
        words = _words(named)
        return (lambda: pint.interleave_planes(named),
                lambda: pint.interleave_planes_plain(named),
                lambda: [F.pixel_shuffle(x, 2) for x in words],
                2 * _nbytes(*words), 0, "float32")
    raise KeyError(name)


def rel_err(a, b):
    a = a.float()
    b = b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _semantic_decode_error(got, want, args, dtype_label):
    """Checks the semantic decode tolerance; returns (worst relative
    score error where the index agrees, share of pixels whose index
    differs, largest absolute score difference where it agrees)."""
    from emsanet_tpu_torch.ops.semantic_decode import bf16_near_ties

    (gi, gs), (wi, ws) = got, want
    same = gi == wi
    differ = float((~same).float().mean())
    d = (gs - ws).abs()
    abs_err = float(d[same].max()) if bool(same.any()) else 0.0
    rel = float((d / ws.abs().clamp_min(1e-30))[same].max()) if bool(
        same.any()) else 0.0
    name = f"semantic_decode ({dtype_label})"
    if dtype_label == "f32":
        if differ > 0:
            raise AssertionError(f"{name}: index differs on {differ:.2e} of "
                                 "the pixels")
        if rel > 1e-5:
            raise AssertionError(f"{name}: score error {rel:.2e} > 1e-5")
    else:
        if differ > 1e-4:
            raise AssertionError(f"{name}: index differs on {differ:.2e} of "
                                 "the pixels (> 1e-4)")
        x, weight, interleaved = args
        if bool((~same & ~bf16_near_ties(x, weight, interleaved)).any()):
            raise AssertionError(f"{name}: index differs where the top two "
                                 "values are more than one bf16 ulp apart")
        if abs_err > 1e-2:
            raise AssertionError(f"{name}: score error {abs_err:.2e} > 1e-2")
    return rel, differ, abs_err


def compare(name, args, kwargs, ops_mod, dtype_label):
    """Kernel vs plain on one call's inputs: (error, largest absolute
    difference); raises on disagreement."""
    import torch

    kfn, pfn, *_ = kernel_spec(name, args, kwargs, ops_mod)
    got, want = kfn(), pfn()
    torch.cuda.synchronize()
    if name == "semantic_decode":
        rel, differ, abs_err = _semantic_decode_error(got, want, args,
                                                      dtype_label)
        return max(rel, differ), abs_err
    if name == "interleave_planes":
        for key in want:
            g, w = got[key], want[key]
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                raise AssertionError(f"interleave_planes: map {key} differs")
        return 0.0, 0.0
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
    elif name == "instance_head":
        tol = 2e-2 if dtype_label == "bf16" else 1e-5
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
    if name == "fused_stems":
        xs, ws, bns = args
        return ([x.float() for x in xs], ws, bns)
    if name == "nbt1d_chain":
        x, st = args
        return (x.float(), {k: v.float() for k, v in st.items()})
    if name in ("semantic_decode", "instance_head"):
        return (args[0].float(), args[1].float(), *args[2:])
    return args


def _call_args(name, args, kwargs):
    """A captured call's (args, kwargs), with the variant flag of the
    semantic decode and instance head wrappers (`interleaved`) made the
    last positional argument."""
    if name not in ("semantic_decode", "instance_head"):
        return args, kwargs
    n_fixed = 2 if name == "semantic_decode" else 3
    flag = kwargs.get("interleaved",
                      args[n_fixed] if len(args) > n_fixed else False)
    return (*args[:n_fixed], flag), {}


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
            instance_head,
            nbt1d_chain,
            plane_interleave,
            segment_kernels,
            semantic_decode,
            stem,
        )
    except ImportError as e:
        print(f"chip_smoke: the emsanet_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)  # parameters reach the plain versions
    modules = {"stem": stem, "nbt1d_chain": nbt1d_chain,
               "grouping": grouping, "segment_kernels": segment_kernels,
               "semantic_decode": semantic_decode,
               "instance_head": instance_head,
               "plane_interleave": plane_interleave}
    ops_mod = (stem, nbt1d_chain, grouping, segment_kernels, semantic_decode,
               instance_head, plane_interleave)
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

    # -- 2. main path, 3. kernels vs plain: mode by mode --------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = {b: random_raw_inputs(b, 480, 640, seed=b, device="cuda")
              for b in BATCHES}
    frames, results, launches = {}, {}, {}
    total = {name: 0 for name, *_ in KERNELS}
    errors = {}
    max_abs = {name: 0.0 for name, *_ in KERNELS}  # b8 bf16, timing mode
    captured = {}  # (mode, name, b) -> calls, kept for the timing phase
    for mode in MODES:
        model, cfg, ds = build_flagship(480, 640, "bfloat16", "resnet34",
                                        "cuda", seed=0,
                                        head_decode_fusion=mode)
        frame = make_frame(model, cfg, ds)
        frames[mode] = frame
        for b in BATCHES:  # warm-up: lazy init, cuDNN heuristics
            frame(inputs[b])
        torch.cuda.synchronize()

        reset_counts(modules)
        calls = {}
        results[mode] = {}
        for b in BATCHES:
            with Capture(modules) as cap:
                results[mode][b] = frame(inputs[b])
            calls[b] = cap.calls
        torch.cuda.synchronize()
        launches[mode] = counts(modules)
        log(f"[main path {mode}] launches over the b1 + b8 frames: "
            f"{json.dumps(launches[mode])}")
        for name in PATH_KERNELS[mode]:
            if launches[mode][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"main path of mode {mode}")
        for name, n in launches[mode].items():
            total[name] += n

        for name, *_ in KERNELS:
            for b in BATCHES:
                mode_calls = [_call_args(name, a, k)
                              for a, k in calls[b][name]]
                for args, kwargs in mode_calls:
                    for label, a in (("bf16", args),
                                     ("f32", to_f32(name, args))):
                        err, abs_err = compare(name, a, kwargs, ops_mod,
                                               label)
                        key = f"{name}/{label}"
                        errors[key] = max(errors.get(key, 0.0), err)
                        if (b == 8 and label == "bf16"
                                and mode == TIMING_MODE):
                            max_abs[name] = max(max_abs[name], abs_err)
                if mode == TIMING_MODE or name in NEW_KERNELS:
                    captured[mode, name, b] = mode_calls
        del calls
        check_outputs(results[mode], mode)
    log(f"[kernels vs plain] worst errors: {json.dumps(errors)}")

    r8 = results[TIMING_MODE][8]
    log(f"[outputs] {TIMING_MODE} b8: valid centers per image "
        f"{r8['instance_centers_valid'].sum(1).tolist()}, instance pixel "
        f"share {float((r8['instance_segmentation'] > 0).float().mean()):.3f}"
        f", classes seen {int(r8['semantic_segmentation_idx'].unique().numel())}")
    agreement = {}
    for mode, other in [(m, "interleave") for m in MODES[1:]] + [
            ("decode-planes", "decode-both")]:
        agreement[f"{mode} vs {other}"] = _agreement(results[mode][8],
                                                     results[other][8])
    log(f"[outputs] b8 share of pixels (and of center slots) that agree "
        f"(logged, not gated): {json.dumps(agreement)}")

    # -- 4. small frames: card (kernels, f32) vs CPU (plain versions) ------
    small = small_frames(torch, build_flagship, make_frame, random_raw_inputs)

    # -- 5. timing ---------------------------------------------------------
    # rounds over the modes in turn, so that a slow spell of the shared
    # host does not fall on one mode only; the median round is reported
    rounds = {(mode, b): [] for mode in MODES for b in BATCHES}
    for _ in range(FRAME_ROUNDS):
        for mode in MODES:
            for b in BATCHES:
                rounds[mode, b].append(time_cuda(
                    lambda: frames[mode](inputs[b]), 2, 10))
    frame_ms = {mode: {b: statistics.median(rounds[mode, b])
                       for b in BATCHES} for mode in MODES}
    for mode in MODES:
        log(f"[frame {mode}] ms per batch, median of {FRAME_ROUNDS} rounds "
            f"of 10: b1 {frame_ms[mode][1]:.3f} "
            f"({min(rounds[mode, 1]):.3f}-{max(rounds[mode, 1]):.3f}), b8 "
            f"{frame_ms[mode][8]:.3f} ({min(rounds[mode, 8]):.3f}-"
            f"{max(rounds[mode, 8]):.3f}; {frame_ms[mode][8] / 8:.3f} per "
            "frame)")

    entries = []
    detail = {}
    for name, _, source, replaces in KERNELS:
        per_b = {}
        for mode in MODES:
            for b in BATCHES:
                calls = captured.get((mode, name, b))
                if not calls:
                    continue
                variants = {}
                for args, kwargs in calls:
                    kfn, pfn, lfn, byts, ops, odt = kernel_spec(
                        name, args, kwargs, ops_mod)
                    key = _variant(name, args)
                    tot = variants.setdefault(key, {
                        "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": None, "bound_by": None, "calls": 0,
                        "sites": []})
                    ms = time_cuda(kfn, 2, 10)
                    plain = time_cuda(pfn, 2, 10)
                    t_bytes = byts / PEAK_BYTES * 1e3
                    t_ops = ops / PEAK_OPS[odt] * 1e3
                    bound = max(t_bytes, t_ops)
                    tot["ms"] += ms
                    tot["plain_ms"] += plain
                    tot["bound_ms"] += bound
                    tot["calls"] += 1
                    by = "bytes" if t_bytes >= t_ops else "operations"
                    tot["bound_by"] = by if tot["bound_by"] in (None, by) \
                        else "operations"
                    if lfn is not None:
                        lib = time_cuda(lfn, 2, 10)
                        tot["library_ms"] = (tot["library_ms"] or 0.0) + lib
                    if name == "nbt1d_chain":
                        x = args[0]
                        tot["sites"].append({
                            "shape": list(x.shape),
                            "K": int(args[1]["w31"].shape[0]), "ms": ms,
                            "plain_ms": plain, "bound_ms": bound})
                for key, tot in variants.items():
                    per_b[f"{mode}/b{b}/{key}"] = tot
        detail[name] = per_b
        b8 = [t for k, t in per_b.items()
              if k.startswith(f"{TIMING_MODE}/b8/")][0]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total[name],
            "max_abs_err": max_abs[name], "ms": b8["ms"],
            "plain_ms": b8["plain_ms"],
            "bound_ms": b8["bound_ms"], "bound_by": b8["bound_by"],
            "library_ms": b8["library_ms"],
        })
    for name, per_b in detail.items():
        for key, t in per_b.items():
            if "/b8/" in key and not key.startswith(TIMING_MODE):
                log(f"[kernel {key}] {name}: ms {t['ms']:.4f} plain "
                    f"{t['plain_ms']:.4f} bound {t['bound_ms']:.4f}")
            if key.startswith(f"{TIMING_MODE}/b1/"):
                log(f"[kernel b1] {name}: ms {t['ms']:.4f} plain "
                    f"{t['plain_ms']:.4f} bound {t['bound_ms']:.4f} calls "
                    f"{t['calls']}")

    # -- 6. profile ----------------------------------------------------------
    busy = {}
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"{card}\n")
        for mode in MODES:
            for b in BATCHES:
                wall_ms, rows = profile_frame(frames[mode], inputs[b])
                busy_ms = sum(r[0] for r in rows)
                depthwise = sum(r[0] for r in rows
                                if "conv_depthwise2d" in r[2])
                busy[f"{mode}/b{b}"] = {"wall_ms": wall_ms,
                                        "busy_ms": busy_ms,
                                        "depthwise_ms": depthwise,
                                        "frame_ms": frame_ms[mode][b]}
                f.write(f"{mode} b{b} frame under torch.profiler: wall "
                        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
                        f"ATen conv_depthwise2d {depthwise:.3f} ms\n")
                for ms, count, key in rows:
                    f.write(f"{ms:10.4f} ms {count:6d}x  {key}\n")
                top = ", ".join(f"{key[:40]} {ms:.3f}"
                                for ms, _, key in rows[:5])
                log(f"[profile {mode} b{b}] wall {wall_ms:.3f} ms, device "
                    f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% "
                    f"of the profiled frame, "
                    f"{100 * busy_ms / frame_ms[mode][b]:.1f}% of the timed "
                    f"one), conv_depthwise2d {depthwise:.3f} ms; top kernels "
                    f"(ms): {top}" if busy_ms > 0 else
                    f"[profile {mode} b{b}] no device time recorded: not "
                    "measured")
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": card, "frame_ms": frame_ms, "detail": detail,
                   "launches": launches, "errors": errors,
                   "agreement_b8": agreement,
                   "small_frames": small, "profile": busy}, f, indent=1)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _variant(name, args):
    if name in ("semantic_decode", "instance_head"):
        return "interleaved" if args[-1] else "planes"
    return "all"


def _agreement(a, b):
    """Share of equal pixels per map, of center slots with the same
    validity and position, and of distinct scores among the valid
    centers (tied center scores make the top-k order, and so the instance
    ids, differ between modes)."""
    share = {key: float((a[key] == b[key]).float().mean())
             for key in ("semantic_segmentation_idx", "instance_segmentation",
                         "panoptic_segmentation_deeplab")}
    same = (a["instance_centers_valid"] == b["instance_centers_valid"]) & (
        (a["instance_centers_yx"] == b["instance_centers_yx"]).all(-1)
        | ~a["instance_centers_valid"])
    share["center_slots"] = float(same.float().mean())
    for tag, res in (("a", a), ("b", b)):
        scores = res["instance_centers_score"][res["instance_centers_valid"]]
        share[f"distinct_center_scores_{tag}"] = (
            int(scores.unique().numel()), int(scores.numel()))
    return share


def check_outputs(res_by_batch, mode):
    """Finite values of the expected shapes in one mode's frames."""
    import torch

    for b, res in res_by_batch.items():
        for key, v in res.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{mode} b{b}: non-finite values in "
                                     f"{key}")
        for key, shape in (("semantic_segmentation_idx", (b, 480, 640)),
                           ("semantic_segmentation_score", (b, 480, 640)),
                           ("instance_segmentation", (b, 480, 640)),
                           ("panoptic_segmentation_deeplab", (b, 480, 640)),
                           ("instance_centers_yx", (b, 64, 2)),
                           ("scene_class_idx", (b,))):
            if tuple(res[key].shape) != shape:
                raise AssertionError(f"{mode} b{b}: {key} has shape "
                                     f"{tuple(res[key].shape)}, not {shape}")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def small_frames(torch, build_flagship, make_frame, random_raw_inputs):
    """Small f32 frames on the card against the same frames on the CPU."""
    report = {}
    for (h, w), mode in (((96, 128), "interleave"),
                         ((128, 160), "decode-planes"),
                         ((128, 160), "decode-both")):
        cuda, scfg, sds = build_flagship(h, w, "float32", "resnet18", "cuda",
                                         seed=1, head_decode_fusion=mode)
        cpu, _, _ = build_flagship(h, w, "float32", "resnet18", "cpu",
                                   seed=1, head_decode_fusion=mode)
        sin = random_raw_inputs(2, h, w, seed=3, device="cpu")
        sin_cuda = {k: v.cuda() for k, v in sin.items()}
        raw_cuda = dict(_leaves(make_frame(cuda, scfg, sds, False)(sin_cuda)))
        raw_cpu = dict(_leaves(make_frame(cpu, scfg, sds, False)(sin)))
        worst = max(rel_err(raw_cuda[k].cpu(), v) for k, v in raw_cpu.items())
        if worst > 1e-3:
            raise AssertionError(f"small frame {h}x{w} {mode}: card vs CPU "
                                 f"raw error {worst:.3e}")
        post_cuda = make_frame(cuda, scfg, sds)(sin_cuda)
        post_cpu = make_frame(cpu, scfg, sds)(sin)
        if sorted(post_cuda) != sorted(post_cpu):
            raise AssertionError(f"small frame {h}x{w} {mode}: keys differ")
        agree = {}
        for key in ("semantic_segmentation_idx", "instance_segmentation",
                    "panoptic_segmentation_deeplab"):
            agree[key] = float((post_cuda[key].cpu() == post_cpu[key])
                               .float().mean())
            if agree[key] < 0.99:
                raise AssertionError(f"small frame {h}x{w} {mode}: {key} "
                                     f"agrees on only {agree[key]:.4f} of "
                                     "the pixels")
        report[f"{h}x{w}/{mode}"] = {"raw_rel_err": worst, "agree": agree}
        log(f"[outputs] small frame {h}x{w} {mode}, card vs CPU: raw "
            f"outputs max rel err {worst:.2e}; postprocessed maps agree on "
            f"{json.dumps(agree)}")
    return report


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
