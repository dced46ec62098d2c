"""Timing of the postprocessing kernels of a checkout at the flagship's
shapes.

On a machine with a CUDA card,

    python emsanet_tpu_torch/kernel_bench.py [--tree DIR]

times, from the package of checkout DIR (default: this one):
- `segment_hist_and_sums` on a frame-like key map (row-major and in the
  parity planes' order), one key on every pixel and uniformly random
  keys (the key maps of `tests/torch_segment_maps.py` in this
  checkout), at 480x640 and b1 / b8;
- `instance_head` on the flagship's (N, 240, 320, 5) bf16 head output in
  both layouts;
- `group_pixels_argmin` on a frame's votes in parity order with 64, 45
  and 8 of 64 centers valid (`tests/torch_kernel_cases.py`), at b1 / b8;
- `interleave_planes` on the decode-planes frame's 7 maps (six of 4-byte
  words and the bool foreground) at b1 / b8;
- `segment_lookup` against `torch.gather` (D = 2 tables of 65 entries),
  in 5 alternating rounds at b1 / b8.

Per case: the wrapper's ms (CUDA events, mean of 20 calls) and the
device ms of one call (torch.profiler: every kernel and memset the
wrapper launches), also by kernel. It prints one line per case, the
card's name and power limit, and, last, the results as one JSON line.
To compare two checkouts on one card, run it in turns in one chip call,
each run in a process of its own: parent, this tree, this tree, parent
(`--tree` an unpacked `git archive` of the parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOKUP_ROUNDS = 5


def _time(torch, fn, runs=20):
    """(wrapper ms: CUDA events around `runs` calls, device ms of one
    call: torch.profiler, every kernel and memset it launches, and that
    device ms by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    by_kernel = {ev.key: ev.self_device_time_total / 1e3 / 10
                 for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA}
    return start.elapsed_time(end) / runs, sum(by_kernel.values()), by_kernel


def _case(torch, fn):
    ms, dev, parts = _time(torch, fn)
    return {"ms": ms, "device_ms": dev, "kernels": parts}


def run(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch
    import torch_kernel_cases as kc
    from torch_segment_maps import C, H, S, W, frame_like, one_key, uniform

    from emsanet_tpu_torch.ops import (
        _native,
        grouping,
        instance_head,
        plane_interleave,
        segment_kernels,
    )

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA card")
    for source in ("segment", "instance_head", "grouping",
                   "plane_interleave"):
        _native.load(source)  # built here, not inside a timing
    torch.set_grad_enabled(False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = {"tree": os.path.abspath(tree), "card": card, "cases": {}}
    cases = results["cases"]
    hist_maps = {
        "frame": lambda n: frame_like(0, n, H, W),
        "frame-planes": lambda n: frame_like(0, n, H, W, order="parity"),
        "one-key": lambda n: one_key(0, n, H * W),
        "uniform": lambda n: uniform(0, n, H * W),
    }
    for name, make in hist_maps.items():
        for n in (1, 8):
            args = [torch.from_numpy(a).cuda() for a in make(n)]
            cases[f"hist {name} b{n}"] = _case(torch, lambda: segment_kernels.
                                               segment_hist_and_sums(*args, S,
                                                                     C))
    rng = np.random.RandomState(0)
    for n in (1, 8):
        x = torch.from_numpy(rng.randn(n, H // 2, W // 2, 5).astype(
            np.float32)).cuda().bfloat16()
        weight = torch.from_numpy(rng.randn(5, 1, 3, 3).astype(
            np.float32)).cuda()
        enc = instance_head.encodings_for(5, True, True)
        for interleaved in (False, True):
            layout = "interleaved" if interleaved else "planes"
            cases[f"instance_head {layout} b{n}"] = _case(
                torch, lambda: instance_head.instance_head(x, weight, enc,
                                                           interleaved))

    for n in (1, 8):
        voted = torch.from_numpy(kc.frame_votes(20 + n, n)).cuda()
        for n_valid in (64, 45, 8):
            centers, valid = (torch.from_numpy(a).cuda() for a in
                              kc.center_set(30 + n_valid, n, n_valid))
            cases[f"grouping {n_valid} valid b{n}"] = _case(
                torch, lambda: grouping.group_pixels_argmin(voted, centers,
                                                            valid))
    for n in (1, 8):
        named = {key: torch.from_numpy(x).cuda() for key, x in
                 kc.frame_planes(n, (n, 4, H // 2, W // 2)).items()}
        cases[f"interleave frame b{n}"] = _case(
            torch, lambda: plane_interleave.interleave_planes(named))

    # the lookup against torch.gather, in alternating rounds
    for n in (1, 8):
        inst = np.clip(frame_like(0, n, H, W, order="parity")[0], 0, S - 1)
        inst = torch.from_numpy(inst).cuda()
        tables = torch.from_numpy(rng.randn(n, 2, S).astype(
            np.float32)).cuda()
        index = inst.long()[:, None, :].expand(n, 2, H * W).contiguous()
        for r in range(LOOKUP_ROUNDS):
            cases[f"lookup b{n} round {r}"] = _case(
                torch, lambda: segment_kernels.segment_lookup(inst, tables))
            cases[f"gather b{n} round {r}"] = _case(
                torch, lambda: torch.gather(tables, 2, index))

    for key, t in cases.items():
        parts = ", ".join(f"{k.split('(')[0][:40]} {v:.4f}"
                          for k, v in t["kernels"].items())
        print(f"[{key}] ms {t['ms']:.4f} device {t['device_ms']:.4f} "
              f"({parts})", flush=True)
    print(card)
    print(json.dumps(results))
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=HERE,
                        help="checkout whose emsanet_tpu_torch is timed")
    args = parser.parse_args(argv)
    run(args.tree)
    return 0


if __name__ == "__main__":
    # run by path: the package directory is not a place to import from
    sys.path.pop(0)
    sys.exit(main())
