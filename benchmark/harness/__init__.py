"""The benchmark of `emsanet_tpu_torch`, driven by `BENCHMARK.json`.

`main` runs one cell once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line last on its standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a
`breakdown`, `setup` (the program's kernel libraries built in this run,
and the seconds of the reference's work that set-up held and `setup_s`
leaves out), and last `compared`: each number the check compared beside
its limit, which also end its standard error.

A traffic mix's `kind` names the module `harness/<kind>.py` whose
`run(cell, seed, seconds, trace, device)` drives its cells.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "emsanet_tpu")


def process_start() -> float:
    """This process's start on the `time.time()` clock (from /proc)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # field 22: start time after boot
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: `emsanet_tpu_torch` is not `emsanet_tpu`)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def runner_for(kind: str):
    """The `run` of the module `harness/<kind>.py`, which drives a
    traffic mix of that kind."""
    return importlib.import_module(f"{__name__}.{kind}").run


def built_kernels(root) -> set:
    """The program's kernel libraries in its build cache
    (`build/kernels/` of the checkout)."""
    return {p.name for p in (root / "build" / "kernels").glob("*.so")}


def card() -> Dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return {"nvidia_smi": out[0] if out else ""}
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "unavailable"}


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    import torch

    from harness.check_label import judge
    from harness.manifest import ROOT, resolve

    cell = resolve(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    kind = cell.traffic["kind"]
    try:
        runner = runner_for(kind)
    except (ImportError, AttributeError):
        print(f"no runner for traffic kind '{kind}'", file=sys.stderr)
        return 2
    cached = built_kernels(ROOT)
    got = runner(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    stats = got["stats"]
    # process start to the window, less the reference's work in set-up
    setup_s = (got["setup_end"] - time.perf_counter() + time.time()
               - started - got["reference_s"])
    readings = dict(got["readings"], setup_s=setup_s)
    result: Dict = {}
    if args.trace:
        ctx = got["context"]
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": readings[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if readings.get(m["name"])
                   is not None}
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    ok, rows = judge(got["compared"], cell.checks)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
           "count": cell.chips,
           "memory_peak_bytes": got["memory_peak_bytes"]}
    if args.trace:
        a, b = ctx.trace.window()
        dev["busy_s"] = ctx.trace.busy_us() / 1e6
        dev["window_s"] = (b - a) / 1e6
    line = {"correct": ok, "attempted": stats["attempted"], "failed": 0,
            "metrics": metrics, "device": dev, **result, "card": card(),
            "setup": {"kernels_built": len(built_kernels(ROOT) - cached),
                      "reference_s": got["reference_s"]}}
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"compared {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
