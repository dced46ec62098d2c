#!/usr/bin/env python3
"""Readings behind the limits of a cell's `correct`, on the card, in one
process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1-12 \
        --control-seeds 101-103 --fault-seeds 201-203 --out <file.jsonl>

For each program seed: the seed's weights and input pool, every slot
through the timed path at the cell's own load (the request loop, each
slot twice), and the compared numbers. For each control seed: the
control (the reference in float8 in the program's place) on the seed's
pool. For each fault seed: the program with each planted fault. One JSON
line per reading; a summary of each number's lower reading (the largest
over the program's seeds) and upper reading (the smallest over the
control's seeds, and over each fault's) ends the file and the output.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from harness import check_label, control, label  # noqa: E402
from harness.loop import run_loop  # noqa: E402
from harness.manifest import resolve  # noqa: E402


def seeds(spec):
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def program_numbers(cell, program, seed, device, wrap=None):
    _, req, weights, _ = label.setup(cell, seed, device, program)
    req.wrap = wrap
    run_loop(req.submit, cell.traffic["in_flight"], count=2 * len(req.pool))
    if req.cuda:
        torch.cuda.synchronize()
    req.frame = None
    return check_label.numbers(weights, cell.config,
                               label.slots_for_check(req), device)


def control_numbers(cell, program, seed, device):
    weights, _ = label.load_weights(program[0], cell, seed, device)
    pool = label.make_pool(cell, seed, device)
    slots = [{"inputs": p, "host": {},
              "device": control.control_outputs(weights, cell.config, p,
                                                device)} for p in pool]
    return check_label.numbers(weights, cell.config, slots, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = resolve(args.workload)
    device = args.device
    program = label.build_program(cell, device)
    rows = []

    def emit(kind, seed, values, t0):
        row = {"kind": kind, "seed": seed, "numbers": values,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")

    for kind, spec in (("program", args.seeds),
                       ("control", args.control_seeds),
                       ("fault", args.fault_seeds)):
        for seed in seeds(spec):
            if kind == "control":
                t0 = time.perf_counter()
                emit("control", seed,
                     control_numbers(cell, program, seed, device), t0)
                continue
            waves = ({None: None} if kind == "program"
                     else control.faults_for(cell.config))
            for name, fault in waves.items():
                t0 = time.perf_counter()
                values = program_numbers(cell, program, seed, device, fault)
                emit(kind if name is None else f"fault:{name}", seed,
                     values, t0)
    summary = {}
    for row in rows:
        for k, v in row["numbers"].items():
            s = summary.setdefault(k, {})
            if row["kind"] == "program":
                s["lower"] = max(s.get("lower", v), v)
            else:
                s[row["kind"]] = min(s.get(row["kind"], v), v)
    line = json.dumps({"summary": summary})
    print(line)
    with open(args.out, "a") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
