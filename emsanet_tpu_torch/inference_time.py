"""Inference timing: whole-model frames/s across configurations.

    python -m emsanet_tpu_torch.inference_time                 # one config
    python -m emsanet_tpu_torch.inference_time --with-postprocessing
    python -m emsanet_tpu_torch.inference_time --sweep --csv out.csv

Counterpart of the repository's `inference_time.py` (the reference's
`inference_time_whole_model.py` + `inference_time.bash`): the model of
the configuration (the trainer's flags; random weights from seed 0) on
random normalized inputs, `--n-runs-warmup` (20) runs, then `--n-runs` (80) timed runs;
mean and std frames/s per configuration. `--sweep` times batch 1, 8
and 32 in bfloat16 and float32, as the bash script does, and `--csv`
writes the rows. The head mode comes from `best_head_decode_fusion`
(with postprocessing: 'decode-planes' below batch 16, 'decode' from 16
up; without: 'interleave', which keeps the heads in the forward).

The model timed is the one the inference scripts run
(`inference_samples.eval_model`), as the JAX package's timing times its
scripts' model: float32 parameters, cast to the compute dtype at use.
`bench.py`'s model, whose parameters are stored in the compute dtype, is
not this one in bfloat16.

Each timed run sits between two CUDA events, recorded as the host
enqueues it; the mean and std of the runs' milliseconds give the
frames/s (`batch / mean`, its std scaled as the reference scales it).
The JAX package times by queue differences (`emsanet_tpu/utils/
timing.py`) only because a TPU's dispatch does not wait for the device;
CUDA events need no such device. With `--device cpu` the host clock
times each run. `--profile-dir` writes a `torch.profiler` trace of the
first configuration's timed runs (`trace_b<batch>_<dtype>.json`).
"""

from __future__ import annotations

import contextlib
import csv
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.config import best_head_decode_fusion
from emsanet_tpu_torch.datasets.registry import get_dataset_config
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.models.emsanet import build_train_model
from emsanet_tpu_torch.postprocessing import postprocess

SWEEP = [(b, d) for d in ("bfloat16", "float32") for b in (1, 8, 32)]


def build_parser():
    parser = trainer.build_parser()
    g = parser.add_argument_group("timing")
    g.add_argument("--time-batch-size", type=int, default=1)
    g.add_argument("--n-runs", type=int, default=80)
    g.add_argument("--n-runs-warmup", type=int, default=20)
    g.add_argument("--with-postprocessing", action="store_true")
    g.add_argument("--sweep", action="store_true",
                   help="batch sizes 1, 8, 32 x bfloat16, float32")
    g.add_argument("--csv", default=None, help="write the rows here")
    g.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first "
                   "configuration's timed runs here")
    return parser


def _run_ms(fn, n_runs: int, device: torch.device) -> List[float]:
    """Milliseconds of each of `n_runs` calls of `fn`."""
    if device.type != "cuda":
        times = []
        for _ in range(n_runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n_runs)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def time_configuration(cfg, device: torch.device, batch_size: int,
                       dtype: str, with_postprocessing: bool, n_runs: int,
                       n_warmup: int, profile_path: Optional[str] = None
                       ) -> Dict:
    """One configuration's row: frames/s mean and std, ms per batch."""
    m = cfg.model
    m.compute_dtype = dtype
    m.head_decode_fusion = best_head_decode_fusion(batch_size,
                                                   with_postprocessing)
    ds = get_dataset_config(cfg.data)
    model = build_train_model(m, ds, device=str(device), seed=0).eval()
    is_thing = torch.tensor(ds.classes_is_thing, device=device)
    g = torch.Generator().manual_seed(0)
    h, w = m.input_height, m.input_width
    batch = {"rgb": torch.randn((batch_size, h, w, 3), generator=g),
             "depth": torch.randn((batch_size, h, w, 1), generator=g)}
    batch = {k: v.to(device) for k, v in batch.items()}

    @torch.no_grad()
    def step():
        out = model(batch)
        if with_postprocessing:
            out = postprocess(out, is_thing, m)
        return out

    for _ in range(n_warmup):
        step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    profiler = contextlib.nullcontext()
    if profile_path:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    with profiler as prof:
        ms = _run_ms(step, n_runs, device)
    if profile_path:
        os.makedirs(os.path.dirname(os.path.abspath(profile_path)),
                    exist_ok=True)
        prof.export_chrome_trace(profile_path)
    sec = statistics.mean(ms) / 1e3
    sec_std = statistics.pstdev(ms) / 1e3
    fps = batch_size / sec
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "batch_size": batch_size,
        "dtype": dtype,
        "postprocessing": with_postprocessing,
        "head_decode_fusion": m.head_decode_fusion,
        "fps_mean": fps,
        "fps_std": fps * sec_std / sec,
        "latency_ms": sec * 1e3,
    }


def run(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Every configuration's row (printed as it is measured)."""
    ns = build_parser().parse_args(argv)
    cfg = trainer.config_from_args(ns)
    device = resolve_device(ns.device)
    configs = SWEEP if ns.sweep else [(ns.time_batch_size,
                                       cfg.model.compute_dtype)]
    rows = []
    for i, (batch_size, dtype) in enumerate(configs):
        trace = (os.path.join(ns.profile_dir,
                              f"trace_b{batch_size}_{dtype}.json")
                 if ns.profile_dir and i == 0 else None)
        row = time_configuration(cfg, device, batch_size, dtype,
                                 ns.with_postprocessing, ns.n_runs,
                                 ns.n_runs_warmup, trace)
        rows.append(row)
        print(f"batch={batch_size:3d} dtype={dtype:9s} "
              f"fps={row['fps_mean']:9.2f}±{row['fps_std']:.2f} "
              f"latency={row['latency_ms']:.2f}ms "
              f"mode={row['head_decode_fusion']} device={row['device']}",
              flush=True)
    if ns.csv:
        with open(ns.csv, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {ns.csv}")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
