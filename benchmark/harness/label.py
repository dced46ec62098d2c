"""A labelling cell: batches of raw RGB-D frames through the program's
deployed frame (`emsanet_tpu_torch.bench.make_frame`: device prep,
forward, postprocessing), the maps copied back to the host.

Set-up builds the model through the program's normal path
(`config.flagship_config` with the configuration's fields,
`models.emsanet.build_model`), loads the benchmark's seeded weights into
it, draws the pool of input batches into pinned host memory and runs
every pool slot through the whole request until it is warm. Then a
closed loop submits requests for the window: each uploads its slot's
frames, runs the frame and copies the maps the inference scripts write
back into pinned buffers of its slot, all on the current stream.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional

import torch

from harness import check_label
from harness.loop import run_loop, window_stats
from harness.trace import Spans, traced
from harness.weights import make_raw_inputs, make_weights


def build_program(cell, device):
    """(model, cfg, dataset config) of the cell, built by the program."""
    from emsanet_tpu_torch.config import (
        best_head_decode_fusion,
        flagship_config,
    )
    from emsanet_tpu_torch.datasets.metadata import get_dataset_config
    from emsanet_tpu_torch.models.emsanet import build_model

    tr = cell.traffic
    mode = best_head_decode_fusion(tr["batch"], True)
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cell.config["model"].items()}
    cfg = flagship_config(**fields,
                          input_height=tr["height"], input_width=tr["width"],
                          head_decode_fusion=mode)
    ds = get_dataset_config(cell.config["dataset"]["name"])
    model = build_model(cfg, ds, device=str(device), seed=None)
    return model, cfg, ds


class Requests:
    """The pool, the per-slot output buffers and the submit function."""

    def __init__(self, frame, pool: List[Dict], keys, device):
        self.frame = frame
        self.pool = pool
        self.keys = keys
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.host: List[Optional[Dict]] = [None] * len(pool)
        self.kept: List[Optional[Dict]] = [None] * len(pool)
        self.wrap = None  # a fault's wrapper of the frame (tests only)
        self.tag = None  # a record_function name per request, traced

    def _buffers(self, res):
        return {k: torch.empty(res[k].shape, dtype=res[k].dtype,
                               pin_memory=self.cuda)
                for k in self.keys if k in res}

    def submit(self, i: int, rec: Dict):
        ctx = None
        if self.tag:
            from torch.profiler import record_function
            ctx = record_function(self.tag)
            ctx.__enter__()
        s = i % len(self.pool)
        batch = {k: v.to(self.device, non_blocking=True)
                 for k, v in self.pool[s].items()}
        frame = self.frame if self.wrap is None else self.wrap(self.frame)
        t = time.perf_counter()
        res = frame(batch)
        rec["host_ms"] = (time.perf_counter() - t) * 1e3
        if self.host[s] is None:
            self.host[s] = self._buffers(res)
        for k, buf in self.host[s].items():
            buf.copy_(res[k], non_blocking=True)
        self.kept[s] = res
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        if ctx is not None:
            ctx.__exit__(None, None, None)
        return event


def load_weights(model, cell, seed: int, device):
    """The seed's weights, loaded into the program's model; returns them
    and the seconds of the reference's calibration among their making."""
    state = model.state_dict()
    dtype = next(iter(model.parameters())).dtype
    tr = cell.traffic
    weights, reference_s = make_weights(
        {k: (tuple(v.shape), v.dtype) for k, v in state.items()}, seed,
        device, dtype, cell.config, tr["height"], tr["width"])
    model.load_state_dict(weights)
    return weights, reference_s


def make_pool(cell, seed: int, device) -> List[Dict]:
    """The seed's input batches, in pinned host memory on a card."""
    tr = cell.traffic
    pin = torch.device(device).type == "cuda"
    pool = []
    for slot in range(tr["pool"]):
        raw = make_raw_inputs(tr["batch"], tr["height"], tr["width"], seed,
                              slot, device)
        pool.append({k: torch.empty(v.shape, dtype=v.dtype,
                                    pin_memory=pin).copy_(v)
                     for k, v in raw.items()})
        del raw
    return pool


def setup(cell, seed: int, device, program=None):
    """(model, requests, weights, seconds of the reference's work) ready
    for the window; `program` reuses a (model, cfg, dataset config)
    already built."""
    from emsanet_tpu_torch.bench import make_frame

    model, cfg, ds = program or build_program(cell, device)
    weights, reference_s = load_weights(model, cell, seed, device)
    frame = make_frame(model, cfg, ds, with_postprocessing=True,
                       raw_inputs=True)
    req = Requests(frame, make_pool(cell, seed, device),
                   cell.traffic["host_outputs"], device)
    return model, req, weights, reference_s


def warm(req: Requests, cell):
    tr = cell.traffic
    run_loop(req.submit, tr["in_flight"],
             count=max(tr["warmup_requests"], len(req.pool)))
    _sync(req)


def _sync(req):
    if req.cuda:
        torch.cuda.synchronize()


def window(req: Requests, cell, seconds: float) -> Dict:
    tr = cell.traffic
    start = time.perf_counter()
    records = run_loop(req.submit, tr["in_flight"], until=start + seconds)
    _sync(req)
    stats = window_stats(records, start, time.perf_counter(), tr["batch"])
    stats["start"] = start
    return stats


def traced_window(req: Requests, model, cell):
    """The trace of `traced_requests` requests of the same loop in its
    steady state, with spans around each request, the model and its
    encoder: the loop first fills its `in_flight` places, and the window
    (`bench.window`) opens at the next submit, while the card runs the
    earlier requests, and closes once the last request is done."""
    from torch.profiler import record_function

    tr = cell.traffic
    lead = tr["in_flight"]

    def body():
        span = record_function("bench.window")

        def submit(i, rec):
            if i == lead:
                span.__enter__()
            return req.submit(i, rec)

        run_loop(submit, lead, count=lead + tr["traced_requests"])
        _sync(req)
        span.__exit__(None, None, None)

    req.tag = "bench.request"
    try:
        with Spans({"model": model, "encoder": model.encoder}):
            return traced(body)
    finally:
        req.tag = None


def slots_for_check(req: Requests) -> List[Dict]:
    return [{"inputs": req.pool[s], "host": req.host[s],
             "device": req.kept[s]} for s in range(len(req.pool))]


class Context:
    """What a per-layer metric's reader reads: the traced sub-window's
    `trace`, the untraced window's `stats`, the cell, the card's
    `peaks` and the reference's model FLOPs per item of work."""

    def __init__(self, cell, trace, stats, shapes, peaks):
        self.cell = cell
        self.trace = trace
        self.stats = stats
        self.peaks = peaks
        self._shapes = shapes
        self._flops = None

    @property
    def requests(self) -> int:
        return len(self.trace.spans("bench.request"))

    def flops_per_item(self) -> int:
        if self._flops is None:
            from harness.flops import forward_flops

            tr = self.cell.traffic
            self._flops = forward_flops(self._shapes, self.cell.config,
                                        tr["height"], tr["width"])
        return self._flops


def run(cell, seed: int, seconds: float, trace: bool, device,
        wrap=None) -> Dict:
    """One run: set-up, warm-up, the window, with `trace` the traced
    sub-window, then the check. Returns 'setup_end' (host clock),
    'reference_s' (the reference's seconds in set-up), 'stats' and
    'readings' (the window's end-to-end metrics), 'context' (traced),
    'memory_peak_bytes' and 'compared'."""
    model, req, weights, reference_s = setup(cell, seed, device)
    req.wrap = wrap
    warm(req, cell)
    # what set-up made is kept out of the collector's passes in the
    # window, where a full pass over the model's objects stalls the host
    gc.collect()
    gc.freeze()
    setup_end = time.perf_counter()
    stats = window(req, cell, seconds)
    out = {"setup_end": setup_end, "reference_s": reference_s,
           "stats": stats,
           "readings": {"frames_per_s": stats["items_per_s"],
                        "latency_ms_p95": stats["latency_ms_p95"]}}
    if trace:
        from harness.peaks import peaks_for

        shapes = {k: tuple(v.shape) for k, v in weights.items()}
        out["context"] = Context(
            cell, traced_window(req, model, cell), stats, shapes,
            peaks_for(torch.cuda.get_device_name() if req.cuda else ""))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if req.cuda else 0)
    gc.unfreeze()
    req.frame = req.wrap = None
    del model
    gc.collect()
    if req.cuda:
        torch.cuda.empty_cache()
    start = time.perf_counter()
    out["compared"] = check_label.numbers(weights, cell.config,
                                          slots_for_check(req), device)
    print(f"check: {time.perf_counter() - start:.1f} s", file=sys.stderr)
    return out

