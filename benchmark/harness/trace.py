"""The traced sub-window: torch.profiler, spans from outside the program,
and a reading of the device records.

- `traced(body)` is `chip_smoke.py::traced` (frozen from commit
  795107519fd8): torch.profiler loses the first device records of a
  trace, and more the longer the process has run, so the trace opens with
  spin kernels and counts only where one of them is left.
- `Spans` puts `record_function` ranges around modules of the program
  through forward hooks, so that the device kernels launched inside a
  module can be told apart without a span in the program itself.
- `Trace` reads the exported Chrome trace: every device kernel, memcpy
  and memset with its duration and the host time of its launch (the
  runtime or driver call with its correlation id), the host spans, and
  the program's custom ops (`emsanet::<name>`) with their input shapes.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

TRACE_LEAD = 64
LEAD_KERNEL = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced(body: Callable[[], None]):
    """The torch.profiler trace of body(), opened by spin kernels."""
    from torch.profiler import ProfilerActivity, profile

    lead = TRACE_LEAD
    while True:
        start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            body()
            torch.cuda.synchronize()
        trace = Trace.from_profile(prof)
        kept = sum(LEAD_KERNEL in k["name"] for k in trace.kernels)
        print(f"traced: {kept} of {lead} spin kernels kept, "
              f"{len(trace.device)} device records, "
              f"{time.perf_counter() - start:.1f} s", file=sys.stderr)
        if kept:
            return trace
        if lead >= 16 * TRACE_LEAD:
            raise RuntimeError(f"torch.profiler kept none of the {lead} "
                               "spin kernels that open its trace")
        lead *= 4


class Spans:
    """`record_function` ranges named `bench.<name>` around modules'
    forwards, while the context is open."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles = []

    def __enter__(self):
        from torch.profiler import record_function

        for name, module in self.modules.items():
            stack: List = []

            def pre(_m, _a, name=name, stack=stack):
                rf = record_function(f"bench.{name}")
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles.append(module.register_forward_pre_hook(pre))
            self.handles.append(module.register_forward_hook(post))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []


def _union(intervals: Iterable[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    """The device and host records of one traced span (times in us, the
    host's clock)."""

    def __init__(self, events: List[Dict]):
        launches = {}
        self.host: List[Dict] = []
        self.device: List[Dict] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args", {})
            if cat in ("cuda_runtime", "cuda_driver"):
                launches[args.get("correlation")] = e
            elif cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in ("cpu_op", "user_annotation"):
                self.host.append(e)
        ops = {e["args"]["External id"]: e for e in self.host
               if "External id" in e.get("args", {})}
        for e in self.device:
            args = e.get("args", {})
            # the launching call; else the op the launch was made in
            call = (launches.get(args.get("correlation"))
                    or ops.get(args.get("External id")))
            e["launch_ts"] = call["ts"] if call else None
            e["launch_tid"] = call["tid"] if call else None
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        finally:
            os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    def spans(self, name: str) -> List[Dict]:
        return [e for e in self.host if e["name"] == name]

    def window(self) -> Tuple[float, float]:
        (w,) = self.spans("bench.window")
        return w["ts"], w["ts"] + w["dur"]

    def launched_in(self, spans: List[Dict],
                    events: Optional[List[Dict]] = None) -> List[Dict]:
        """The device records whose launch lies inside one of `spans` and
        on its thread."""
        events = self.kernels if events is None else events
        ranges = [(s["ts"], s["ts"] + s["dur"], s["tid"]) for s in spans]
        return [e for e in events if e["launch_ts"] is not None and any(
            a <= e["launch_ts"] <= b and e["launch_tid"] == t
            for a, b, t in ranges)]

    def in_window_ops(self, name: str) -> List[Dict]:
        a, b = self.window()
        return [e for e in self.spans(name) if a <= e["ts"] <= b]

    def in_window(self, events: Optional[List[Dict]] = None) -> List[Dict]:
        a, b = self.window()
        events = self.kernels if events is None else events
        return [e for e in events
                if e["launch_ts"] is not None and a <= e["launch_ts"] <= b]

    def busy_us(self) -> float:
        """Time in the window with a kernel, memcpy or memset running."""
        a, b = self.window()
        return _union((max(e["ts"], a), min(e["ts"] + e["dur"], b))
                      for e in self.device
                      if e["ts"] < b and e["ts"] + e["dur"] > a)

    @staticmethod
    def device_us(events: List[Dict]) -> float:
        return sum(e["dur"] for e in events)

    def top_device_ops(self, n: int = 10) -> List[List]:
        sums: Dict[str, float] = {}
        for e in self.in_window(self.device):
            sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"]
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The window's idle gaps on the device, summed by what the host's
        innermost op was at each gap's start (one sweep over the window
        thread's ops, which nest)."""
        a, b = self.window()
        busy = sorted((max(e["ts"], a), min(e["ts"] + e["dur"], b))
                      for e in self.device
                      if e["ts"] < b and e["ts"] + e["dur"] > a)
        gaps, at = [], a
        for s, t in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if at < b:
            gaps.append((at, b))
        (w,) = self.spans("bench.window")
        ops = sorted((e for e in self.host if e["tid"] == w["tid"]
                      and not e["name"].startswith("bench.window")),
                     key=lambda e: (e["ts"], -e["dur"]))
        sums: Dict[str, float] = {}
        stack: List[Dict] = []
        i = 0
        for s, t in gaps:  # in order of their starts
            while i < len(ops) and ops[i]["ts"] <= s:
                stack.append(ops[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= s:
                stack.pop()
            label = stack[-1]["name"] if stack else "host: outside any op"
            sums[label] = sums.get(label, 0.0) + (t - s)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top]
