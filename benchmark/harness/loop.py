"""The request loop and the end-to-end arithmetic of a window.

A request is submitted by `submit(i, record)`, which enqueues its work and
returns an event that completes with it (None where the work already
completed, as on the CPU). The loop is closed, with at most `in_flight`
requests outstanding: before the next is submitted the oldest is waited
for, and its end is the host's time when the wait returns.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict, List, Optional


def run_loop(submit: Callable, in_flight: int, until: Optional[float] = None,
             count: Optional[int] = None,
             clock: Callable[[], float] = time.perf_counter) -> List[Dict]:
    """Submit requests until `clock()` reaches `until` or `count` were
    submitted, then wait for the outstanding ones. Returns one record per
    request: 'start', 'end' (host seconds) and what `submit` added."""
    records: List[Dict] = []
    pending = collections.deque()

    def finish(rec):
        if rec["event"] is not None:
            rec["event"].synchronize()
        rec["end"] = clock()
        rec["event"] = None

    i = 0
    while count is None or i < count:
        if until is not None and clock() >= until:
            break
        while len(pending) >= in_flight:
            finish(pending.popleft())
        rec = {"i": i, "start": clock()}
        rec["event"] = submit(i, rec)
        pending.append(rec)
        records.append(rec)
        i += 1
    while pending:
        finish(pending.popleft())
    return records


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def window_stats(records: List[Dict], start: float, end: float,
                 items_per_request: int) -> Dict:
    """The window from `start` to `end`: the loop stopped submitting when
    its time was up, waited for every request it had sent, and `end` was
    read after that wait. All of that work counts, over all of that time;
    every request is timed from its start to its end."""
    seconds = end - start
    latencies = [(r["end"] - r["start"]) * 1e3 for r in records]
    return {
        "seconds": seconds,
        "completed": len(records),
        "attempted": len(records),
        "items_per_s": items_per_request * len(records) / seconds,
        "latency_ms": latencies,
        "latency_ms_p95": percentile(latencies, 95) if latencies else None,
        "host_ms": [r["host_ms"] for r in records if "host_ms" in r],
    }
