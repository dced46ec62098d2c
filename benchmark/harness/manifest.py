"""The benchmark's manifest and the files it names, found by name.

`BENCHMARK.json` at the checkout's root lists the configurations, the
cells and the metrics. Everything that belongs to one of them sits in a
file of its own under `benchmark/`:
- a configuration: the file its entry names (`configs/<name>.json`),
- a traffic mix: `traffic/<traffic>.json`,
- a per-layer metric: its reader `metrics/<metric>.py`, which defines
  `read(ctx)` and returns a number, or None where the run has nothing
  for it to read,
- a cell's limits of the numbers compared for `correct`:
  `checks/<workload>.json`.
Adding one is adding files and entries; no code here names any of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload entry with everything it names, resolved."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    checks: Dict
    bench_dir: Path

    def reader(self, metric: str) -> Callable:
        return load_reader(self.bench_dir, metric)


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _applies(metric: Dict, workload: str, reported: Optional[set] = None
             ) -> bool:
    """A metric with a `workloads` list applies to those cells; one
    without it to every cell (a per-layer one: every cell that reports
    the end-to-end metric it moves)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_reader(bench_dir: Path, metric: str) -> Callable:
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def resolve(workload: str, root: Path = ROOT,
            bench_dir: Path = BENCH_DIR) -> Cell:
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json "
                       f"(has: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    with open(root / entry["file"]) as fh:
        config = json.load(fh)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    checks_path = bench_dir / "checks" / f"{workload}.json"
    checks = {}
    if checks_path.exists():
        with open(checks_path) as fh:
            checks = json.load(fh)
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                checks, bench_dir)
