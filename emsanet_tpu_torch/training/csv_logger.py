"""CSV metric log: one row per epoch in `metrics.csv`, its header the
union of the keys seen so far in first-seen order, the file rewritten
atomically (a copy of `emsanet_tpu/training/csv_logger.py`).
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List


class CSVLogger:
    def __init__(self, filepath: str, write_interval: int = 1):
        self.filepath = filepath
        self.write_interval = write_interval
        self._rows: List[Dict[str, Any]] = []
        self._pending = 0
        self._keys: List[str] = []

    def log(self, row: Dict[str, Any]) -> None:
        self._rows.append(dict(row))
        for k in row:
            if k not in self._keys:
                self._keys.append(k)
        self._pending += 1
        if self._pending >= self.write_interval:
            self.write()

    def write(self) -> None:
        if not self._rows:
            return
        os.makedirs(
            os.path.dirname(os.path.abspath(self.filepath)), exist_ok=True
        )
        tmp = self.filepath + ".tmp"
        with open(tmp, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=self._keys, restval="")
            writer.writeheader()
            for row in self._rows:
                writer.writerow(row)
        os.replace(tmp, self.filepath)
        self._pending = 0
