"""Batch collation (counterpart: `emsanet_tpu/preprocessing/collate.py`):
a recursive dict collate that stacks arrays and keeps identifiers,
orientation dicts and preprocessing traces as plain lists."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from emsanet_tpu_torch.datasets.base import SampleIdentifier

# values of these kinds are collected into lists, not stacked
_LIST_KEYS_SUFFIX = ("identifier", "orientations", "orientations_present")


def _is_blacklisted(key: str, value: Any) -> bool:
    if isinstance(value, (SampleIdentifier, dict)) and not key.startswith(
        "_down_"
    ):
        return True
    if key.endswith(_LIST_KEYS_SUFFIX):
        return True
    return key in ("_applied_preprocessing", "_no_preprocessing")


def batch_collate(samples: Sequence[dict]) -> Dict[str, Any]:
    """Collate a list of sample dicts into a batch dict."""
    assert samples
    batch: Dict[str, Any] = {}
    for key in samples[0].keys():
        values = [s[key] for s in samples]
        first = values[0]
        if key.startswith("_down_") and isinstance(first, dict):
            batch[key] = batch_collate(values)
        elif _is_blacklisted(key, first):
            batch[key] = list(values)
        elif isinstance(first, np.ndarray):
            batch[key] = np.stack(values, axis=0)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(values)
        else:
            batch[key] = list(values)
    return batch
