"""Checkpoints: atomic save and load, and the best-metric tracker.

Counterpart of `emsanet_tpu/training/checkpoint.py`, in the port's own
format: one `torch.save` file holding the model's and the optimizer's
`state_dict`, the epoch and the epoch's logs, written to a temporary
file in the target directory and moved into place with `os.replace`, so
a reader never sees a half-written checkpoint. The trainer names its
files as `main.py` does, with the suffix `.pt`: `ckpt_<metric>_best.pt`
or `ckpt_<metric>_epoch_<epoch>.pt`, `ckpt_resume.pt` and
`ckpt_error__epoch_<epoch>.pt`. The JAX package's checkpoints give
their weights through `weights.load_weights_file` (`jax_checkpoint.py`);
`load_checkpoint` refuses them, since their optimizer state does not
carry over. `CheckpointHelper` and `_direction` are
copied as they stand: metrics combine with '+', and a name holding
'mae', 'rmse' or 'loss' is better lower.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], epoch: int,
                    logs: Optional[Dict[str, Any]] = None) -> None:
    """Write the checkpoint of `epoch` atomically."""
    payload = {
        "model": model.state_dict(),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "epoch": int(epoch),
        "logs": {k: (float(v) if isinstance(v, float) else v)
                 for k, v in (logs or {}).items()},
    }
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(payload, fh)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint into `model` (and `optimizer`, where given) on
    the model's device; returns (epoch, logs)."""
    from emsanet_tpu_torch.training import jax_checkpoint

    if jax_checkpoint.is_jax_checkpoint(path):
        raise ValueError(
            f"{path} is a JAX package checkpoint: its optimizer state does "
            "not carry over, so it cannot resume a run; pass it as "
            "--weights-filepath to start from its weights")
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        if payload["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["epoch"]), dict(payload["logs"])


# metric direction registry (main.py:222-247)
_GREATER_IS_BETTER = ("miou", "acc", "bacc", "pq", "rq", "sq")
_LESS_IS_BETTER = ("mae", "rmse", "loss")


def _direction(metric: str) -> int:
    m = metric.lower()
    for suffix in _LESS_IS_BETTER:
        if suffix in m:
            return -1
    return 1


class CheckpointHelper:
    """Best-metric tracker (reference `CheckpointHelper`, SURVEY.md M14).

    metric_names: names appearing in the epoch logs dict; combined
    metrics via '+' sum their (direction-normalized) values.
    """

    def __init__(self, metric_names: Tuple[str, ...], debug: bool = False):
        self.metric_names = tuple(metric_names)
        self.best: Dict[str, float] = {}
        self.debug = debug

    @property
    def metric_mapping_joined(self) -> Dict[str, Tuple[str, ...]]:
        return {m: tuple(m.split("+")) for m in self.metric_names}

    def _value(self, metric: str, logs: Dict[str, float]) -> Optional[float]:
        parts = metric.split("+")
        total = 0.0
        for p in parts:
            if p not in logs:
                return None
            total += _direction(p) * float(logs[p])
        return total

    def check_for_checkpoint(
        self,
        logs: Dict[str, float],
        add_checkpoint_metrics_to_logs: bool = True,
    ) -> List[str]:
        """Returns metric names that improved this epoch."""
        improved = []
        for metric in self.metric_names:
            value = self._value(metric, logs)
            if value is None:
                continue
            if metric not in self.best or value > self.best[metric]:
                self.best[metric] = value
                improved.append(metric)
            if add_checkpoint_metrics_to_logs:
                logs[f"{metric}_best"] = self.best[metric]
        return improved
