"""Learning-rate schedule (counterpart:
`emsanet_tpu/training/lr_schedule.py`): OneCycle stepped once per epoch,
div_factor 25, pct_start 0.1, cosine annealing, final_div_factor 1e4,
torch's OneCycleLR three-phase cosine form."""

from __future__ import annotations

import math

KNOWN_LR_SCHEDULERS = ("onecycle",)


def onecycle_lr(epoch: int, max_lr: float, total_steps: int,
                div_factor: float = 25.0, pct_start: float = 0.1,
                final_div_factor: float = 1e4) -> float:
    """The learning rate of `epoch` (0-based)."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = float(pct_start * total_steps) - 1
    down_steps = float(total_steps - up_steps - 1)
    t = float(epoch)
    if up_steps <= 0:
        frac = min(t / max(down_steps, 1.0), 1.0)
        return min_lr + (max_lr - min_lr) * (1 + math.cos(math.pi * frac)) / 2
    if t <= up_steps:
        frac = t / up_steps
        return initial_lr + (max_lr - initial_lr) * (
            1 - math.cos(math.pi * frac)) / 2
    frac = min((t - up_steps) / max(down_steps, 1.0), 1.0)
    return min_lr + (max_lr - min_lr) * (1 + math.cos(math.pi * frac)) / 2


def get_lr_fn(cfg):
    """epoch -> learning rate, from a TrainConfig."""
    name = cfg.learning_rate_scheduler.lower()
    if name not in KNOWN_LR_SCHEDULERS:
        raise ValueError(f"Unknown learning rate scheduler: '{name}'")
    max_lr, total = cfg.learning_rate, cfg.n_epochs
    return lambda epoch: onecycle_lr(epoch, max_lr, total)
