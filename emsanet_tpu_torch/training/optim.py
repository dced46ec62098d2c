"""Optimizers (counterpart: `emsanet_tpu/training/optim.py`).

The JAX package chains optax transforms; torch's optimizers compute the
same updates:
- 'sgd': `add_decayed_weights(wd)` + `sgd(lr, momentum, nesterov=True)`
  = `torch.optim.SGD(nesterov=True, weight_decay=wd)`: the decay is added
  to the gradient before the momentum (coupled), every parameter decays,
  and both start the momentum buffer at the first gradient;
- 'adam': `add_decayed_weights` + `adam` = `torch.optim.Adam(weight_decay)`;
- 'adamw': `adamw(weight_decay)` = `torch.optim.AdamW(weight_decay)`;
- 'radam': `add_decayed_weights` + `radam` = `torch.optim.RAdam(
  weight_decay)` (the two place eps differently once the variance
  rectification starts, after the first 5 steps at b2 = 0.999).
`tests/test_torch_port_train.py` holds each against optax. The learning
rate of the OneCycle schedule is set per epoch with `set_learning_rate`.
"""

from __future__ import annotations

from typing import Iterable

import torch

KNOWN_OPTIMIZERS = ("sgd", "adam", "adamw", "radam")


def get_optimizer(params: Iterable[torch.nn.Parameter],
                  cfg) -> torch.optim.Optimizer:
    """cfg: TrainConfig."""
    name = cfg.optimizer.lower()
    lr, wd = cfg.learning_rate, cfg.weight_decay
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                               nesterov=True, weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 weight_decay=wd)
    if name == "radam":
        return torch.optim.RAdam(params, lr=lr, betas=(0.9, 0.999),
                                 weight_decay=wd)
    raise ValueError(f"Unknown optimizer: '{name}'")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The per-epoch OneCycle step."""
    for group in optimizer.param_groups:
        group["lr"] = lr
