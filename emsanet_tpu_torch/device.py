"""Device choice of the entry points: the card unless the caller asks
for the CPU. Without a card, 'cuda' raises; there is no silent CPU run."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}'")
    return dev
