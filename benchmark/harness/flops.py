"""Model FLOPs of a configuration's forward, counted on the plain
reference with `torch.utils.flop_counter.FlopCounterMode` over meta
tensors (no device work): 2 per multiply-add of every conv and dense
layer, the learned upsamplings' depthwise convs included, whatever
implements them in the program."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.emsanet import Reference


def forward_flops(shapes: Dict[str, Tuple[int, ...]], config: Dict,
                  height: int, width: int, batch: int = 1) -> int:
    params = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    ds = config["dataset"]
    ref = Reference(params, config["reference"],
                    (ds["depth_mean"], ds["depth_std"]))
    rgb = torch.empty((batch, height, width, 3), dtype=torch.uint8,
                      device="meta")
    depth = torch.empty((batch, height, width, 1), dtype=torch.int16,
                        device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.forward(rgb, depth)
    return int(counter.get_total_flops())
