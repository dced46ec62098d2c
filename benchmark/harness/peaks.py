"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 data sheet (SXM part), dense rates without sparsity, at
the card's full power limit of 700 W; the run prints the card's power
limit beside every share of a peak. A card not in the table has no
peaks, and the metrics that need them are left out.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    # name as torch.cuda.get_device_name() gives it
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                              "bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)
