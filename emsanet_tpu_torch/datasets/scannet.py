"""ScanNet's class maps onto its benchmarks.

A copy of `emsanet_tpu/datasets/scannet.py`: the 40-class (NYUv2-40)
label space onto the 20 classes of the ScanNet v2 benchmark (0 =
ignored), the 549-class space onto ScanNet200 (identity on 1..200), and
`classes_to_ignore`, the data classes a benchmark maps to void (the
ScanNet benchmark mode of validation, `preprocessing/transforms.py`, and
the 40 -> 20 / 549 -> 200 head reduction of `weights.py`).
"""

from __future__ import annotations

from typing import Dict

# NYUv2-40 index -> ScanNet-benchmark-20 index (0 = ignored/void)
_BENCHMARK_CLASSES_40 = {
    1: 1,    # wall
    2: 2,    # floor
    3: 3,    # cabinet
    4: 4,    # bed
    5: 5,    # chair
    6: 6,    # sofa
    7: 7,    # table
    8: 8,    # door
    9: 9,    # window
    10: 10,  # bookshelf
    11: 11,  # picture
    12: 12,  # counter
    14: 13,  # desk
    16: 14,  # curtain
    24: 15,  # refridgerator
    28: 16,  # shower curtain
    33: 17,  # toilet
    34: 18,  # sink
    36: 19,  # bathtub
    39: 20,  # otherfurniture
}

SEMANTIC_CLASSES_40_MAPPING_TO_BENCHMARK: Dict[int, int] = {
    c: _BENCHMARK_CLASSES_40.get(c, 0) for c in range(41)
}

# 549 -> 200 (ScanNet200 benchmark): the fine-grained label space keeps its
# first 200 benchmark classes and ignores the rest; identity on [1, 200].
SEMANTIC_CLASSES_549_MAPPING_TO_BENCHMARK200: Dict[int, int] = {
    c: (c if 1 <= c <= 200 else 0) for c in range(550)
}

# 20 -> benchmark is the identity (already in benchmark space)
SEMANTIC_CLASSES_20_MAPPING_TO_BENCHMARK: Dict[int, int] = {
    c: c for c in range(21)
}


def classes_to_ignore(mapping: Dict[int, int]):
    """Data classes mapped to void by a benchmark mapping
    (emsanet/preprocessing.py:61-66)."""
    return tuple(
        c_data
        for c_data, c_benchmark in mapping.items()
        if c_benchmark == 0 and c_data != 0
    )
