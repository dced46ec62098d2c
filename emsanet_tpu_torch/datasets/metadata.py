"""Label tables the inference frame needs (NYUv2-40 / `synthetic`).

A copy of the NYUv2-40 class list, the indoor-domestic scene list and
the `synthetic` and `nyuv2` depth statistics of the JAX package
(counterpart: `emsanet_tpu/datasets/metadata.py`). Colours, the other
datasets and `meta.json` loading are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# name, is_thing, use_orientations
NYUV2_40 = (
    ("wall", False, False),
    ("floor", False, False),
    ("cabinet", True, True),
    ("bed", True, True),
    ("chair", True, True),
    ("sofa", True, True),
    ("table", True, True),
    ("door", True, True),
    ("window", True, False),
    ("bookshelf", True, True),
    ("picture", True, False),
    ("counter", True, False),
    ("blinds", True, False),
    ("desk", True, True),
    ("shelves", True, True),
    ("curtain", True, False),
    ("dresser", True, True),
    ("pillow", True, False),
    ("mirror", True, False),
    ("floor mat", True, False),
    ("clothes", True, False),
    ("ceiling", False, False),
    ("books", True, False),
    ("refridgerator", True, True),
    ("television", True, True),
    ("paper", True, False),
    ("towel", True, False),
    ("shower curtain", True, False),
    ("box", True, False),
    ("whiteboard", True, False),
    ("person", True, True),
    ("night stand", True, True),
    ("toilet", True, True),
    ("sink", True, True),
    ("lamp", True, False),
    ("bathtub", True, True),
    ("bag", True, False),
    ("otherstructure", True, False),
    ("otherfurniture", True, True),
    ("otherprop", True, False),
)

INDOOR_DOMESTIC_SCENES = (
    "bathroom",
    "bedroom",
    "dining room",
    "discussion room",
    "hallway",
    "kitchen",
    "living room",
    "office",
    "other indoor",
)


@dataclass(frozen=True)
class DepthStats:
    mean: float
    std: float


# depth statistics in raw sensor units
DEPTH_STATS = {
    "nyuv2": DepthStats(mean=2841.94941272766, std=1417.2594281672277),
    "synthetic": DepthStats(mean=3000.0, std=1500.0),
}


@dataclass(frozen=True)
class DatasetConfig:
    """What the model and postprocessing read of a dataset.

    Label lists include void at index 0, as in the JAX package.
    """

    semantic_class_names: Tuple[str, ...]
    classes_is_thing: Tuple[bool, ...]
    classes_use_orientations: Tuple[bool, ...]
    scene_class_names: Tuple[str, ...]
    depth_stats: DepthStats

    @property
    def n_semantic_classes_without_void(self) -> int:
        return len(self.semantic_class_names) - 1

    @property
    def n_scene_classes_without_void(self) -> int:
        return len(self.scene_class_names) - 1


def get_dataset_config(dataset: str = "synthetic") -> DatasetConfig:
    """NYUv2-40 labels with indoor-domestic scenes ('nyuv2', 'synthetic')."""
    if dataset not in DEPTH_STATS:
        raise NotImplementedError(
            f"not ported yet: metadata of dataset '{dataset}'"
        )
    return DatasetConfig(
        semantic_class_names=("void",) + tuple(e[0] for e in NYUV2_40),
        classes_is_thing=(False,) + tuple(e[1] for e in NYUV2_40),
        classes_use_orientations=(False,) + tuple(e[2] for e in NYUV2_40),
        scene_class_names=("void",) + INDOOR_DOMESTIC_SCENES,
        depth_stats=DEPTH_STATS[dataset],
    )
