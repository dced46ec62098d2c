"""Label tables, depth statistics and `meta.json` of every dataset.

A copy of `emsanet_tpu/datasets/metadata.py`: the NYUv2-40 class list
(SUNRGB-D's 37 classes are its first 37), the ScanNet 40 / 549,
Cityscapes, COCO, Hypersim and SceneNet RGB-D tables, the raw NYUv2
scene list, the indoor-domestic scene list and its remap, the published
depth statistics (fallbacks for the prepared datasets' own) and the
`meta.json` schema a prepared dataset carries (`dataset_config_to_meta`,
`dataset_config_from_meta`, `load_meta_config`; a dataset's `meta.json`
wins over these tables). Colours come from the same deterministic
colormap, so a configuration equals the JAX package's field for field.
`DatasetConfig` is flat: label lists include void at index 0.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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

SUNRGBD_37 = NYUV2_40[:37]

# indoor-domestic scene label set; `scene_list` adds void at index 0
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
# raw scene name -> indoor-domestic class (catch-all 'other indoor')
_INDOOR_DOMESTIC_REMAP = {
    "bathroom": "bathroom",
    "bedroom": "bedroom",
    "dining room": "dining room",
    "dinette": "dining room",
    "dining area": "dining room",
    "conference room": "discussion room",
    "discussion room": "discussion room",
    "meeting room": "discussion room",
    "hallway": "hallway",
    "corridor": "hallway",
    "foyer": "hallway",
    "kitchen": "kitchen",
    "office kitchen": "kitchen",
    "living room": "living room",
    "playroom": "living room",
    "rec room": "living room",
    "recreation room": "living room",
    "office": "office",
    "home office": "office",
    "study": "office",
    "study room": "office",
    "study space": "office",
    "computer room": "office",
}


def map_scene_to_indoor_domestic(name: str) -> str:
    """Map a raw scene class name into the indoor-domestic label set."""
    name = name.strip().lower().replace("_", " ")
    if name in ("void", ""):
        return "void"
    return _INDOOR_DOMESTIC_REMAP.get(name, "other indoor")


NYUV2_SCENES = (
    "basement",
    "bathroom",
    "bedroom",
    "bookstore",
    "cafe",
    "classroom",
    "computer lab",
    "conference room",
    "dinette",
    "dining room",
    "excercise room",
    "foyer",
    "furniture store",
    "home office",
    "home storage",
    "indoor balcony",
    "kitchen",
    "laundry room",
    "living room",
    "office",
    "office kitchen",
    "playroom",
    "printer room",
    "reception room",
    "student lounge",
    "study",
    "study room",
)


@dataclass(frozen=True)
class DepthStats:
    min: float
    max: float
    mean: float
    std: float


# depth statistics in raw sensor units (ESANet / EMSANet training
# statistics; the last five are fallbacks for a prepared meta.json)
DEPTH_STATS = {
    "nyuv2": DepthStats(min=0.0, max=10000.0, mean=2841.94941272766,
                        std=1417.2594281672277),
    "sunrgbd": DepthStats(min=0.0, max=65528.0, mean=19025.14930492213,
                          std=9880.916071806689),
    "cityscapes": DepthStats(min=0.0, max=300.0, mean=31.715617493177906,
                             std=38.70280704497496),
    "hypersim": DepthStats(min=0.0, max=65535.0, mean=6245.0, std=5340.0),
    "scannet": DepthStats(min=0.0, max=10000.0, mean=1880.0, std=1045.0),
    "scenenetrgbd": DepthStats(min=0.0, max=20000.0, mean=4006.9,
                               std=2459.7),
    "coco": DepthStats(min=0.0, max=1.0, mean=0.5, std=0.25),
    "synthetic": DepthStats(min=0.0, max=10000.0, mean=3000.0, std=1500.0),
}

Color = Tuple[int, int, int]


def generate_distinct_colors(n: int, seed: int = 0) -> List[Color]:
    """A deterministic, visually distinct colormap (golden-ratio hues)."""
    colors: List[Color] = []
    golden = 0.6180339887498949
    h = seed * golden % 1.0
    for i in range(n):
        h = (h + golden) % 1.0
        s = 0.55 + 0.35 * ((i * 7) % 3) / 2.0
        v = 0.65 + 0.3 * ((i * 5) % 2)
        hh = h * 6.0
        c = v * s
        x = c * (1 - abs(hh % 2 - 1))
        m = v - c
        r, g, b = [
            (c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c), (c, 0, x)
        ][int(hh) % 6]
        colors.append(
            (int((r + m) * 255), int((g + m) * 255), int((b + m) * 255)))
    return colors


@dataclass(frozen=True)
class DatasetConfig:
    """What the model, the preprocessing, the loader and the metrics read
    of a dataset. Label lists include void at index 0."""

    semantic_class_names: Tuple[str, ...]
    classes_is_thing: Tuple[bool, ...]
    classes_use_orientations: Tuple[bool, ...]
    scene_class_names: Tuple[str, ...]
    depth_stats: DepthStats
    semantic_colors: Tuple[Color, ...] = ()
    scene_colors: Tuple[Color, ...] = ()

    @property
    def n_semantic_classes_without_void(self) -> int:
        return len(self.semantic_class_names) - 1

    @property
    def n_scene_classes_without_void(self) -> int:
        return len(self.scene_class_names) - 1

    def with_scenes(self, names: Sequence[str]) -> "DatasetConfig":
        """This configuration with the scene list void + `names`."""
        return build_dataset_config(
            tuple(zip(self.semantic_class_names, self.classes_is_thing,
                      self.classes_use_orientations, self.semantic_colors)),
            scene_list(names), self.depth_stats)


def scene_list(names: Sequence[str]) -> Tuple[Tuple[str, Color], ...]:
    """void + `names`, with the scene colormap (seed 7)."""
    colors = generate_distinct_colors(len(names) + 1, seed=7)
    return (("void", (0, 0, 0)),) + tuple(zip(names, colors[1:]))


def semantic_list(entries: Sequence[Tuple[str, bool, bool]]):
    """void + (name, is_thing, use_orientations) entries, coloured."""
    colors = generate_distinct_colors(len(entries) + 1)
    return (("void", False, False, (0, 0, 0)),) + tuple(
        (name, thing, orient, color)
        for (name, thing, orient), color in zip(entries, colors[1:]))


def build_dataset_config(semantic, scenes, depth_stats: DepthStats
                         ) -> DatasetConfig:
    """semantic: (name, is_thing, use_orientations, color) with void;
    scenes: (name, color) with void."""
    return DatasetConfig(
        semantic_class_names=tuple(e[0] for e in semantic),
        classes_is_thing=tuple(bool(e[1]) for e in semantic),
        classes_use_orientations=tuple(bool(e[2]) for e in semantic),
        scene_class_names=tuple(e[0] for e in scenes),
        depth_stats=depth_stats,
        semantic_colors=tuple(tuple(e[3]) for e in semantic),
        scene_colors=tuple(tuple(e[1]) for e in scenes),
    )


_CITYSCAPES = (
    ("road", False, False), ("sidewalk", False, False),
    ("building", False, False), ("wall", False, False),
    ("fence", False, False), ("pole", False, False),
    ("traffic light", False, False), ("traffic sign", False, False),
    ("vegetation", False, False), ("terrain", False, False),
    ("sky", False, False), ("person", True, False),
    ("rider", True, False), ("car", True, False),
    ("truck", True, False), ("bus", True, False),
    ("train", True, False), ("motorcycle", True, False),
    ("bicycle", True, False),
)


def get_dataset_config(dataset: str = "synthetic",
                       semantic_n_classes: Optional[int] = None,
                       scene_use_indoor_domestic_labels: bool = False
                       ) -> DatasetConfig:
    """The built-in tables of a dataset name (the JAX package's
    `get_metadata_config`)."""
    name = dataset.lower()
    if name in ("nyuv2", "synthetic", "hypersim", "scenenetrgbd"):
        semantic = NYUV2_40
        scenes = (INDOOR_DOMESTIC_SCENES
                  if scene_use_indoor_domestic_labels or name != "nyuv2"
                  else NYUV2_SCENES)
    elif name == "sunrgbd":
        semantic, scenes = SUNRGBD_37, INDOOR_DOMESTIC_SCENES
    elif name == "scannet":
        n = semantic_n_classes or 40
        semantic = NYUV2_40 if n == 40 else tuple(
            (f"class_{i}", True, False) for i in range(1, n + 1))
        scenes = INDOOR_DOMESTIC_SCENES
    elif name == "cityscapes":
        semantic, scenes = _CITYSCAPES, ("outdoor",)
    elif name == "coco":
        semantic = tuple((f"class_{i}", True, False) for i in range(1, 134))
        scenes = INDOOR_DOMESTIC_SCENES
    else:
        raise ValueError(f"No metadata for dataset '{dataset}'")
    return build_dataset_config(semantic_list(semantic), scene_list(scenes),
                                DEPTH_STATS.get(name,
                                                DEPTH_STATS["synthetic"]))


# ---------------------------------------------------------------------------
# meta.json: the label tables a dataset was prepared with and the depth
# statistics of its training depth maps (tools/prepare_dataset.py writes
# it); a prepared dataset's meta.json wins over the tables above


def dataset_config_to_meta(config: DatasetConfig) -> dict:
    """A DatasetConfig in the meta.json schema."""
    ds = config.depth_stats
    return {
        "version": 1,
        "semantic_labels": [
            {"name": name, "is_thing": bool(thing),
             "use_orientations": bool(orient), "color": list(color)}
            for name, thing, orient, color in zip(
                config.semantic_class_names, config.classes_is_thing,
                config.classes_use_orientations, config.semantic_colors)
        ],
        "scene_labels": list(config.scene_class_names),
        "depth_stats": {"min": ds.min, "max": ds.max, "mean": ds.mean,
                        "std": ds.std},
    }


def dataset_config_from_meta(meta: dict) -> DatasetConfig:
    """A DatasetConfig of a parsed meta.json (labels with void at 0; the
    caller picks `depth_stats_raw` for raw depth)."""
    semantic = tuple(
        (e["name"], bool(e.get("is_thing", False)),
         bool(e.get("use_orientations", False)),
         tuple(e.get("color", (0, 0, 0))))
        for e in meta["semantic_labels"])
    entries = meta.get("scene_labels", ("void",))
    colors = generate_distinct_colors(len(entries), seed=7)
    scenes = tuple((e["name"] if isinstance(e, dict) else e, color)
                   for e, color in zip(entries, colors))
    ds = meta["depth_stats"]
    return build_dataset_config(semantic, scenes, DepthStats(
        min=float(ds["min"]), max=float(ds["max"]), mean=float(ds["mean"]),
        std=float(ds["std"])))


def load_meta_config(dataset_path: str, split: Optional[str] = None,
                     depth_mode: str = "refined"
                     ) -> Optional[DatasetConfig]:
    """`<path>/<split>/meta.json`, else `<path>/meta.json`, as a
    DatasetConfig; None where neither exists."""
    candidates = []
    if split:
        candidates.append(os.path.join(dataset_path, split, "meta.json"))
    candidates.append(os.path.join(dataset_path, "meta.json"))
    for path in candidates:
        if os.path.isfile(path):
            with open(path) as fh:
                meta = json.load(fh)
            if depth_mode == "raw" and "depth_stats_raw" in meta:
                meta = dict(meta, depth_stats=meta["depth_stats_raw"])
            return dataset_config_from_meta(meta)
    return None
