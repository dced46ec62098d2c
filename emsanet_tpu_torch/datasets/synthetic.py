"""The synthetic in-memory dataset, for training without data on disk.

A copy of `emsanet_tpu/datasets/synthetic.py::SyntheticDataset`, with
what it needs of `datasets/base.py` (the sample access, the preprocessor
hook and `semantic_compute_class_weights`) and of `datasets/registry.py`
(`derive_sample_keys`, the synthetic branch of `get_dataset`). Samples
are deterministic per (split, index) and equal the JAX package's bit for
bit: a gradient background with stuff bands and a few rectangular
'things' carrying instance ids, orientations and a scene class.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from emsanet_tpu_torch.datasets.metadata import (
    DatasetConfig,
    get_dataset_config,
)


class SampleIdentifier(tuple):
    """Hierarchical sample identifier, e.g. ('train', '0001')."""

    def to_filename(self, separator: str = "__") -> str:
        return separator.join(self)


def derive_sample_keys(input_modalities: Sequence[str],
                       tasks: Sequence[str]) -> Tuple[str, ...]:
    """Sample keys needed for the modalities and tasks."""
    keys = ["identifier"]
    if "rgb" in input_modalities or "rgbd" in input_modalities:
        keys.append("rgb")
    if "depth" in input_modalities or "rgbd" in input_modalities:
        keys.append("depth")
    if "semantic" in tasks:
        keys.append("semantic")
    if "instance" in tasks:
        keys.append("instance")
        if "semantic" not in keys:
            keys.append("semantic")  # thing/stuff needed for targets
    if "orientation" in tasks:
        keys.append("orientations")
    if "scene" in tasks:
        keys.append("scene")
    if "normal" in tasks:
        keys.append("normal")
    return tuple(keys)


class SyntheticDataset:
    """Map-style dataset of sample dicts; `preprocessor` (dict -> dict)
    applies on access."""

    def __init__(
        self,
        split: str = "train",
        sample_keys: Sequence[str] = (
            "identifier", "rgb", "depth", "semantic", "instance",
            "orientations", "scene",
        ),
        n_samples: int = 16,
        height: int = 480,
        width: int = 640,
        dataset_config: Optional[DatasetConfig] = None,
    ):
        self.sample_keys = tuple(sample_keys)
        self.preprocessor = None
        self.split = split
        self.n_samples = n_samples
        self.height = height
        self.width = width
        self.config = dataset_config or get_dataset_config("synthetic")

    def __len__(self) -> int:
        return self.n_samples

    @property
    def cameras(self) -> Tuple[str, ...]:
        return ("synth0",)

    def __getitem__(self, idx: int) -> dict:
        sample = self.load_raw(idx)
        if self.preprocessor is not None:
            sample = self.preprocessor(sample)
        return sample

    def load_raw(self, idx: int) -> dict:
        # stable per-(split, idx) seed (hash() is randomized per process)
        seed = zlib.crc32(f"{self.split}:{idx}".encode()) % (2**31)
        rng = np.random.RandomState(seed)
        h, w = self.height, self.width
        cfg = self.config
        is_thing = np.asarray(cfg.classes_is_thing)
        thing_ids = np.flatnonzero(is_thing)
        stuff_ids = np.flatnonzero(~is_thing)[1:]  # skip void

        sample = {}
        if "identifier" in self.sample_keys:
            sample["identifier"] = SampleIdentifier((self.split, f"{idx:04d}"))

        # background: horizontal stuff bands
        yy = np.linspace(0, 1, h)[:, None]
        xx = np.linspace(0, 1, w)[None, :]
        rgb = np.stack(
            [
                128 + 100 * np.sin(2 * np.pi * (yy + 0.13 * k)) * np.cos(
                    2 * np.pi * (xx + 0.07 * k)
                )
                for k in range(3)
            ],
            axis=-1,
        )
        semantic = np.zeros((h, w), dtype=np.int32)
        if len(stuff_ids) >= 2:
            semantic[: h // 3] = stuff_ids[0]
            semantic[h // 3 :] = stuff_ids[1 % len(stuff_ids)]
        depth = (2000 + 3000 * (yy + xx) / 2 * np.ones((h, w))).astype(
            np.float32)
        instance = np.zeros((h, w), dtype=np.int32)
        orientations = {}

        n_things = rng.randint(2, 6)
        for i in range(n_things):
            th = rng.randint(h // 8, h // 3)
            tw = rng.randint(w // 8, w // 3)
            y0 = rng.randint(0, h - th)
            x0 = rng.randint(0, w - tw)
            cls = int(thing_ids[rng.randint(len(thing_ids))])
            inst_id = i + 1
            semantic[y0 : y0 + th, x0 : x0 + tw] = cls
            instance[y0 : y0 + th, x0 : x0 + tw] = inst_id
            rgb[y0 : y0 + th, x0 : x0 + tw] = rng.randint(0, 255, 3)
            depth[y0 : y0 + th, x0 : x0 + tw] = rng.uniform(500, 9000)
            if cfg.classes_use_orientations[cls]:
                orientations[inst_id] = float(rng.uniform(0, 2 * np.pi))

        if "rgb" in self.sample_keys:
            sample["rgb"] = np.clip(rgb, 0, 255).astype(np.uint8)
        if "depth" in self.sample_keys:
            sample["depth"] = depth.astype(np.float32)
        if "semantic" in self.sample_keys:
            sample["semantic"] = semantic
        if "instance" in self.sample_keys:
            sample["instance"] = instance
        if "orientations" in self.sample_keys:
            sample["orientations"] = orientations
        if "scene" in self.sample_keys:
            n_scene = len(cfg.scene_class_names)
            sample["scene"] = int(rng.randint(1, n_scene))
        return sample

    def semantic_compute_class_weights(
        self, weight_mode: str = "median-frequency", c: float = 1.02,
    ) -> np.ndarray:
        """Per-class weights of the semantic CE for classes 1..C (void
        excluded), from every sample's labels:
        median-frequency w_c = median(freq) / freq_c, logarithmic
        w_c = 1 / ln(c + p_c), linear 1 - p_c, none 1."""
        n_classes = len(self.config.semantic_class_names)
        counts = np.zeros(n_classes, dtype=np.int64)
        pixel_totals = np.zeros(n_classes, dtype=np.int64)
        for i in range(len(self)):
            sem = self.load_raw(i)["semantic"]
            binc = np.bincount(sem.reshape(-1), minlength=n_classes)
            pixel_totals += binc[:n_classes]
            counts += (binc[:n_classes] > 0).astype(np.int64)
        pixel_totals = pixel_totals[1:]
        counts = np.maximum(counts[1:], 1)
        if weight_mode == "none":
            return np.ones(n_classes - 1, dtype=np.float32)
        if weight_mode == "median-frequency":
            freq = np.maximum(pixel_totals / counts, 1)
            return (np.median(freq) / freq).astype(np.float32)
        if weight_mode == "logarithmic":
            p = pixel_totals / max(pixel_totals.sum(), 1)
            return (1.0 / np.log(c + p)).astype(np.float32)
        if weight_mode == "linear":
            p = pixel_totals / max(pixel_totals.sum(), 1)
            return (1.0 - p).astype(np.float32)
        raise ValueError(f"Unknown class weighting '{weight_mode}'")


def get_dataset(data_cfg, model_cfg, split: str) -> SyntheticDataset:
    """The dataset of a split ('synthetic' only: the prepared datasets on
    disk are not ported yet)."""
    if data_cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"not ported yet: dataset '{data_cfg.dataset}'")
    return SyntheticDataset(
        split=split,
        sample_keys=derive_sample_keys(model_cfg.input_modalities,
                                       model_cfg.tasks),
        n_samples=data_cfg.synthetic_n_samples,
        height=model_cfg.input_height, width=model_cfg.input_width,
    )
