"""The synthetic in-memory dataset, for training without data on disk.

A copy of `emsanet_tpu/datasets/synthetic.py::SyntheticDataset` on the
port's dataset base (`datasets/base.py`). Samples are deterministic per
(split, index) and equal the JAX package's bit for bit: a gradient
background with stuff bands and a few rectangular 'things' carrying
instance ids, orientations and a scene class.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from emsanet_tpu_torch.datasets.base import (
    SampleIdentifier,
    SceneAnalysisDataset,
)
from emsanet_tpu_torch.datasets.metadata import (
    DatasetConfig,
    get_dataset_config,
)


class SyntheticDataset(SceneAnalysisDataset):
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
        use_cache: bool = False,
        cameras: Tuple[str, ...] = ("synth0",),
    ):
        super().__init__(sample_keys=sample_keys, use_cache=use_cache)
        self.split = split
        self.n_samples = n_samples
        self.height = height
        self.width = width
        self._config = dataset_config or get_dataset_config("synthetic")
        self._cameras = tuple(cameras)

    def __len__(self) -> int:
        return self.n_samples

    @property
    def config(self) -> DatasetConfig:
        return self._config

    @property
    def cameras(self) -> Tuple[str, ...]:
        return self._cameras

    def _load(self, idx: int) -> dict:
        # stable per-(split, idx) seed (hash() is randomized per process)
        seed = zlib.crc32(f"{self.split}:{idx}".encode()) % (2**31)
        rng = np.random.RandomState(seed)
        h, w = self.height, self.width
        cfg = self._config
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
        if "normal" in self.sample_keys:
            normal = np.zeros((h, w, 3), dtype=np.float32)
            normal[..., 2] = 1.0
            sample["normal"] = normal
        return sample
