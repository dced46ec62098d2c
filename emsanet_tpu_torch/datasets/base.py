"""The dataset base: sample access, the cache, the preprocessor hook,
camera filters, semantic class weights and concatenation.

A copy of `emsanet_tpu/datasets/base.py::SceneAnalysisDataset` and
`ConcatDataset`. Samples are dicts of numpy arrays:

    rgb           (h, w, 3) uint8
    depth         (h, w) float32, raw sensor units (e.g. millimetres)
    semantic      (h, w) int32, 0 = void
    instance      (h, w) int32, 0 = no instance
    orientations  {instance id: yaw in radians}
    scene         int
    identifier    SampleIdentifier, e.g. ('test', '0001')

A subclass implements `__len__`, `_load(idx)` and `config`.
`__getitem__` applies `preprocessor` (dict -> dict) to `load_raw(idx)`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from emsanet_tpu_torch.datasets.metadata import DatasetConfig


class SampleIdentifier(tuple):
    """Hierarchical sample identifier, e.g. ('train', '0001')."""

    def to_filename(self, separator: str = "__") -> str:
        return separator.join(self)


def _copy(sample: dict) -> dict:
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in sample.items()}


class SceneAnalysisDataset:
    """Map-style dataset of sample dicts."""

    def __init__(self, sample_keys: Sequence[str], use_cache: bool = False):
        self.sample_keys = tuple(sample_keys)
        self.preprocessor = None
        self._use_cache = use_cache
        self._cache: Dict[int, dict] = {}

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def _load(self, idx: int) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def config(self) -> DatasetConfig:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def cameras(self) -> Tuple[str, ...]:
        return ("default",)

    def filter_camera(self, camera: str) -> "SceneAnalysisDataset":
        self._camera = camera
        return self

    def __getstate__(self):
        # a process worker gets the dataset without its cache: what a
        # worker caches dies with it
        state = dict(self.__dict__)
        state["_cache"] = {}
        return state

    def load_raw(self, idx: int) -> dict:
        """A sample without the preprocessor, from the cache where on."""
        if self._use_cache and idx in self._cache:
            return _copy(self._cache[idx])
        sample = self._load(idx)
        if self._use_cache:
            self._cache[idx] = _copy(sample)
        return sample

    def __getitem__(self, idx: int) -> dict:
        sample = self.load_raw(idx)
        if self.preprocessor is not None:
            sample = self.preprocessor(sample)
        return sample

    def semantic_compute_class_weights(self, weight_mode: str =
                                       "median-frequency",
                                       c: float = 1.02) -> np.ndarray:
        """Weights of the semantic CE for classes 1..C (void excluded),
        from every sample's labels: median-frequency w_c = median(freq) /
        freq_c, logarithmic w_c = 1 / ln(c + p_c), linear 1 - p_c, none 1.
        """
        n_classes = len(self.config.semantic_class_names)
        counts = np.zeros(n_classes, dtype=np.int64)
        pixel_totals = np.zeros(n_classes, dtype=np.int64)
        for i in range(len(self)):
            sem = self._load(i)["semantic"]
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


class ConcatDataset(SceneAnalysisDataset):
    """Datasets of one sample contract, one after the other."""

    def __init__(self, datasets: Sequence[SceneAnalysisDataset]):
        if not datasets:
            raise ValueError("ConcatDataset of no datasets")
        super().__init__(sample_keys=datasets[0].sample_keys)
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    @property
    def config(self) -> DatasetConfig:
        return self.datasets[0].config

    @property
    def cameras(self) -> Tuple[str, ...]:
        cams: List[str] = []
        for d in self.datasets:
            cams.extend(d.cameras)
        return tuple(dict.fromkeys(cams))

    def _load(self, idx: int) -> dict:
        ds_idx = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[ds_idx]._load(idx - int(self._offsets[ds_idx]))

    def semantic_compute_class_weights(self, *args, **kwargs) -> np.ndarray:
        """The members' weights, averaged per class over the members that
        have the class."""
        weights = [d.semantic_compute_class_weights(*args, **kwargs)
                   for d in self.datasets]
        max_len = max(len(w) for w in weights)
        acc = np.zeros(max_len, dtype=np.float64)
        cnt = np.zeros(max_len, dtype=np.int64)
        for w in weights:
            acc[:len(w)] += w
            cnt[:len(w)] += 1
        return (acc / np.maximum(cnt, 1)).astype(np.float32)
