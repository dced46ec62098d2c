"""Loaders of the train and validation data (counterpart:
`emsanet_tpu/data.py`: the deterministic `RandomSamplerSubset`, the
`DataLoader` in its
'thread' worker mode, `DataHelper`, `TrainSubsetView` and
`get_datahelper`).

Batches have a fixed shape: the train loader shuffles per epoch (or
draws a sampler's subset) and drops the last partial batch; a validation
loader keeps the dataset's order and pads its last batch by repeating
the last sample, with `_valid_mask` marking the real ones. Each sample
is preprocessed with its own generator, seeded from (seed + epoch) *
1_000_003 + index, so a batch is the same whatever the number of
workers, and the same as the JAX package's. Worker threads preprocess
the samples of the current and the next `prefetch` batches while the
consumer works on earlier ones (a single batch too: its samples load in
parallel).

`--overfit-n-batches` trains on a fixed subset of that many batches
(`overfit_indices`), and `--validation-on-train` validates on that
subset through the test preprocessor (`TrainSubsetView`).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from emsanet_tpu_torch.config import NotPortedError
from emsanet_tpu_torch.datasets.synthetic import get_dataset
from emsanet_tpu_torch.preprocessing.collate import batch_collate


def overfit_indices(n_samples: int, n_batches: int, batch_size: int,
                    seed: int) -> np.ndarray:
    """The fixed subset of `n_batches` batches that `--overfit-n-batches`
    trains on, the same every epoch (the reference's
    `RandomSamplerSubset` in its deterministic mode)."""
    n_draw = max(int(round(n_samples * min(
        n_batches * batch_size / max(n_samples, 1), 1.0))), 1)
    rng = np.random.default_rng(seed)
    out = rng.permutation(n_samples)[:n_draw]
    rng.shuffle(out)
    return out


def _load_one(dataset, idx: int, rng_seed: int) -> dict:
    """Load and preprocess one sample with a deterministic generator."""
    sample = dataset.load_raw(idx)
    if dataset.preprocessor is not None:
        sample["_rng"] = np.random.default_rng(rng_seed)
        sample = dataset.preprocessor(sample)
        sample.pop("_rng", None)
    return sample


class DataLoader:
    """Prefetching batch loader with worker threads."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, n_workers: int = 4, seed: int = 0,
                 prefetch: int = 2, indices: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.indices = indices  # a fixed subset, drawn in this order
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        try:
            n_cores = len(os.sched_getaffinity(0))
        except AttributeError:  # not Linux
            n_cores = os.cpu_count() or 1
        self.n_workers = max(min(n_workers, n_cores), 1)
        self.seed = seed
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = (len(self.indices) if self.indices is not None
             else len(self.dataset))
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        if self.indices is not None:
            return self.indices
        if self.shuffle:
            return np.random.default_rng(self.seed + epoch).permutation(
                len(self.dataset))
        return np.arange(len(self.dataset))

    def _batch_indices(self, indices, b: int):
        idxs = indices[b * self.batch_size:(b + 1) * self.batch_size].tolist()
        n_real = len(idxs)
        while len(idxs) < self.batch_size:  # pad the last batch
            idxs.append(idxs[-1])
        return idxs, n_real

    def _collate(self, samples, n_real: int) -> Dict:
        batch = batch_collate(samples)
        batch["_valid_mask"] = np.arange(self.batch_size) < n_real
        return batch

    def batches(self, epoch: int = 0) -> Iterator[Dict]:
        indices = self._epoch_indices(epoch)
        n_batches = len(self)

        def seed_of(i):
            return (self.seed + epoch) * 1_000_003 + int(i)

        if self.n_workers <= 1:
            for b in range(n_batches):
                idxs, n_real = self._batch_indices(indices, b)
                yield self._collate([_load_one(self.dataset, int(i),
                                               seed_of(i)) for i in idxs],
                                    n_real)
            return
        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            def submit(b):
                idxs, n_real = self._batch_indices(indices, b)
                return [pool.submit(_load_one, self.dataset, int(i),
                                    seed_of(i)) for i in idxs], n_real

            pending = [submit(b)
                       for b in range(min(self.prefetch + 1, n_batches))]
            for b in range(n_batches):
                futs, n_real = pending.pop(0)
                samples = [f.result() for f in futs]
                if b + len(pending) + 1 < n_batches:
                    pending.append(submit(b + len(pending) + 1))
                yield self._collate(samples, n_real)


class DataHelper:
    """The train loader and the validation loaders, one per camera."""

    def __init__(self, dataset_train, dataset_valid, batch_size: int,
                 valid_batch_size: int, n_workers: int = 4,
                 train_indices: Optional[np.ndarray] = None, seed: int = 0):
        self.dataset_train = dataset_train
        self.dataset_valid = dataset_valid
        self.train_loader = DataLoader(
            dataset_train, batch_size, shuffle=True, drop_last=True,
            n_workers=n_workers, seed=seed, indices=train_indices)
        cameras = dataset_valid.cameras
        if len(cameras) > 1:
            raise NotPortedError("not ported yet: validation per camera of "
                                 "a dataset with several cameras")
        self.valid_loaders: Dict[str, DataLoader] = {
            cameras[0] if cameras else "default": DataLoader(
                dataset_valid, valid_batch_size, shuffle=False,
                drop_last=False, n_workers=n_workers, seed=seed)}

    def set_train_preprocessor(self, preprocessor):
        self.dataset_train.preprocessor = preprocessor

    def set_valid_preprocessor(self, preprocessor):
        self.dataset_valid.preprocessor = preprocessor


class TrainSubsetView:
    """A dataset restricted to fixed indices of a base dataset, with the
    base's preprocessor hook (`--validation-on-train`)."""

    def __init__(self, base, indices):
        self._base = base
        self._indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self._indices)

    def load_raw(self, idx):
        return self._base.load_raw(int(self._indices[idx]))

    @property
    def cameras(self):
        return self._base.cameras

    @property
    def preprocessor(self):
        return self._base.preprocessor

    @preprocessor.setter
    def preprocessor(self, value):
        self._base.preprocessor = value


def get_datahelper(cfg) -> DataHelper:
    """The data of a configuration (EMSANetConfig; 'synthetic' only). The
    validation data is the train split's overfit subset with
    `validation_on_train` and `overfit_n_batches`, the whole train split
    with `validation_on_train` alone, else the validation split."""
    d, m, t = cfg.data, cfg.model, cfg.train
    dataset_train = get_dataset(d, m, d.split)
    train_indices = None
    if t.overfit_n_batches > 0:
        train_indices = overfit_indices(len(dataset_train),
                                        t.overfit_n_batches, d.batch_size,
                                        t.seed)
    if t.validation_on_train:
        dataset_valid = get_dataset(d, m, d.split)
        if train_indices is not None:
            dataset_valid = TrainSubsetView(dataset_valid,
                                            np.sort(train_indices))
    else:
        dataset_valid = get_dataset(d, m, "valid")
    return DataHelper(dataset_train, dataset_valid, d.batch_size,
                      d.validation_batch_size or d.batch_size,
                      n_workers=d.n_workers, train_indices=train_indices,
                      seed=t.seed)
