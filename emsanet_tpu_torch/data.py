"""The training loader (counterpart: the `DataLoader` of
`emsanet_tpu/data.py`, :118-190, in its 'thread' worker mode).

Batches have a fixed shape: the train loader shuffles per epoch and drops
the last partial batch. Each sample is preprocessed with its own
generator, seeded from (seed + epoch) * 1_000_003 + index, so a batch is
the same whatever the number of workers, and the same as the JAX
package's. Worker threads preprocess samples of the next `prefetch`
batches while the consumer trains on the current one.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from emsanet_tpu_torch.preprocessing.collate import batch_collate


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
                 prefetch: int = 2):
        self.dataset = dataset
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
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
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

        if self.n_workers <= 1 or n_batches <= 1:
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
