"""Loaders of the train and validation data (counterpart:
`emsanet_tpu/data.py`: `RandomSamplerSubset`, the `DataLoader` with
thread or process workers, `DataHelper` with one validation loader per
camera, `TrainSubsetView` and `get_datahelper`).

Batches have a fixed shape: the train loader shuffles per epoch (or
draws a sampler's subset) and drops the last partial batch; a validation
loader keeps the dataset's order and pads its last batch by repeating
the last sample, with `_valid_mask` marking the real ones. Each sample
is preprocessed with its own generator, seeded from (seed + epoch) *
1_000_003 + index, so a batch is the same whatever the number and kind
of workers, and the same as the JAX package's. Workers preprocess the
samples of the current and the next `prefetch` batches while the
consumer works on earlier ones (a single batch too: its samples load in
parallel).

`worker_mode='thread'` loads in a thread pool: the PNG inflate and the
host library's calls release the GIL. `'process'` loads in worker
processes started from a forkserver, never forked from the trainer, so
they hold none of the trainer's CUDA state or threads; each gets the
dataset once (pickled, without its cache or mapped files) and sends back
preprocessed samples. Starting a worker costs an interpreter and its
imports (multiprocessing also imports the launching script's main
module in it: torch, but no CUDA, under `python -m
emsanet_tpu_torch.train`), so a loader keeps its workers from epoch to
epoch while its dataset's preprocessor stays the same object; `close()`
stops them. Validation loaders use threads, as in the JAX package.

`--overfit-n-batches` trains on a fixed subset of that many batches
(`overfit_indices`), and `--validation-on-train` validates on that
subset through the test preprocessor (`TrainSubsetView`).
`--subset-train` draws a fraction of the train data each epoch, one
fraction per concatenated dataset where given several.
"""

from __future__ import annotations

import contextlib
import copy
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from emsanet_tpu_torch import native
from emsanet_tpu_torch.datasets.registry import get_dataset
from emsanet_tpu_torch.preprocessing.collate import batch_collate


class RandomSamplerSubset:
    """A random subset of the samples each epoch (the same subset every
    epoch when `deterministic`). `subset`: one fraction in (0, 1], or one
    per concatenated dataset with `section_lengths` their sizes."""

    def __init__(self, n_samples: int, subset=1.0,
                 deterministic: bool = False, seed: int = 0,
                 section_lengths: Optional[Sequence[int]] = None):
        self.n_samples = n_samples
        fractions = ((float(subset),) if np.isscalar(subset)
                     else tuple(subset))
        if len(fractions) == 1:
            self.sections = ((0, n_samples, fractions[0]),)
        else:
            if section_lengths is None or len(section_lengths) != len(
                    fractions):
                raise ValueError(
                    f"{len(fractions)} subset fractions need "
                    f"{len(fractions)} concatenated datasets (got lengths "
                    f"{section_lengths})")
            offsets = np.cumsum([0] + list(section_lengths))
            if int(offsets[-1]) != n_samples:
                raise ValueError(f"section lengths {section_lengths} do "
                                 f"not add up to {n_samples}")
            self.sections = tuple(
                (int(offsets[i]), int(section_lengths[i]), fractions[i])
                for i in range(len(fractions)))
        self.deterministic = deterministic
        self.seed = seed

    @property
    def n_draw(self) -> int:
        return sum(max(int(round(n * frac)), 1)
                   for _, n, frac in self.sections)

    def indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(
            self.seed if self.deterministic else self.seed + epoch)
        parts = [offset + rng.permutation(n)[:max(int(round(n * frac)), 1)]
                 for offset, n, frac in self.sections]
        out = np.concatenate(parts)
        rng.shuffle(out)  # interleave the datasets within the epoch
        return out


def _overfit_sampler(n_samples: int, n_batches: int, batch_size: int,
                     seed: int) -> RandomSamplerSubset:
    return RandomSamplerSubset(
        n_samples, subset=min(n_batches * batch_size / max(n_samples, 1),
                              1.0),
        deterministic=True, seed=seed)


def overfit_indices(n_samples: int, n_batches: int, batch_size: int,
                    seed: int) -> np.ndarray:
    """The fixed subset of `n_batches` batches that `--overfit-n-batches`
    trains on, the same every epoch."""
    return _overfit_sampler(n_samples, n_batches, batch_size,
                            seed).indices(0)


def _load_one(dataset, idx: int, rng_seed: int) -> dict:
    """Load and preprocess one sample with a deterministic generator."""
    sample = dataset.load_raw(idx)
    if dataset.preprocessor is not None:
        sample["_rng"] = np.random.default_rng(rng_seed)
        sample = dataset.preprocessor(sample)
        sample.pop("_rng", None)
    return sample


# a process worker's dataset, set once by the pool's initializer
_WORKER_DATASET = None


def _process_worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _load_one_in_worker(idx: int, rng_seed: int) -> dict:
    return _load_one(_WORKER_DATASET, idx, rng_seed)


def _process_pool(dataset, n_workers: int) -> ProcessPoolExecutor:
    """Worker processes from a forkserver that preloads this module (its
    imports are numpy-only); the host library is built here first, so the
    workers only load it."""
    native.get_lib()
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx,
                               initializer=_process_worker_init,
                               initargs=(dataset,))


class DataLoader:
    """Prefetching batch loader with thread or process workers."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, n_workers: int = 4,
                 sampler: Optional[RandomSamplerSubset] = None,
                 seed: int = 0, prefetch: int = 2,
                 worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"Unknown worker_mode '{worker_mode}'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        try:
            n_cores = len(os.sched_getaffinity(0))
        except AttributeError:  # not Linux
            n_cores = os.cpu_count() or 1
        self.n_workers = max(min(n_workers, n_cores), 1)
        self.sampler = sampler
        self.seed = seed
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self._processes: Optional[ProcessPoolExecutor] = None
        self._processes_preprocessor = None

    def _process_workers(self) -> ProcessPoolExecutor:
        """The worker processes, started anew where the dataset's
        preprocessor changed."""
        if (self._processes is None or self._processes_preprocessor
                is not self.dataset.preprocessor):
            self.close()
            self._processes = _process_pool(self.dataset, self.n_workers)
            self._processes_preprocessor = self.dataset.preprocessor
        return self._processes

    def close(self) -> None:
        """Stop the worker processes, if any."""
        if self._processes is not None:
            self._processes.shutdown(wait=True, cancel_futures=True)
            self._processes = None

    def __len__(self) -> int:
        n = (self.sampler.n_draw if self.sampler is not None
             else len(self.dataset))
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        if self.sampler is not None:
            return self.sampler.indices(epoch)
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
        if self.worker_mode == "process":
            pool_cm = contextlib.nullcontext(self._process_workers())

            def submit_one(pool, i):
                return pool.submit(_load_one_in_worker, int(i), seed_of(i))
        else:
            pool_cm = ThreadPoolExecutor(max_workers=self.n_workers)

            def submit_one(pool, i):
                return pool.submit(_load_one, self.dataset, int(i),
                                   seed_of(i))
        with pool_cm as pool:
            def submit(b):
                idxs, n_real = self._batch_indices(indices, b)
                return [submit_one(pool, i) for i in idxs], n_real

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
                 subset_train=1.0, subset_deterministic: bool = False,
                 overfit_n_batches: int = -1, seed: int = 0,
                 worker_mode: str = "thread"):
        self.dataset_train = dataset_train
        self.dataset_valid = dataset_valid
        sampler = None
        if overfit_n_batches > 0:
            sampler = _overfit_sampler(len(dataset_train), overfit_n_batches,
                                       batch_size, seed)
        else:
            fractions = ((float(subset_train),) if np.isscalar(subset_train)
                         else tuple(subset_train))
            if len(fractions) > 1 or fractions[0] < 1.0:
                sections = ([len(d) for d in dataset_train.datasets]
                            if hasattr(dataset_train, "datasets") else None)
                sampler = RandomSamplerSubset(
                    len(dataset_train),
                    fractions if len(fractions) > 1 else fractions[0],
                    subset_deterministic, seed, section_lengths=sections)
        self.train_loader = DataLoader(
            dataset_train, batch_size, shuffle=True, drop_last=True,
            n_workers=n_workers, sampler=sampler, seed=seed,
            worker_mode=worker_mode)
        cameras = dataset_valid.cameras
        self.valid_loaders: Dict[str, DataLoader] = {}
        if len(cameras) <= 1:
            self.valid_loaders[cameras[0] if cameras else "default"] = (
                DataLoader(dataset_valid, valid_batch_size, shuffle=False,
                           drop_last=False, n_workers=n_workers, seed=seed))
        else:
            for cam in cameras:
                ds = copy.deepcopy(dataset_valid).filter_camera(cam)
                self.valid_loaders[cam] = DataLoader(
                    ds, valid_batch_size, shuffle=False, drop_last=False,
                    n_workers=n_workers, seed=seed)

    def set_train_preprocessor(self, preprocessor):
        self.dataset_train.preprocessor = preprocessor

    def set_valid_preprocessor(self, preprocessor):
        self.dataset_valid.preprocessor = preprocessor
        for loader in self.valid_loaders.values():
            loader.dataset.preprocessor = preprocessor

    def close(self) -> None:
        """Stop every loader's worker processes."""
        for loader in (self.train_loader, *self.valid_loaders.values()):
            loader.close()


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
    """The data of a configuration (EMSANetConfig). The validation data is
    the train split's overfit subset with `validation_on_train` and
    `overfit_n_batches` (the whole train split where it has several
    cameras), the whole train split with `validation_on_train` alone,
    else the `validation_split`."""
    d, m, t = cfg.data, cfg.model, cfg.train
    dataset_train = get_dataset(d, m, d.split)
    if t.validation_on_train:
        dataset_valid = get_dataset(d, m, d.split)
        if t.overfit_n_batches > 0:
            if len(dataset_valid.cameras) > 1:
                print("[emsanet-torch] --validation-on-train: a dataset "
                      "with several cameras; validating on the whole train "
                      "split")
            else:
                dataset_valid = TrainSubsetView(dataset_valid, np.sort(
                    overfit_indices(len(dataset_train), t.overfit_n_batches,
                                    d.batch_size, t.seed)))
    else:
        dataset_valid = get_dataset(d, m, d.validation_split)
    return DataHelper(dataset_train, dataset_valid, d.batch_size,
                      d.validation_batch_size or d.batch_size,
                      n_workers=d.n_workers, subset_train=d.subset_train,
                      subset_deterministic=d.subset_deterministic,
                      overfit_n_batches=t.overfit_n_batches, seed=t.seed,
                      worker_mode=d.worker_mode)
