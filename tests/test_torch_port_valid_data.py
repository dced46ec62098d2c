"""The port's validation data (test-phase preprocessor, overfit subset,
validation loaders, `get_datahelper`) against the JAX package's, on the
CPU, bit for bit.

Both sides run their native host libraries (the port's is a copy of
the JAX package's, built with the same flags). Sizes: 48x64 synthetic
samples, validated at the input size; the resize on its own from 48x64
to 32x48.
"""

import numpy as np
import pytest

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu import data as jax_data
from emsanet_tpu import native as jax_native
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.datasets.registry import get_dataset as jax_get_dataset
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.preprocessing import get_preprocessor as jax_preprocessor
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import data
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.registry import get_dataset
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor

H, W = 48, 64
TASKS = ("semantic", "instance", "orientation", "scene")


@pytest.fixture(autouse=True)
def jax_native_path():
    """The JAX package's native path: the port always takes its own host
    library, a copy of the JAX package's built with the same flags, so
    the two give the same bits."""
    assert jax_native.get_lib() is not None, (
        "the JAX package's native library is not available")


def _cfgs(tasks=TASKS, n=6, batch_size=2, **train):
    model = dict(tasks=tasks, enable_panoptic="instance" in tasks,
                 input_height=H, input_width=W,
                 rgb_encoder_backbone="resnet18",
                 depth_encoder_backbone="resnet18")
    d = dict(dataset="synthetic", batch_size=batch_size,
             validation_batch_size=batch_size, synthetic_n_samples=n,
             n_workers=2)
    port = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(**model), data=pc.DataConfig(**d),
        train=pc.TrainConfig(**train)))
    ref = JaxEMSANetConfig(model=JaxModelConfig(**model),
                           data=JaxDataConfig(**d),
                           train=JaxTrainConfig(**train)).validate()
    return port, ref


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("tasks", [TASKS, ("semantic", "scene")])
@pytest.mark.parametrize("keep_raw_inputs", [True, False])
def test_test_phase_samples_match_jax(tasks, keep_raw_inputs):
    port, ref = _cfgs(tasks)
    ds = get_dataset(port.data, port.model, "valid")
    ds.preprocessor = get_preprocessor(port, get_dataset_config("synthetic"),
                                       "test", keep_raw_inputs=keep_raw_inputs)
    jds = jax_get_dataset(ref.data, ref.model, "valid")
    jds.preprocessor = jax_preprocessor(ref, jax_ds_config(ref.data), "test",
                                        keep_raw_inputs=keep_raw_inputs)
    for i in range(3):
        got, want = ds[i], jds[i]
        _same(got, want)
        assert ("_no_preprocessing" in got) == keep_raw_inputs
        assert ("panoptic_fullres" in got) == ("instance" in tasks)
        assert got["rgb"].shape[:2] == (H, W)


def test_resize_matches_jax():
    """The test phase's resize on its own, 48x64 to 32x48, after the
    full-resolution copies: every key as the JAX package's, bit for bit."""
    from emsanet_tpu.preprocessing import transforms as jax_transforms
    from emsanet_tpu_torch.preprocessing import transforms

    port, ref = _cfgs()
    ds = get_dataset(port.data, port.model, "valid")
    jds = jax_get_dataset(ref.data, ref.model, "valid")
    keys = ("rgb", "depth", "semantic", "normal", "instance", "panoptic")
    for i in range(2):
        got = transforms.FullResCloner(keys)(ds.load_raw(i))
        want = jax_transforms.FullResCloner(keys)(jds.load_raw(i))
        got = transforms.Resize(32, 48)(got)
        want = jax_transforms.Resize(32, 48)(want)
        _same(got, want)
        assert got["rgb"].shape[:2] == (32, 48)
        assert got["rgb_fullres"].shape[:2] == (H, W)


def test_overfit_subset_matches_jax():
    for n, batches, batch_size, seed in ((64, 1, 8, 0), (10, 2, 3, 5),
                                         (5, 4, 2, 1)):
        got = data.overfit_indices(n, batches, batch_size, seed)
        want = jax_data.RandomSamplerSubset(
            n, subset=min(batches * batch_size / n, 1.0),
            deterministic=True, seed=seed)
        assert len(got) == want.n_draw
        for epoch in (0, 3):
            np.testing.assert_array_equal(got, want.indices(epoch))


@pytest.mark.parametrize("case", ["overfit, validation on train",
                                  "validation on train", "valid split"])
def test_datahelper_batches_match_jax(case):
    """The train loader's batches (the overfit subset each epoch) and the
    validation batches, the last padded with `_valid_mask`."""
    train = {"overfit, validation on train": dict(
                 overfit_n_batches=2, validation_on_train=True),
             "validation on train": dict(validation_on_train=True),
             "valid split": {}}[case]
    port, ref = _cfgs(n=7, batch_size=2, **train)
    helper = data.get_datahelper(port)
    jhelper = jax_data.get_datahelper(ref)
    ds_port, ds_ref = get_dataset_config("synthetic"), jax_ds_config(ref.data)
    helper.set_train_preprocessor(get_preprocessor(
        port, ds_port, "train",
        multiscale_downscales=port.model.side_output_downscales))
    jhelper.set_train_preprocessor(jax_preprocessor(
        ref, ds_ref, "train",
        multiscale_downscales=ref.model.side_output_downscales))
    helper.set_valid_preprocessor(get_preprocessor(port, ds_port, "test"))
    jhelper.set_valid_preprocessor(jax_preprocessor(ref, ds_ref, "test"))
    assert len(helper.train_loader) == len(jhelper.train_loader)
    for epoch in (0, 1):
        _same(list(helper.train_loader.batches(epoch)),
              list(jhelper.train_loader.batches(epoch)))
    assert list(helper.valid_loaders) == list(jhelper.valid_loaders)
    (loader,), (jloader,) = (helper.valid_loaders.values(),
                             jhelper.valid_loaders.values())
    got, want = list(loader.batches(0)), list(jloader.batches(0))
    _same(got, want)
    n_valid = {"overfit, validation on train": 4}.get(case, 7)
    assert len(got) == -(-n_valid // 2)
    assert int(sum(b["_valid_mask"].sum() for b in got)) == n_valid
    if n_valid % 2:
        assert got[-1]["_valid_mask"].tolist() == [True, False]


def test_single_batch_loads_in_worker_threads(monkeypatch):
    """A loader of one batch loads its samples in the worker pool, and
    gives the batch the serial path gives."""
    port, _ = _cfgs(n=4, batch_size=4, overfit_n_batches=1)
    helper = data.get_datahelper(port)
    helper.set_train_preprocessor(get_preprocessor(
        port, get_dataset_config("synthetic"), "train"))
    loader = helper.train_loader
    assert len(loader) == 1 and loader.n_workers > 1
    threads = set()
    load_one = data._load_one

    def spy(*a):
        import threading

        threads.add(threading.current_thread().name)
        return load_one(*a)

    monkeypatch.setattr(data, "_load_one", spy)
    (pooled,) = loader.batches(0)
    assert not threads & {"MainThread"}
    loader.n_workers = 1
    (serial,) = loader.batches(0)
    assert threads & {"MainThread"}
    _same(pooled, serial)
