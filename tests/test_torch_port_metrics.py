"""The port's validation metrics and task helpers
(`emsanet_tpu_torch/metrics.py`, `task_helper.py`) against the JAX
package's, on the CPU.

Both are numpy on the host, so every result must be equal. Batches are
the port's synthetic samples through its test preprocessor, padded to a
fixed batch with `_valid_mask`; predictions are the ground truth with
seeded noise: relabelled pixels, shifted and merged instances, angles
off by up to 0.5 rad, dense orientation fields in both layouts (full
resolution and parity planes).
"""

import numpy as np
import pytest

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import metrics as jax_metrics
from emsanet_tpu import task_helper as jax_th
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.postprocessing import interleave_planes_np as jax_interleave
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import metrics
from emsanet_tpu_torch import task_helper as th
from emsanet_tpu_torch.data import DataLoader
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.registry import get_dataset
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor

TASKS = ("semantic", "instance", "orientation", "scene")


def _cfg(h=48, w=64, n=5):
    return pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(tasks=TASKS, enable_panoptic=True,
                             input_height=h, input_width=w,
                             rgb_encoder_backbone="resnet18",
                             depth_encoder_backbone="resnet18"),
        data=pc.DataConfig(dataset="synthetic", batch_size=2,
                           synthetic_n_samples=n)))


def _batches(n=5, batch_size=2):
    """The validation batches of n synthetic samples (the last padded)."""
    cfg = _cfg(n=n)
    ds = get_dataset(cfg.data, cfg.model, "valid")
    ds.preprocessor = get_preprocessor(cfg, get_dataset_config("synthetic"),
                                       "test")
    return list(DataLoader(ds, batch_size, n_workers=1).batches(0))


def _predictions(batch, seed):
    """Noisy predictions of a batch, under the eval step's keys."""
    rng = np.random.RandomState(seed)
    sem = batch["semantic"].astype(np.int64)
    inst = batch["instance"].astype(np.int64)
    n, h, w = sem.shape
    sem_pred = np.where(rng.rand(n, h, w) < 0.1,
                        rng.randint(1, 41, (n, h, w)), sem)
    inst_pred = np.roll(inst, rng.randint(-3, 4), axis=2)
    inst_pred = np.where((inst_pred == 2) & (rng.rand(n, h, w) < 0.5), 1,
                         inst_pred)  # a partly merged instance
    is_thing = np.asarray(get_dataset_config("synthetic").classes_is_thing)
    pan = metrics.deeplab_merge_numpy(sem_pred, inst_pred, is_thing)
    angles = rng.uniform(0, 2 * np.pi, (n, 64)).astype(np.float32)
    for b, ori in enumerate(batch["orientations_present"]):
        for iid, theta in ori.items():
            angles[b, iid - 1] = theta + rng.uniform(-0.5, 0.5)
    dense = rng.randn(n, h, w, 2).astype(np.float32)
    for b, ori in enumerate(batch["orientations_present"]):
        for iid, theta in ori.items():
            m = inst[b] == iid
            dense[b][m] = (np.sin(theta + 0.2), np.cos(theta + 0.2))
    planes = dense.transpose(0, 3, 1, 2).reshape(n, 2, h // 2, 2, w // 2, 2)
    planes = planes.transpose(0, 1, 3, 5, 2, 4).reshape(n, 2, 4, h // 2,
                                                        w // 2)
    return {
        "semantic_segmentation_idx": (sem_pred - 1).clip(0).astype(np.int32),
        "scene_class_idx": rng.randint(0, 8, n).astype(np.int32),
        "instance_segmentation": inst_pred.astype(np.int32),
        "instance_segmentation_gt_foreground": np.roll(
            inst, 1, axis=1).astype(np.int32),
        "panoptic_segmentation_deeplab": pan.astype(np.int32),
        "orientations_instance": angles,
        "instance_orientation": dense,
        "instance_orientation_planes": np.ascontiguousarray(planes),
    }


def _run_helpers(helpers, batches, drop=()):
    for h in helpers:
        h.initialize()
    for i, batch in enumerate(batches):
        preds = {k: v for k, v in _predictions(batch, i).items()
                 if k not in drop}
        for h in helpers:
            h.validation_step(batch, preds)
    return [h.validation_epoch_end() for h in helpers]


def _same(got, want):
    assert type(got) is type(want), (got, want)
    if isinstance(got, dict):
        assert list(got) == list(want)
        for k in got:
            _same(got[k], want[k])
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 6, (3, 20, 30))
    target = np.where(rng.rand(3, 20, 30) < 0.7, pred,
                      rng.randint(0, 6, (3, 20, 30)))
    got, want = metrics.MeanIoU(6), jax_metrics.MeanIoU(6)
    for m in (got, want):
        m.update(pred, target)
        m.update(target, pred)
    _same((got.compute(), got.per_class_iou(), got.confusion),
          (want.compute(), want.per_class_iou(), want.confusion))
    got, want = metrics.BalancedAccuracy(6), jax_metrics.BalancedAccuracy(6)
    for m in (got, want):
        m.update(pred[:, 0, 0], target[:, 0, 0])
        m.update(pred[0, 0], target[0, 0])
    assert got.compute() == want.compute()
    got, want = (metrics.MeanAbsoluteAngularError(),
                 jax_metrics.MeanAbsoluteAngularError())
    a, b = rng.uniform(-7, 7, 50), rng.uniform(-7, 7, 50)
    for m in (got, want):
        m.update(a, b)
    assert got.compute() == want.compute()
    is_thing = [False, False, True, True, True, False]
    inst = rng.randint(0, 4, (3, 20, 30))
    inst_p = np.where(rng.rand(3, 20, 30) < 0.8, inst, 0)
    pan_t = jax_metrics.deeplab_merge_numpy(target, inst, is_thing)
    _same(metrics.deeplab_merge_numpy(target, inst, is_thing), pan_t)
    pan_p = metrics.deeplab_merge_numpy(pred, inst_p, is_thing)
    got = metrics.PanopticQuality(6, is_thing)
    want = jax_metrics.PanopticQuality(6, is_thing)
    _same(got.update(pan_p, pan_t), want.update(pan_p, pan_t))
    _same(got.update(pan_t[0], pan_t[0]), want.update(pan_t[0], pan_t[0]))
    _same(got.compute(), want.compute())
    _same(got.match_segments(pan_p[1], pan_t[1]),
          want.match_segments(pan_p[1], pan_t[1]))


def test_interleave_planes_np_matches_jax():
    planes = np.random.RandomState(1).randn(2, 3, 4, 5, 7)
    _same(th.interleave_planes_np(planes), jax_interleave(planes))


@pytest.mark.parametrize("layout", ["full-res", "planes"])
def test_task_helpers_match_jax(layout):
    """Every helper, over padded batches: the same logs and artifacts."""
    batches = _batches()
    assert not batches[-1]["_valid_mask"].all()
    drop = (("instance_orientation_planes",) if layout == "full-res"
            else ("instance_orientation",))
    cfg = _cfg()
    got = th.get_task_helpers(cfg, get_dataset_config("synthetic"))
    want = jax_th.get_task_helpers(
        cfg, jax_ds_config(JaxDataConfig(dataset="synthetic")))
    assert [type(h).__name__ for h in got] == [
        type(h).__name__ for h in want]
    results = _run_helpers(got, batches, drop)
    _same(results, _run_helpers(want, batches, drop))
    logs = {k: v for _, lg in results for k, v in lg.items()}
    # the noise leaves every metric away from its trivial value
    assert 0.3 < logs["semantic_miou"] < 1.0
    assert 0.0 < logs["panoptic_all_with_gt_deeplab_pq"] < 1.0
    assert 0.0 < logs["orientation_mae_gt_deg"] < 90.0
    assert 0.0 < logs["panoptic_mae_deeplab_deg"] < 90.0
