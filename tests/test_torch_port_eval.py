"""The port's eval step and validation (`training/step.py::
make_eval_step`, `train.py::run_validation`) against the JAX package's,
on the CPU.

Model: R18 flagship (semantic, instance, orientation, scene, panoptic)
at 64x96, f32, train-model weights drawn with numpy from the flax tree's
shapes and carried across by `weights.load_flax_variables`; inputs: the
synthetic validation samples through the test preprocessor, with the
ground-truth foreground. Integer maps and masks must be equal, as in
`test_torch_port_postprocess.py`; float outputs (head maps, scores,
angles) come from the forward, which agrees to atol 1e-4 / rtol 1e-3
(conv accumulation order, as `test_torch_port_model.py`), and are held
to that. `run_validation` is held against the
reference's pieces composed as `main.py:242-278` composes them, given
the same predictions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import _random_variables

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu import native as jax_native
from emsanet_tpu import task_helper as jax_th
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.data import get_datahelper as jax_datahelper
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu.preprocessing import get_preprocessor as jax_preprocessor
from emsanet_tpu.training.step import make_eval_step as jax_eval_step
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.weights import load_flax_variables

H, W = 64, 96
TASKS = ("semantic", "instance", "orientation", "scene")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: an idle pool's threads would spin
    beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def jax_native_path():
    """The JAX package's native path: the port always takes its own host
    library, a copy of the JAX package's built with the same flags, so
    the two give the same bits."""
    assert jax_native.get_lib() is not None, (
        "the JAX package's native library is not available")


def _cfgs(n=3, batch_size=2):
    model = dict(tasks=TASKS, enable_panoptic=True, input_height=H,
                 input_width=W, rgb_encoder_backbone="resnet18",
                 depth_encoder_backbone="resnet18", fused_training=True)
    d = dict(dataset="synthetic", batch_size=batch_size,
             validation_batch_size=batch_size, synthetic_n_samples=n,
             n_workers=1)
    port = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(fused_inference=True, **model),
        data=pc.DataConfig(**d),
        train=pc.TrainConfig(skip_sanity_check=True)))
    ref = JaxEMSANetConfig(model=JaxModelConfig(fused_inference=True, **model),
                           data=JaxDataConfig(**d),
                           train=JaxTrainConfig()).validate()
    return port, ref


@pytest.fixture(scope="module")
def both():
    """(port Run with the flax weights, JAX eval step and variables, the
    JAX data helper): one JAX compile for the module."""
    port, ref = _cfgs()
    jds = jax_ds_config(ref.data)
    jmodel = JaxEMSANet(cfg=ref.model, dataset_config=jds)
    shapes = jax.eval_shape(
        lambda k: init_model(jmodel, k, batch_size=1, train=True),
        jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), 11)
    run = trainer.setup(port, "cpu")
    load_flax_variables(run.model, variables)
    is_thing = jnp.asarray(jds.semantic_label_list.classes_is_thing)
    use_orient = jnp.asarray(
        jds.semantic_label_list.classes_use_orientations)
    step = jax.jit(jax_eval_step(jmodel, ref, is_thing,
                                 use_orientations=use_orient))
    jhelper = jax_datahelper(ref)
    jhelper.set_valid_preprocessor(jax_preprocessor(ref, jds, "test"))
    return run, step, variables, jhelper, ref


def _jax_preds(step, variables, batch):
    out = step(variables["params"], variables["batch_stats"],
               {k: jnp.asarray(batch[k]) for k in trainer.EVAL_KEYS})
    return {k: np.asarray(v) for k, v in out.items()}


def _port_preds(run, batch):
    out = run.eval_step({k: torch.from_numpy(batch[k])
                         for k in trainer.EVAL_KEYS})
    return {k: v.numpy() for k, v in out.items()}


def test_eval_step_matches_jax(both):
    run, step, variables, jhelper, _ = both
    (loader,) = run.data.valid_loaders.values()
    batches = list(loader.batches(0))
    assert len(batches) == 2 and not batches[-1]["_valid_mask"].all()
    for batch in batches:
        want = _jax_preds(step, variables, batch)
        got = _port_preds(run, batch)
        assert sorted(got) == sorted(want)
        for k in want:
            w, g = want[k], got[k]
            assert w.shape == g.shape and w.dtype == g.dtype, k
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-3,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        assert want["instance_centers_valid"].sum() >= 2
        assert (want["instance_segmentation_gt_foreground"] > 0).any()


def test_eval_step_restores_the_mode(both):
    run = both[0]
    batch = next(iter(run.data.valid_loaders["synth0"].batches(0)))
    inputs = {k: torch.from_numpy(batch[k]) for k in trainer.EVAL_KEYS}
    for mode in (True, False):
        run.model.train(mode)
        run.eval_step(inputs)
        assert run.model.training is mode
        assert all(m.training is mode for m in run.model.modules())
    run.model.train()


def test_run_validation_matches_reference_composition(both, monkeypatch,
                                                      tmp_path):
    """Given the JAX eval step's predictions, the port's run_validation
    gives the logs and artifacts of the reference's loop: its data
    helper, task helpers and artifact files."""
    run, step, variables, jhelper, ref = both
    monkeypatch.setattr(run, "eval_step", lambda b: {
        k: torch.from_numpy(np.array(v)) for k, v in _jax_preds(
            step, variables, {k: t.numpy() for k, t in b.items()}).items()})
    got = trainer.run_validation(run, 3, str(tmp_path))

    helpers = jax_th.get_task_helpers(ref, jax_ds_config(ref.data))
    for th in helpers:
        th.initialize()
    for loader in jhelper.valid_loaders.values():
        for batch in loader.batches(0):
            preds = _jax_preds(step, variables, batch)
            for th in helpers:
                th.validation_step(batch, preds)
    want, artifacts = {}, {}
    for th in helpers:
        arts, logs = th.validation_epoch_end()
        want.update({f"valid_{k}": v for k, v in logs.items()})
        artifacts.update(arts)
    assert list(got) == list(want)
    assert got == want
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{name}_epoch_3.npy" for name in artifacts)
    for name, arr in artifacts.items():
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{name}_epoch_3.npy"), arr)
