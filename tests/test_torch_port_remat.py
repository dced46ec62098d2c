"""`--remat` (`ModelConfig.remat`): each encoder stage and each dense
decoder module recomputed in the backward pass (`torch.utils.checkpoint`
through `models/layers.py::remat_call`), on the CPU.

- The wrapped modules are those the JAX package wraps in `nn.remat`
  (`emsanet_tpu/models/backbone.py:262`, `decoder.py:252-253`).
- One f32 step with remat equals one without to 1e-6 in the losses, the
  gradients, the parameters and the BatchNorm buffers, with dropout on
  (the recompute draws the same masks) and with the fused train pairs
  (`MIN_PIXELS` = 0: every NBt1D tail through the pairs' plain versions
  inside the recomputed regions). The running statistics update once.
- The port's remat step against the JAX package's remat step
  (`make_train_step` with `remat=True`), R18 64x64 b4 dropout 0, with
  the bounds of `tests/test_torch_port_train.py`: losses rtol 1e-4,
  BatchNorm statistics atol 1e-4 / rtol 1e-3, gradients and updated
  parameters by the relative norm against the port's f64 remat step
  (< 5e-2 over all tensors, < 0.5 per tensor).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_port_model import _random_variables
from test_torch_port_train import (
    B,
    _jax_step,
    _model_kwargs,
    _norm_check,
    _port_batch,
)
from torch_port_plain import plain_host_library

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models import layers
from emsanet_tpu_torch.models.backbone import ResNetStage
from emsanet_tpu_torch.models.decoder import DecoderModule
from emsanet_tpu_torch.models.emsanet import EMSANet
from emsanet_tpu_torch.ops import nbt1d_train
from emsanet_tpu_torch.training.optim import get_optimizer
from emsanet_tpu_torch.training.step import (
    extract_device_batch,
    make_train_step,
)
from emsanet_tpu_torch.weights import load_flax_variables

TASKS = ("semantic", "instance", "orientation", "scene")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def all_pairs():
    """Every NBt1D tail through the train pairs (their plain versions)."""
    old = nbt1d_train.MIN_PIXELS
    nbt1d_train.MIN_PIXELS = 0
    yield
    nbt1d_train.MIN_PIXELS = old


def _cfg(remat, fused, **model):
    model = {**dict(tasks=TASKS, enable_panoptic=True, input_height=64,
                    input_width=96, rgb_encoder_backbone="resnet18",
                    depth_encoder_backbone="resnet18"), **model}
    return pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(fused_training=fused, remat=remat, **model),
        data=pc.DataConfig(dataset="synthetic", batch_size=2,
                           synthetic_n_samples=2, n_workers=1,
                           class_weighting="none"),
        train=pc.TrainConfig(skip_sanity_check=True)))


def test_remat_wraps_the_jax_modules():
    """Every encoder stage and every dense decoder module, nothing else;
    none without the flag."""
    cfg = _cfg(True, True, tasks=("semantic", "instance", "normal"),
               enable_panoptic=False, semantic_decoder="segformermlp")
    model = EMSANet(cfg.model, get_dataset_config("synthetic"), train=True)
    wrapped = sorted(n for n, m in model.named_modules()
                     if getattr(m, "remat", False))
    want = sorted([f"encoder.{mod}_stage{i}" for mod in ("rgb", "depth")
                   for i in range(4)]
                  + [f"{t}_decoder.module{i}" for t in ("instance", "normal")
                     for i in range(3)])
    assert wrapped == want
    for n, m in model.named_modules():
        assert isinstance(m, (ResNetStage, DecoderModule)) == (n in want), n
    plain = EMSANet(_cfg(False, True).model, get_dataset_config("synthetic"),
                    train=True)
    assert not any(getattr(m, "remat", False) for m in plain.modules())


def _step(cfg, seed):
    """One step of the trainer's model from its seeded init, dropout drawn
    from a seeded generator: (losses, gradients, state after, number of
    running-statistics updates)."""
    run = trainer.setup(cfg, "cpu")
    batch = next(iter(run.data.train_loader.batches(0)))
    updates = []
    update = layers.BatchNorm.update_running_stats

    def counted(bn, mean, var):
        if not layers._RECOMPUTING[0]:
            updates.append(bn)
        return update(bn, mean, var)

    layers.BatchNorm.update_running_stats = counted
    try:
        metrics = run.train_step(
            extract_device_batch(batch, run.device),
            trainer.dropout_generator_for(seed, 0, 0, "cpu"))
    finally:
        layers.BatchNorm.update_running_stats = update
    grads = {k: p.grad.clone() for k, p in run.model.named_parameters()
             if p.grad is not None}
    state = {k: v.clone() for k, v in run.model.state_dict().items()}
    n_bn = sum(isinstance(m, layers.BatchNorm) for m in run.model.modules())
    return metrics, grads, state, len(updates), n_bn


@pytest.mark.parametrize("fused", [True, False], ids=["pairs", "unfused"])
def test_remat_step_equals_plain_step(fused, all_pairs):
    want = _step(_cfg(False, fused), 0)
    got = _step(_cfg(True, fused), 0)
    for g, w, what in zip(got[:3], want[:3], ("loss", "grad", "state")):
        assert sorted(g) == sorted(w), what
        for k in w:
            torch.testing.assert_close(g[k], w[k], atol=1e-6, rtol=1e-6,
                                       msg=f"{what} {k}")
    # each BatchNorm of the train forward updated its statistics once
    # with remat as without; the recompute added none
    assert got[3] == want[3] and 0 < got[3] <= got[4]
    assert any(not torch.equal(got[2][k], torch.zeros_like(got[2][k]))
               for k in got[2] if k.endswith("running_mean"))


def _port_remat_step(variables, batch, cw, dtype):
    """One port step with remat from the flax variables (as
    `test_torch_port_train._port_step`): (losses, grads, parameters
    before, state dict after)."""
    cfg = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(fused_training=True, remat=True,
                             **_model_kwargs()),
        data=pc.DataConfig(dataset="synthetic", batch_size=B),
        train=pc.TrainConfig()))
    model = EMSANet(cfg.model, get_dataset_config("synthetic"), train=True)
    load_flax_variables(model, variables)
    if dtype == torch.float64:
        model = model.double()
        model.compute_dtype = torch.float64
    model = model.to(memory_format=torch.channels_last).train()
    before = {k: v.detach().double().numpy().copy()
              for k, v in model.named_parameters()}
    opt = get_optimizer(model.parameters(), cfg.train)
    tb = extract_device_batch(batch, "cpu")
    if dtype == torch.float64:
        tb = {k: (v.double() if k in ("rgb", "depth") else v)
              for k, v in tb.items()}
    metrics = make_train_step(model, cfg, opt,
                              torch.from_numpy(cw).to(dtype))(tb)
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    after = {k: v.double().numpy() for k, v in model.state_dict().items()}
    return {k: float(v) for k, v in metrics.items()}, grads, before, after


@pytest.fixture(scope="module")
def remat_results():
    jcfg = JaxEMSANetConfig(
        model=JaxModelConfig(fused_training=False, remat=True,
                             **_model_kwargs()),
        data=JaxDataConfig(dataset="synthetic", batch_size=B),
        train=JaxTrainConfig()).validate()
    shapes = jax.eval_shape(
        lambda k: init_model(JaxEMSANet(cfg=jcfg.model,
                                        dataset_config=jax_ds_config(
                                            jcfg.data)),
                             k, batch_size=1, train=True),
        jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), 3)
    loader, ds = _port_batch()
    with plain_host_library():
        batch = next(iter(loader.batches(0)))
    cw = ds.semantic_compute_class_weights()
    old = nbt1d_train.MIN_PIXELS
    nbt1d_train.MIN_PIXELS = 0
    try:
        return {"jax": _jax_step(jcfg, variables, batch, cw),
                "f32": _port_remat_step(variables, batch, cw, torch.float32),
                "f64": _port_remat_step(variables, batch, cw, torch.float64)}
    finally:
        nbt1d_train.MIN_PIXELS = old


def test_remat_step_losses_and_statistics_match_jax(remat_results):
    jl, _, jnew = remat_results["jax"]
    pl, _, _, after = remat_results["f32"]
    assert sorted(jl) == sorted(pl)
    for key, want in jl.items():
        np.testing.assert_allclose(pl[key], want, rtol=1e-4, err_msg=key)
    keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert keys and set(keys) <= set(jnew)
    for k in keys:
        np.testing.assert_allclose(after[k], jnew[k], atol=1e-4, rtol=1e-3,
                                   err_msg=k)


def test_remat_step_gradients_and_update_match_jax(remat_results):
    g64 = remat_results["f64"][1]
    for grads in (remat_results["jax"][1], remat_results["f32"][1]):
        glob, worst = _norm_check(grads, g64)
        assert glob < 5e-2 and worst < 0.5, (glob, worst)
    _, _, before, after64 = remat_results["f64"]
    want = {k: after64[k] - p for k, p in before.items()}
    for got_after in (remat_results["jax"][2], remat_results["f32"][3]):
        glob, worst = _norm_check(
            {k: got_after[k] - p for k, p in before.items()}, want)
        assert glob < 5e-2 and worst < 0.5, (glob, worst)
