"""The training of the other model settings against the JAX package, on
the CPU: one step of a 128x192 R18 b4 model with the tasks semantic (the
segformermlp decoder: no side outputs), normal (the dense decoder: the
masked L1 of its normalized output plus its side outputs at downscales
32, 16 and 8, each against its own normal mask) and scene, with
`train_polyphase_upsampling` (the final x2 stages' 64x96 inputs pass the
60*80 gate, so they run in the polyphase form, with autograd), dropout
0. The port runs with `fused_training` and `MIN_PIXELS` = 0 (the normal
decoder's last NBt1D tail, C = 128 at 16x24, and the encoders' first
stage tails, C = 64 at 32x48, through the train pairs' plain versions); the JAX package's `make_train_step` without fused
training, the same function without kernels. Same tolerances as
`tests/test_torch_port_train.py`: losses rtol 1e-4, BatchNorm statistics
atol 1e-4 / rtol 1e-3, gradients and updates by the relative norm of the
difference to the port's f64 step (< 5e-2 over all, < 0.5 per tensor);
the pair path is the unfused step's function in f64 (1e-9). At b2 the
BatchNorms of the 1/32 maps (4x6 pixels) put the f32 gradients 5.7e-2
from the f64 step; b4 halves that, as in `tests/test_torch_port_train.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import _random_variables
from test_torch_port_train import _jax_step, _norm_check
from torch_port_plain import plain_host_library

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch.data import DataLoader
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.registry import get_dataset
from emsanet_tpu_torch.models import layers
from emsanet_tpu_torch.models.emsanet import EMSANet
from emsanet_tpu_torch.ops import nbt1d_train
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
from emsanet_tpu_torch.training.optim import get_optimizer
from emsanet_tpu_torch.training.step import (
    extract_device_batch,
    make_train_step,
)
from emsanet_tpu_torch.weights import load_flax_variables

B = 4
MODEL = dict(tasks=("semantic", "normal", "scene"), input_height=128,
             input_width=192, rgb_encoder_backbone="resnet18",
             depth_encoder_backbone="resnet18",
             semantic_decoder="segformermlp", train_polyphase_upsampling=True,
             dropout_p=0.0, semantic_decoder_dropout_p=0.0,
             normal_decoder_block_dropout_p=0.0)


def _port_cfg(fused=True):
    return pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(fused_training=fused, **MODEL),
        data=pc.DataConfig(dataset="synthetic", batch_size=B,
                           synthetic_n_samples=B),
        train=pc.TrainConfig()))


def _port_step(variables, batch, cw, dtype, fused=True):
    cfg = _port_cfg(fused)
    model = EMSANet(cfg.model, get_dataset_config("synthetic"), train=True)
    load_flax_variables(model, variables)
    if dtype == torch.float64:
        model = model.double()
        model.compute_dtype = torch.float64
    model = model.to(memory_format=torch.channels_last).train()
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    tb = extract_device_batch(batch, "cpu")
    if dtype == torch.float64:
        tb = {k: (v.double() if k in ("rgb", "depth") else v)
              for k, v in tb.items()}
    step = make_train_step(model, cfg, get_optimizer(model.parameters(),
                                                     cfg.train),
                           torch.from_numpy(cw).to(dtype))
    pairs = []
    tail = layers._tail_fused_train
    old = nbt1d_train.MIN_PIXELS
    nbt1d_train.MIN_PIXELS = 0
    layers._tail_fused_train = lambda t, x: pairs.append(
        tuple(x.shape)) or tail(t, x)
    try:
        metrics = step(tb)
    finally:
        nbt1d_train.MIN_PIXELS = old
        layers._tail_fused_train = tail
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    after = {k: v.double().numpy() for k, v in model.state_dict().items()}
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v.double().numpy() for k, v in before.items()}, after, pairs)


@pytest.fixture(scope="module")
def results():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _results()
    finally:
        torch.set_num_threads(threads)


def _results():
    jcfg = JaxEMSANetConfig(
        model=JaxModelConfig(fused_training=False, **MODEL),
        data=JaxDataConfig(dataset="synthetic", batch_size=B),
        train=JaxTrainConfig()).validate()
    shapes = jax.eval_shape(
        lambda k: init_model(JaxEMSANet(
            cfg=jcfg.model, dataset_config=jax_ds_config(jcfg.data)),
            k, batch_size=1, train=True), jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), 5)
    cfg = _port_cfg()
    ds = get_dataset(cfg.data, cfg.model, "train")
    ds.preprocessor = get_preprocessor(
        cfg, get_dataset_config("synthetic"), "train",
        multiscale_downscales=cfg.model.side_output_downscales)
    loader = DataLoader(ds, B, shuffle=True, drop_last=True, n_workers=1,
                        seed=0)
    with plain_host_library():
        batch = next(iter(loader.batches(0)))
    cw = ds.semantic_compute_class_weights()
    return {"batch": batch, "jax": _jax_step(jcfg, variables, batch, cw),
            "f32": _port_step(variables, batch, cw, torch.float32),
            "f64": _port_step(variables, batch, cw, torch.float64),
            "f64_unfused": _port_step(variables, batch, cw, torch.float64,
                                      fused=False)}


def test_batch_has_normal_targets(results):
    batch = results["batch"]
    assert batch["normal_mask"].shape == batch["normal"].shape[:3]
    for s in (32, 16, 8):
        sub = batch[f"_down_{s}"]
        assert sub["normal_mask"].shape == sub["normal"].shape[:3]


def test_losses_match_jax(results):
    jl, pl = results["jax"][0], results["f32"][0]
    assert sorted(jl) == sorted(pl)
    assert "normal_total_loss" in pl and "semantic_total_loss" in pl
    for key, want in jl.items():
        np.testing.assert_allclose(pl[key], want, rtol=1e-4, err_msg=key)


def test_bn_statistics_match_jax(results):
    jnew, after = results["jax"][2], results["f32"][3]
    keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert keys and set(keys) <= set(jnew)
    for k in keys:
        np.testing.assert_allclose(after[k], jnew[k], atol=1e-4, rtol=1e-3,
                                   err_msg=k)


def test_gradients_and_updates_match_jax(results):
    _, g64, before, after64, _ = results["f64"]
    for got in (results["jax"][1], results["f32"][1]):
        glob, worst = _norm_check(got, g64)
        assert glob < 5e-2 and worst < 0.5, (glob, worst)
    want = {k: after64[k] - p for k, p in before.items()}
    for got_after in (results["jax"][2], results["f32"][3]):
        glob, worst = _norm_check(
            {k: got_after[k] - p for k, p in before.items()}, want)
        assert glob < 5e-2 and worst < 0.5, (glob, worst)
    # the MLP decoder and the normal side outputs took gradients
    for part in ("semantic_decoder.embed0", "normal_decoder.module0."
                 "side_output"):
        assert any(k.startswith(part) and np.abs(g).max() > 0
                   for k, g in g64.items()), part


def test_pairs_are_the_unfused_step_f64(results):
    fused, unfused = results["f64"], results["f64_unfused"]
    assert (B, 128, 16, 24) in fused[4] and (B, 64, 32, 48) in fused[4]
    assert not unfused[4]
    for key, want in unfused[0].items():
        np.testing.assert_allclose(fused[0][key], want, rtol=1e-12)
    glob, _ = _norm_check(fused[1], unfused[1])
    assert glob < 1e-9
