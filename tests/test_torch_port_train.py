"""The port's training against the JAX package, on the CPU.

Covers the train configuration, flax's BatchNorm in train mode, every
loss, the optimizers, the OneCycle schedule, the synthetic dataset with
the train preprocessor and loader (bit for bit), dropout, the train
entry, and the whole train step: R18, 64x64, b4, dropout 0, the port
with `fused_training` and `MIN_PIXELS` = 0 (every NBt1D tail through the
pairs, the semantic head through the fused loss: their plain versions on
the CPU) against the JAX package's `make_train_step` with
`fused_training=False`, the same function without kernels. Weights go
through the port's flax -> torch converter.

Tolerances of the step: losses rtol 1e-4; BatchNorm running statistics
atol 1e-4 / rtol 1e-3. Gradients and parameter updates by the relative
norm of the difference, < 5e-2 over all tensors and < 0.5 per tensor
(as tests/test_nbt1d_train.py): an f32 gradient of this network is only
good to a few per cent. Moving the input by 1e-6 moves the port's f32
gradient by ~1e-2, and its f32 gradient lies ~2e-2 from its f64 one, so
two f32 implementations differ by ~3-5e-2. The JAX gradient is held
against the port's f64 step (measured 2.5e-2), and the port's f32
gradient against the same f64 step (1.9e-2); that the pair path is the
same function is shown in f64 (the fused and unfused port steps agree
to 1e-9). At b2 the BatchNorms of the 1/32 maps normalize 8 values and
f32 noise reaches 1e-4 in the offset loss, hence b4 (losses ~1e-5). The
bf16 step is in tests/test_torch_port_train_bf16.py, so that its JAX
compile runs on another test worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from test_torch_port_model import _random_variables

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu import losses as jax_losses
from emsanet_tpu import native as jax_native
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.data import DataLoader as JaxDataLoader
from emsanet_tpu.datasets.registry import get_dataset as jax_get_dataset
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu.preprocessing import get_preprocessor as jax_preprocessor
from emsanet_tpu.training import lr_schedule as jax_lr
from emsanet_tpu.training.optim import get_optimizer as jax_optimizer
from emsanet_tpu.training.step import create_train_state
from emsanet_tpu.training.step import extract_device_batch as jax_extract
from emsanet_tpu.training.step import make_train_step as jax_train_step
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import losses
from emsanet_tpu_torch import train as train_entry
from emsanet_tpu_torch.data import DataLoader
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.registry import get_dataset
from emsanet_tpu_torch.models import layers
from emsanet_tpu_torch.models.emsanet import EMSANet
from emsanet_tpu_torch.ops import nbt1d_train
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
from emsanet_tpu_torch.training import lr_schedule
from emsanet_tpu_torch.training.optim import get_optimizer
from emsanet_tpu_torch.training.step import (
    extract_device_batch,
    make_train_step,
)
from emsanet_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from torch_port_plain import plain_host_library
from torch_tmp_files import remove_large_files

H = W = 64
B = 4
TASKS = ("semantic", "instance", "orientation", "scene")
NO_DROPOUT = dict(dropout_p=0.0, semantic_decoder_block_dropout_p=0.0,
                  instance_decoder_block_dropout_p=0.0)


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """The checkpoints a test writes go once it is done."""
    yield
    remove_large_files(tmp_path)



def _model_kwargs(dtype="float32", **extra):
    return dict(tasks=TASKS, enable_panoptic=True, input_height=H,
                input_width=W, rgb_encoder_backbone="resnet18",
                depth_encoder_backbone="resnet18", compute_dtype=dtype,
                **NO_DROPOUT, **extra)


def _port_cfg(dtype="float32", fused=True, **data):
    return pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(fused_training=fused, **_model_kwargs(dtype)),
        data=pc.DataConfig(dataset="synthetic", batch_size=B, **data),
        train=pc.TrainConfig()))


def _jax_cfg(dtype="float32", **data):
    return JaxEMSANetConfig(
        model=JaxModelConfig(fused_training=False, **_model_kwargs(dtype)),
        data=JaxDataConfig(dataset="synthetic", batch_size=B, **data),
        train=JaxTrainConfig()).validate()


@pytest.fixture
def jax_native_path():
    """The JAX package's native path: the port always takes its own host
    library, a copy of the JAX package's built with the same flags, so
    the two give the same bits."""
    assert jax_native.get_lib() is not None, (
        "the JAX package's native library is not available")


def _port_batch(n_samples=B):
    cfg = _port_cfg(synthetic_n_samples=n_samples)
    ds = get_dataset(cfg.data, cfg.model, "train")
    ds.preprocessor = get_preprocessor(
        cfg, get_dataset_config("synthetic"), "train",
        multiscale_downscales=cfg.model.side_output_downscales)
    loader = DataLoader(ds, B, shuffle=True, drop_last=True, n_workers=2,
                        seed=0)
    return loader, ds


# ---------------------------------------------------------------------------
# the whole train step


def _port_step(variables, batch, cw, dtype, fused=True):
    """One port train step from the flax variables: (losses, grads,
    parameters before, state dict after), in `dtype` (float64: the same
    step with f64 parameters and activations)."""
    compute = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = _port_cfg(compute, fused=fused)
    model = EMSANet(cfg.model, get_dataset_config("synthetic"), train=True)
    load_flax_variables(model, variables)
    if dtype == torch.float64:
        model = model.double()
        model.compute_dtype = torch.float64
    model = model.to(memory_format=torch.channels_last).train()
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = get_optimizer(model.parameters(), cfg.train)
    tb = extract_device_batch(batch, "cpu")
    if dtype == torch.float64:
        tb = {k: (v.double() if k in ("rgb", "depth") else v)
              for k, v in tb.items()}
    cw_t = torch.from_numpy(cw).to(torch.float64 if dtype == torch.float64
                                   else torch.float32)
    old = nbt1d_train.MIN_PIXELS
    nbt1d_train.MIN_PIXELS = 0
    try:
        metrics = make_train_step(model, cfg, opt, cw_t)(tb)
    finally:
        nbt1d_train.MIN_PIXELS = old
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    after = {k: v.double().numpy() for k, v in model.state_dict().items()}
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v.double().numpy() for k, v in before.items()}, after)


def _jax_step(jcfg, variables, batch, cw):
    """The JAX package's make_train_step: (losses, gradients recovered
    from the first SGD step, parameters after, batch_stats after), as
    port-named numpy leaves."""
    jds = jax_ds_config(jcfg.data)
    model = JaxEMSANet(cfg=jcfg.model, dataset_config=jds)
    state = create_train_state(model, variables, jax_optimizer(jcfg.train))
    step = jax.jit(jax_train_step(model, jcfg, jnp.asarray(cw)))
    new_state, metrics = step(state, jax_extract(batch),
                              jax.random.PRNGKey(1))
    new = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    old = flax_to_state_dict({"params": variables["params"]})
    # first Nesterov step from a zero trace: p' = p - lr (1 + m) (g + wd p)
    lr, m, wd = (jcfg.train.learning_rate, jcfg.train.momentum,
                 jcfg.train.weight_decay)
    grads = {}
    for k, p in old.items():
        p = p.double().numpy()
        grads[k] = (p - new[k].double().numpy()) / (lr * (1 + m)) - wd * p
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v.double().numpy() for k, v in new.items()})


@pytest.fixture(scope="module")
def step_results():
    jcfg = _jax_cfg()
    shapes = jax.eval_shape(
        lambda k: init_model(JaxEMSANet(cfg=jcfg.model,
                                        dataset_config=jax_ds_config(
                                            jcfg.data)),
                             k, batch_size=1, train=True),
        jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), 3)
    loader, ds = _port_batch()
    # the batch these bounds were set on: the plain preprocessing (the
    # JAX step's f32 gradients are ~5% from f64 on the native path's)
    with plain_host_library():
        batch = next(iter(loader.batches(0)))
    cw = ds.semantic_compute_class_weights()
    return {
        "jax": _jax_step(jcfg, variables, batch, cw),
        "f32": _port_step(variables, batch, cw, torch.float32),
        "f64": _port_step(variables, batch, cw, torch.float64),
        "f64_unfused": _port_step(variables, batch, cw, torch.float64,
                                  fused=False),
    }


def _norm_check(got, want):
    """(global relative norm difference, worst per-tensor ratio)."""
    gmax = max(np.linalg.norm(v) for v in want.values())
    num = den = worst = 0.0
    for k, w in want.items():
        d = np.linalg.norm(got[k] - w) ** 2
        r = np.linalg.norm(w) ** 2
        num, den = num + d, den + r
        worst = max(worst, d ** 0.5 / max(r ** 0.5, 1e-5 * gmax))
    return (num / den) ** 0.5, worst


def test_train_step_losses_match_jax(step_results):
    jl = step_results["jax"][0]
    pl = step_results["f32"][0]
    assert sorted(jl) == sorted(pl)
    for key, want in jl.items():
        np.testing.assert_allclose(pl[key], want, rtol=1e-4, err_msg=key)


def test_train_step_bn_statistics_match_jax(step_results):
    jnew = step_results["jax"][2]
    after = step_results["f32"][3]
    keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert keys and set(keys) <= set(jnew)
    for k in keys:
        np.testing.assert_allclose(after[k], jnew[k], atol=1e-4, rtol=1e-3,
                                   err_msg=k)


def test_train_step_gradients_match_jax(step_results):
    g64 = step_results["f64"][1]
    glob, worst = _norm_check(step_results["jax"][1], g64)
    assert glob < 5e-2 and worst < 0.5, (glob, worst)
    glob, worst = _norm_check(step_results["f32"][1], g64)
    assert glob < 5e-2 and worst < 0.5, (glob, worst)


def test_train_step_updated_parameters_match_jax(step_results):
    _, _, before, after64 = step_results["f64"]
    _, _, _, after32 = step_results["f32"]
    jnew = step_results["jax"][2]
    want = {k: after64[k] - p for k, p in before.items()}
    for got_after in (jnew, after32):
        glob, worst = _norm_check(
            {k: got_after[k] - p for k, p in before.items()}, want)
        assert glob < 5e-2 and worst < 0.5, (glob, worst)


def test_fused_train_step_is_exact_f64(step_results):
    """The pairs and the fused head loss compute the unfused step's
    function: f64 losses and gradients agree to rounding."""
    fused, unfused = step_results["f64"], step_results["f64_unfused"]
    for key, want in unfused[0].items():
        np.testing.assert_allclose(fused[0][key], want, rtol=1e-12)
    glob, _ = _norm_check(fused[1], unfused[1])
    assert glob < 1e-9


# ---------------------------------------------------------------------------
# configuration


def test_train_config_matches_jax():
    p, j = _port_cfg(), _jax_cfg()
    assert p.train.learning_rate == j.train.learning_rate
    assert p.train.tasks_weighting == j.train.tasks_weighting
    for task in ("semantic", "instance"):
        assert p.model.task_side_output_downscales(task) == (
            j.model.task_side_output_downscales(task))
    assert p.model.side_output_downscales == j.model.side_output_downscales
    mixed = pc.EMSANetConfig(train=pc.TrainConfig(mixed_precision=True))
    assert mixed.validate().model.compute_dtype == "bfloat16"


# ---------------------------------------------------------------------------
# BatchNorm, dropout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_matches_flax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 5, 8).astype(np.float32) * 2 + 1
    scale = rng.rand(8).astype(np.float32) + 0.5
    bias = rng.randn(8).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32)
    var0 = rng.rand(8).astype(np.float32) + 0.5
    fm = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5,
                       dtype=jnp.bfloat16 if dtype == torch.bfloat16
                       else jnp.float32)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}
    jx = jnp.asarray(x).astype(fm.dtype)
    want, mut = fm.apply(v, jx, mutable=["batch_stats"])
    bn = layers.BatchNorm(8).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
    got = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == dtype
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   atol=1e-6, rtol=1e-5)
    # the trap: F.batch_norm(training=True) keeps the unbiased variance
    rv = torch.from_numpy(var0.copy())
    torch.nn.functional.batch_norm(
        xt.float().permute(0, 3, 1, 2), torch.from_numpy(mean0.copy()), rv,
        training=True, momentum=0.1)
    assert not np.allclose(rv.numpy(), bn.running_var.numpy(), rtol=1e-4)


def test_dropout_statistics():
    """Inverted element-wise dropout: ~1 - p kept, the mean preserved,
    the same mask from the same generator, a no-op outside train mode."""
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(3)
    y = nbt1d_train.dropout(x, 0.2, g)
    kept = float((y > 0).float().mean())
    assert abs(kept - 0.8) < 5e-3 and abs(float(y.mean()) - 1.0) < 1e-2
    assert torch.equal(y, nbt1d_train.dropout(
        x, 0.2, torch.Generator().manual_seed(3)))

    rng = np.random.RandomState(11)
    xs = torch.from_numpy(rng.randn(4, 16, 16, 64).astype(np.float32))
    c = 64
    stacked = {key: torch.from_numpy((rng.randn(1, 2, 3, c, c) * 0.1
                                      if key.startswith("w") else
                                      rng.rand(1, 2, c) + 0.5).astype(
                                          np.float32))
               for key in ("w31", "w13", "b31", "b13", "gamma", "beta")}
    out0 = nbt1d_train.chain_train(xs, stacked)[0]
    outs = [nbt1d_train.chain_train(
        xs, stacked, dropout_p=0.5,
        generator=torch.Generator().manual_seed(5))[0] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], out0)
    assert bool(torch.isfinite(outs[0]).all())

    block = layers.NonBottleneck1D(8, 8, dropout_p=0.5)
    xb = torch.randn(2, 8, 6, 6)
    block.eval()
    assert torch.equal(block(xb), block(xb))
    block.train()
    with layers.dropout_generator(torch.Generator().manual_seed(1)):
        a = block(xb)
    with layers.dropout_generator(torch.Generator().manual_seed(1)):
        b = block(xb)
    with layers.dropout_generator(torch.Generator().manual_seed(2)):
        c2 = block(xb)
    assert torch.equal(a, b) and not torch.equal(a, c2)


# ---------------------------------------------------------------------------
# losses, optimizers, schedule


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    return {
        "logits": rng.randn(2, 6, 7, 5).astype(f) * 2,
        "target": np.where(rng.rand(2, 6, 7) < 0.2, 0,
                           rng.randint(1, 6, (2, 6, 7))).astype(np.int32),
        "cw": (rng.rand(5) + 0.5).astype(f),
        "center": rng.rand(2, 6, 7, 1).astype(f),
        "center_t": rng.rand(2, 6, 7, 1).astype(f),
        "mask": rng.rand(2, 6, 7) > 0.3,
        "offset": rng.randn(2, 6, 7, 2).astype(f),
        "offset_t": rng.randn(2, 6, 7, 2).astype(f),
        "orient": rng.randn(2, 6, 7, 2).astype(f),
        "orient_t": np.stack([np.sin(a := rng.rand(2, 6, 7) * 6),
                              np.cos(a)], -1).astype(f),
    }


@pytest.mark.parametrize("name", [
    "ce", "ce_weighted", "ce_smoothed", "scene", "mse", "mse_nomask", "bce",
    "l1_offset", "von_mises"])
def test_losses_match_jax(name):
    d = _loss_inputs(len(name))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    calls = {
        "ce": lambda m, a: m.cross_entropy_semantic(a["logits"],
                                                    a["target"]),
        "ce_weighted": lambda m, a: m.cross_entropy_semantic(
            a["logits"], a["target"], a["cw"]),
        "ce_smoothed": lambda m, a: m.cross_entropy_semantic(
            a["logits"], a["target"], a["cw"], 0.1),
        "scene": lambda m, a: m.cross_entropy_scene(
            a["logits"][:, 0, 0], a["target"][:, 0, 0], label_smoothing=0.1),
        "mse": lambda m, a: m.mse_center(a["center"], a["center_t"],
                                         a["mask"]),
        "mse_nomask": lambda m, a: m.mse_center(a["center"], a["center_t"]),
        "bce": lambda m, a: m.bce_center(a["center"], a["center_t"],
                                         a["mask"]),
        "l1_offset": lambda m, a: m.l1_offset(a["offset"], a["offset_t"],
                                              a["mask"]),
        "von_mises": lambda m, a: m.von_mises_orientation(
            a["orient"], a["orient_t"], a["mask"], kappa=1.5),
    }
    got = float(calls[name](losses, t))
    want = float(calls[name](jax_losses, j))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_loss_weighting_matches_jax():
    for tasks, weights in ((TASKS, (1.0, 2.0, 0.5, 3.0)),
                           (("semantic", "scene"), (1.0, 0.25))):
        got = losses.build_loss_weighting(tasks, weights, (2.0, 1.5))
        want = jax_losses.build_loss_weighting(tasks, weights, (2.0, 1.5))
        assert got.weights == want.weights


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "radam"])
def test_optimizer_matches_optax(name):
    """3 steps on the same gradients: torch's optimizer against the JAX
    package's optax chain."""
    rng = np.random.RandomState(7)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    cfg = JaxTrainConfig(optimizer=name, learning_rate=0.05,
                         weight_decay=1e-2)
    tx = jax_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = get_optimizer(tp.values(), pc.TrainConfig(
        optimizer=name, learning_rate=0.05, weight_decay=1e-2))
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("total", [1, 10, 37, 500])
def test_onecycle_matches_jax(total):
    port = pc.TrainConfig(n_epochs=total, learning_rate=0.02)
    jaxc = JaxTrainConfig(n_epochs=total, learning_rate=0.02)
    pf, jf = lr_schedule.get_lr_fn(port), jax_lr.get_lr_fn(jaxc)
    for epoch in sorted({0, 1, total // 10, total // 2, total - 1, total}):
        assert pf(epoch) == jf(epoch)


# ---------------------------------------------------------------------------
# data


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert got == want, path


def test_train_batches_bit_identical_to_jax(jax_native_path):
    """Synthetic samples through the train preprocessor (with the
    `_down_{s}` targets) and the loader, 64x64, seed 0: every array of
    the collated batches equal to the JAX package's, bit for bit."""
    loader, _ = _port_batch(n_samples=2 * B)
    jcfg = _jax_cfg(synthetic_n_samples=2 * B)
    jds = jax_get_dataset(jcfg.data, jcfg.model, "train")
    jds.preprocessor = jax_preprocessor(
        jcfg, jax_ds_config(jcfg.data), "train",
        multiscale_downscales=jcfg.model.side_output_downscales)
    jloader = JaxDataLoader(jds, B, shuffle=True, drop_last=True,
                            n_workers=2, seed=0)
    for epoch in (0, 1):
        got = list(loader.batches(epoch))
        want = list(jloader.batches(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g, w)


@pytest.mark.parametrize("mode", ["median-frequency", "logarithmic",
                                  "linear", "none"])
def test_class_weights_match_jax(mode):
    _, ds = _port_batch(n_samples=3)
    jcfg = _jax_cfg(synthetic_n_samples=3)
    jds = jax_get_dataset(jcfg.data, jcfg.model, "train")
    np.testing.assert_array_equal(
        ds.semantic_compute_class_weights(mode),
        jds.semantic_compute_class_weights(mode))


# ---------------------------------------------------------------------------
# the train entry


def test_train_entry_runs_on_cpu(capsys, tmp_path):
    """On one torch intra-op thread for its duration, restored after: the
    default pool's idle threads spin beside the other test workers'
    processes."""
    argv = ["--device", "cpu", "--dataset", "synthetic", "--n-epochs", "1",
            "--batch-size", "2", "--synthetic-n-samples", "2",
            "--input-height", "64", "--input-width", "64",
            "--rgb-encoder-backbone", "resnet18",
            "--depth-encoder-backbone", "resnet18", "--tasks", *TASKS,
            "--enable-panoptic", "--fused-training", "--fused-inference",
            "--n-workers", "1", "--results-basepath", str(tmp_path)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert train_entry.main(argv) == 0
    finally:
        torch.set_num_threads(threads)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"train_total_loss"' in line and '"epoch": 0' in line


def test_train_entry_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry.main(["--dataset", "synthetic", "--n-epochs", "1"])
