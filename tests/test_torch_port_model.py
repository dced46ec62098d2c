"""The port's model (emsanet_tpu_torch/models) against the flax model.

Weights are carried over by the port's own converter
(`emsanet_tpu_torch/weights.py`); inputs come from a numpy seed. The
flax variables get random BatchNorm scales and running statistics (the
init has scale 1 / 0, mean 0, var 1), so that folding and naming errors
show; the whole model's weights are drawn with numpy from the flax
tree's shapes. Everything runs at f32 on the CPU, where the port's kernel
wrappers take their plain versions. Tolerance: atol 1e-4 / rtol 1e-3
(conv accumulation order differs between XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from emsanet_tpu import DataConfig, EMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import context as jax_context
from emsanet_tpu.models import layers as jax_layers
from emsanet_tpu.models import upsampling as jax_up
from emsanet_tpu.ops import device_prep as jax_prep
from emsanet_tpu_torch import config as port_config
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models import context, layers, upsampling
from emsanet_tpu_torch.models.emsanet import build_model
from emsanet_tpu_torch.ops import device_prep
from emsanet_tpu_torch.weights import flax_to_state_dict, load_flax_variables

ATOL, RTOL = 1e-4, 1e-3
H, W = 96, 128


def _randomize_bn(variables, seed):
    """Random BN scale/bias and running stats (numpy seed)."""
    rng = np.random.RandomState(seed)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    leaves = []
    for path, leaf in flat:
        names = [getattr(p, "key", None) for p in path]
        a = np.asarray(leaf, np.float32)
        if any(n and n.startswith("BatchNorm") for n in names):
            last = names[-1]
            if last == "scale":
                a = rng.uniform(0.5, 1.5, a.shape)
            elif last in ("bias", "mean"):
                a = rng.randn(*a.shape) * 0.1
            elif last == "var":
                a = rng.uniform(0.5, 1.5, a.shape)
        leaves.append(np.asarray(a, np.float32))
    treedef = jax.tree_util.tree_structure(variables)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _random_variables(shapes, seed):
    """numpy-seeded variables for a tree of shapes: kernels N(0, 1/fan_in),
    other params N(0, 0.1^2), then random BN (no flax init compile)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = tuple(leaf.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return _randomize_bn(v, seed + 1)


def _np_tree(v):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _flax_module(module, x, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), x)
    return _np_tree(_randomize_bn(dict(variables), seed))


# ---------------------------------------------------------------------------
# whole model


@pytest.fixture(scope="module")
def flagship_pair():
    """One small flax flagship (resnet18-NBt1D, 96x128) and the port with
    its converted weights, shared by the whole-model tests."""
    jcfg = EMSANetConfig(
        model=JaxModelConfig(
            tasks=("semantic", "instance", "orientation", "scene"),
            enable_panoptic=True, input_height=H, input_width=W,
            rgb_encoder_backbone="resnet18",
            depth_encoder_backbone="resnet18",
            fused_inference=True, head_decode_fusion="interleave",
            decoder_megakernel="off",
        ),
        data=DataConfig(dataset="synthetic"),
    ).validate()
    jds = jax_ds_config(jcfg.data)
    jmodel = JaxEMSANet(cfg=jcfg.model, dataset_config=jds)
    dummy = {"rgb": jnp.zeros((1, H, W, 3)), "depth": jnp.zeros((1, H, W, 1))}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), dummy)
    variables = _random_variables(dict(shapes), 1)

    pcfg = port_config.flagship_config(
        input_height=H, input_width=W, rgb_encoder_backbone="resnet18",
        depth_encoder_backbone="resnet18")
    pmodel = build_model(pcfg, get_dataset_config("synthetic"),
                         device="cpu", seed=None)
    load_flax_variables(pmodel, variables)

    rng = np.random.RandomState(0)
    batch = {"rgb": rng.randn(2, H, W, 3).astype(np.float32),
             "depth": rng.randn(2, H, W, 1).astype(np.float32)}
    jout = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, batch)
    pout = pmodel({k: _t(v) for k, v in batch.items()})
    return jout, pout, jcfg, pcfg


def _compare_tree(jtree, ptree, path=""):
    if isinstance(jtree, dict):
        assert isinstance(ptree, dict) and sorted(jtree) == sorted(ptree), (
            path, sorted(jtree), sorted(ptree))
        for k in jtree:
            _compare_tree(jtree[k], ptree[k], f"{path}/{k}")
    elif isinstance(jtree, (tuple, list)):
        assert len(jtree) == len(ptree), path
        for i, (a, b) in enumerate(zip(jtree, ptree)):
            _compare_tree(a, b, f"{path}/{i}")
    else:
        got = ptree.numpy()
        want = np.asarray(jtree)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=path)


def test_whole_forward_matches_flax(flagship_pair):
    jout, pout, _, _ = flagship_pair
    _compare_tree(jout, pout)


def test_whole_forward_output_keys(flagship_pair):
    _, pout, _, _ = flagship_pair
    # at 96x128 the final semantic x2 stage input (48x64) is below the
    # polyphase gate, so the head returns full-res logits
    assert sorted(pout["semantic"]) == ["logits", "side_outputs"]
    assert sorted(pout["instance"]) == ["center", "offset", "orientation",
                                        "side_outputs"]
    assert tuple(pout["scene"]["logits"].shape) == (2, 9)


# ---------------------------------------------------------------------------
# modules


def _load(port_module, variables):
    load_flax_variables(port_module, variables)
    return port_module.eval()


@pytest.mark.parametrize("stride,cin,features,zero_init", [
    (2, 32, 64, False), (1, 64, 64, True), (1, 32, 64, True),
])
def test_nonbottleneck1d_matches_flax(stride, cin, features, zero_init):
    rng = np.random.RandomState(stride)
    x = rng.randn(1, 12, 16, cin).astype(np.float32)
    fm = jax_layers.NonBottleneck1D(features=features, stride=stride,
                                    zero_init_residual=zero_init)
    v = _flax_module(fm, x)
    pm = _load(layers.NonBottleneck1D(cin, features, stride, zero_init), v)
    want = fm.apply(v, x)
    with torch.no_grad():
        got = pm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_fused_block_tail_matches_flax_blocks():
    """apply_blocks_fused (chain op on the stride-1 tail) vs flax blocks."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 12, 32).astype(np.float32)

    class Stack(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = jax_layers.NonBottleneck1D(64, stride=2, name="block0")(x)
            for i in (1, 2):
                x = jax_layers.NonBottleneck1D(
                    64, zero_init_residual=True, name=f"block{i}")(x)
            return x

    v = _flax_module(Stack(), x)

    class PStack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block0 = layers.NonBottleneck1D(32, 64, 2)
            self.block1 = layers.NonBottleneck1D(64, 64, 1, True)
            self.block2 = layers.NonBottleneck1D(64, 64, 1, True)

    pm = _load(PStack(), v)
    with torch.no_grad():
        got = layers.apply_blocks_fused(
            [pm.block0, pm.block1, pm.block2], _nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(Stack().apply(v, x)),
                               atol=ATOL, rtol=RTOL)


def test_basicblock_matches_flax():
    rng = np.random.RandomState(4)
    x = rng.randn(1, 12, 16, 32).astype(np.float32)
    fm = jax_layers.BasicBlock(features=64, stride=2)
    v = _flax_module(fm, x)
    pm = _load(layers.BasicBlock(32, 64, 2), v)
    with torch.no_grad():
        got = pm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(fm.apply(v, x)),
                               atol=ATOL, rtol=RTOL)


def test_squeeze_excitation_matches_flax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 8, 64).astype(np.float32)
    fm = jax_layers.SqueezeExcitation()
    v = _flax_module(fm, x)
    pm = _load(layers.SqueezeExcitation(64), v)
    with torch.no_grad():
        got = pm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(fm.apply(v, x)),
                               atol=ATOL, rtol=RTOL)


def test_ppm_matches_flax_at_context_size():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 15, 20, 64).astype(np.float32)
    fm = jax_context.PyramidPoolingModule(name_="ppm", n_channels_out=64)
    v = _flax_module(fm, x)
    pm = _load(context.PyramidPoolingModule("ppm", 64), v)
    want, want_ctx = fm.apply(v, x)
    with torch.no_grad():
        got, got_ctx = pm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for g, w in zip(got_ctx, want_ctx):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("src,dst", [
    ((1, 1), (15, 20)), ((5, 5), (15, 20)), ((2, 2), (15, 20)),
    ((5, 5), (3, 4)),  # PPM bin at the 96x128 test size: a downsample
])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.RandomState(7)
    x = rng.randn(2, *src, 8).astype(np.float32)
    want = jax_up.resize_bilinear(jnp.asarray(x), *dst)
    got = upsampling.resize_bilinear(_nchw(x), *dst)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_adaptive_avg_pool_matches_jax_at_context_size():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 15, 20, 8).astype(np.float32)
    for bins in (1, 2, 4, 5, 8):
        want = jax_context.adaptive_avg_pool(jnp.asarray(x), bins, bins)
        got = context.adaptive_avg_pool(_nchw(x), bins, bins)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("hw,defer", [
    ((60, 80), True), ((59, 80), True), ((60, 80), False), ((8, 10), False),
])
def test_learned_upsampling_gate_matches_flax(hw, defer):
    """Polyphase (deferred or interleaved) at >= 60*80 pixels, the
    nearest + depthwise form below, as `upsampling.py:125` gates it."""
    rng = np.random.RandomState(9)
    x = rng.randn(1, *hw, 3).astype(np.float32)
    fm = jax_up.Upsampling("learned-3x3-zeropad", fused=True,
                           defer_interleave=defer)
    kernel = rng.randn(3, 3, 1, 3).astype(np.float32)
    v = {"params": {"depthwise": {"kernel": kernel}}}
    want = np.asarray(fm.apply(v, x))
    pm = _load(upsampling.Upsampling("learned-3x3-zeropad", 3,
                                     defer_interleave=defer), v)
    with torch.no_grad():
        got = _nhwc(pm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["learned-3x3", "bilinear", "nearest"])
def test_other_upsamplings_match_flax(method):
    rng = np.random.RandomState(12)
    x = rng.randn(2, 6, 8, 3).astype(np.float32)
    fm = jax_up.Upsampling(method, fused=True)
    v = {"params": {"depthwise": {
        "kernel": rng.randn(3, 3, 1, 3).astype(np.float32)}}} if (
        method == "learned-3x3") else {}
    want = np.asarray(fm.apply(v, x))
    pm = _load(upsampling.Upsampling(method, 3), v)
    with torch.no_grad():
        got = _nhwc(pm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("src,dst", [((1, 1), (15, 20)), ((5, 5), (15, 20))])
def test_resize_nearest_matches_jax(src, dst):
    x = np.random.RandomState(13).randn(2, *src, 4).astype(np.float32)
    want = jax_up.resize_nearest(jnp.asarray(x), *dst)
    got = upsampling.resize_nearest(_nchw(x), *dst)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_device_prep_matches_jax():
    rng = np.random.RandomState(10)
    rgb = rng.randint(0, 256, (1, 4, 6, 3)).astype(np.uint8)
    depth = rng.randint(0, 10000, (1, 4, 6, 1)).astype(np.uint16)
    want = jax_prep.prepare_inputs_device(
        {"rgb": jnp.asarray(rgb), "depth": jnp.asarray(depth)},
        3000.0, 1500.0, raw_depth=True)
    got = device_prep.prepare_inputs_device(
        {"rgb": _t(rgb), "depth": _t(depth)}, 3000.0, 1500.0, raw_depth=True)
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# weights, config, device


def test_weight_map_fails_loudly():
    rng = np.random.RandomState(11)
    x = rng.randn(1, 4, 4, 64).astype(np.float32)
    v = _flax_module(jax_layers.SqueezeExcitation(), x)
    missing = {"params": {"Dense_0": v["params"]["Dense_0"]}}
    with pytest.raises(ValueError, match="missing"):
        load_flax_variables(layers.SqueezeExcitation(64), missing)
    extra = {"params": dict(v["params"], Dense_9=v["params"]["Dense_0"])}
    with pytest.raises(ValueError, match="Dense_9"):
        load_flax_variables(layers.SqueezeExcitation(64), extra)
    assert sorted(flax_to_state_dict(v)) == sorted(
        layers.SqueezeExcitation(64).state_dict())


@pytest.mark.parametrize("override", [
    {"rgb_encoder_backbone": "resnet50"},
    {"tasks": ("semantic", "instance", "normal")},
    {"semantic_decoder": "segformermlp"},
    {"input_modalities": ("rgbd",)},
    {"fused_inference": False},
])
def test_config_refuses_what_is_not_ported(override):
    with pytest.raises(port_config.NotPortedError, match="not ported yet"):
        port_config.flagship_config(**override)


@pytest.mark.parametrize("part,override,what", [
    ("model", {"train_polyphase_upsampling": True},
     "train_polyphase_upsampling"),
    ("model", {"tasks": ("semantic", "instance", "normal")}, "normal"),
    ("model", {"rgb_encoder_backbone": "resnet50"}, "resnet50"),
    ("train", {"n_devices": 2}, "n_devices"),
    ("data", {"dataset": "nyuv2"}, "dataset 'nyuv2'"),
])
def test_training_is_refused(part, override, what):
    """What the port's training still refuses; the flagship trains."""
    cfg = port_config.EMSANetConfig(
        model=port_config.flagship_config(fused_training=True),
        data=port_config.DataConfig(dataset="synthetic"))
    port_config.validate_train_for_port(cfg)
    cfg = port_config.EMSANetConfig(
        model=port_config.flagship_config(),
        data=port_config.DataConfig(dataset="synthetic"))
    for key, value in override.items():
        setattr(getattr(cfg, part), key, value)
    with pytest.raises(port_config.NotPortedError, match=what):
        port_config.validate_train_for_port(cfg)


def test_entry_point_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = port_config.flagship_config(
        input_height=H, input_width=W, rgb_encoder_backbone="resnet18",
        depth_encoder_backbone="resnet18")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, get_dataset_config("synthetic"))

