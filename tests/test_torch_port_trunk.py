"""The port's decoder megakernel path against the JAX package, on the CPU.

`emsanet_tpu_torch/ops/decoder_trunk.py` computes every dense decoder's
trunk (3 modules of conv_in, NBt1D blocks, x2 upsample, skip fusion) in
one call; here its plain version (the CPU path and the card's oracle)
runs against the JAX kernel `emsanet_tpu.ops.decoder_trunk.decoder_trunk`
in Pallas interpret mode, as the JAX package's own tests run it, and the
whole 96x128 resnet18 flagship with decoder_megakernel='on' runs against
the JAX model with 'on'. Inputs and weights come from numpy seeds.

Tolerances:
- stacked parameters: weights exact; folded BatchNorms 1e-6 (the two
  frameworks' rsqrt differ in the last bit); the parity taps 1e-6 (sums
  of up to four taps, added in another order);
- the trunk, f32: rtol / atol 2e-4, the bound of the reference's own
  kernel-vs-flax test;
- the trunk, bf16: 2e-2 of the largest magnitude. Both sides round at
  the same points, so they differ only where an f32 sum taken in another
  order lands on the other side of a bf16 rounding boundary: one bf16
  ulp (2^-8 of the value) in an intermediate, which 13 layers per
  module carry on; measured at most 6.9e-3 here (the reference's own
  bf16 test allows 0.1 against the unfused flax decoder, which rounds
  elsewhere);
- the whole model: raw outputs rtol / atol 2e-4; postprocessed maps of
  each side's own raw outputs: at least 0.999 of the semantic and 0.99
  of the panoptic pixels agree (a near-tie argmax may flip), the scene
  class exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import _random_variables

from emsanet_tpu import DataConfig, EMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu import postprocessing as jax_pp
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.ops import decoder_trunk as jax_trunk
from emsanet_tpu.ops.nbt1d_chain import fold_bn as jax_fold_bn
from emsanet_tpu_torch import config as port_config
from emsanet_tpu_torch import postprocessing as pp
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models import emsanet as port_emsanet
from emsanet_tpu_torch.models.emsanet import build_model, build_train_model
from emsanet_tpu_torch.ops import decoder_trunk as trunk_ops
from emsanet_tpu_torch.ops.polyphase_upsample import parity_taps
from emsanet_tpu_torch.weights import load_flax_variables

H, W = 96, 128
TOL_F32 = 2e-4
TOL_BF16 = 2e-2
# the JAX test's geometry (tests/test_decoder_trunk.py)
N_CHANNELS = (32, 16, 8)
SKIP_CHANNELS = (16, 8, 4)
N_BLOCKS = 2
FLAGSHIP = (15, 20, (512, 256, 128), 512, (256, 128, 64), 3)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _jax_cfg(mode="interleave", megakernel="on", zero_init=True, h=H, w=W):
    return EMSANetConfig(
        model=JaxModelConfig(
            tasks=("semantic", "instance", "orientation", "scene"),
            enable_panoptic=True, input_height=h, input_width=w,
            rgb_encoder_backbone="resnet18",
            depth_encoder_backbone="resnet18",
            fused_inference=True, head_decode_fusion=mode,
            decoder_megakernel=megakernel,
            no_zero_init_decoder_residuals=not zero_init,
        ),
        data=DataConfig(dataset="synthetic"),
    ).validate()


def _port_cfg(h=H, w=W, **overrides):
    return port_config.flagship_config(
        input_height=h, input_width=w, rgb_encoder_backbone="resnet18",
        depth_encoder_backbone="resnet18", **overrides)


def _jax_variables(jcfg, seed):
    jds = jax_ds_config(jcfg.data)
    h, w = jcfg.model.input_height, jcfg.model.input_width
    dummy = {"rgb": jnp.zeros((1, h, w, 3)), "depth": jnp.zeros((1, h, w, 1))}
    shapes = jax.eval_shape(
        JaxEMSANet(cfg=jcfg.model, dataset_config=jds).init,
        jax.random.PRNGKey(0), dummy)
    return _random_variables(dict(shapes), seed)


# ---------------------------------------------------------------------------
# parameters


@pytest.mark.parametrize("zero_init", [True, False])
def test_stack_trunk_params_matches_reference(zero_init):
    """The port's stacking of converted flax weights against the JAX
    package's `stack_trunk_params` on the flax tree."""
    jcfg = _jax_cfg(zero_init=zero_init)
    variables = _jax_variables(jcfg, 31)
    tasks = ("semantic", "instance")
    want = jax_trunk.stack_trunk_params(
        [variables["params"][f"{t}_decoder"] for t in tasks],
        [variables["batch_stats"][f"{t}_decoder"] for t in tasks], 3, 3)
    model = build_model(
        _port_cfg(no_zero_init_decoder_residuals=not zero_init),
        get_dataset_config("synthetic"), device="cpu", seed=None)
    load_flax_variables(model, variables)
    got = trunk_ops.stack_trunk_params(
        [getattr(model, f"{t}_decoder") for t in tasks], torch.float32)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in w:
            if key in ("cin_w", "blk_w31", "blk_w13", "blk_b31", "blk_b13",
                       "proj_w"):
                np.testing.assert_array_equal(
                    g[key].numpy(), np.asarray(w[key]), err_msg=key)
            elif key != "ups_k":  # folded BatchNorms
                np.testing.assert_allclose(
                    g[key].numpy(), np.asarray(w[key]), rtol=1e-6,
                    atol=1e-7, err_msg=key)
        # (D, 2, 2, 3, 3, C): parity (p, q)'s non-zero taps are rows p, p+1
        # and columns q, q+1 of its 3x3, in row-major order
        ups = np.asarray(w["ups_k"])
        for p in range(4):
            pr, pc = divmod(p, 2)
            for t in range(4):
                a, b = divmod(t, 2)
                np.testing.assert_allclose(
                    g["ups"][:, p, t].numpy(),
                    ups[:, pr, pc, pr + a, pc + b], rtol=1e-6, atol=1e-7)
            zero = np.ones((3, 3), bool)
            zero[pr:pr + 2, pc:pc + 2] = False
            assert not ups[:, pr, pc][:, zero].any()


# ---------------------------------------------------------------------------
# the trunk: plain version vs the JAX kernel (interpret mode)


def _trunk_case(seed, n_dec, n, h0, w0):
    """Random stacked parameters in the JAX kernel's layout and the port's,
    the context output and the skips (numpy, f32)."""
    rng = np.random.RandomState(seed)
    ctx = rng.randn(n, h0, w0, N_CHANNELS[0]).astype(np.float32)
    skips, jax_mods, port_mods = [], [], []
    h, w, c_in = h0, w0, N_CHANNELS[0]
    for c, cs in zip(N_CHANNELS, SKIP_CHANNELS):
        h, w = 2 * h, 2 * w
        skips.append(rng.randn(n, h, w, cs).astype(np.float32))

        def draw(*shape, scale=0.08):
            return (rng.randn(n_dec, *shape) * scale).astype(np.float32)

        def bn(*shape):
            g = 1.0 + draw(*shape, scale=0.2)
            b, mean = draw(*shape, scale=0.2), draw(*shape, scale=0.2)
            var = rng.uniform(0.5, 1.5, (n_dec, *shape)).astype(np.float32)
            s, t = jax_fold_bn(g, b, mean, var)
            return np.asarray(s), np.asarray(t)

        cin_s, cin_t = bn(c)
        bn_s, bn_t = bn(N_BLOCKS, 2, c)
        proj_s, proj_t = bn(c)
        dw = draw(3, 3, 1, c, scale=0.3)
        mod = {
            "cin_w": draw(3, 3, c_in, c), "cin_s": cin_s, "cin_t": cin_t,
            "blk_w31": draw(N_BLOCKS, 2, 3, c, c),
            "blk_w13": draw(N_BLOCKS, 2, 3, c, c),
            "blk_b31": draw(N_BLOCKS, 2, c), "blk_b13": draw(N_BLOCKS, 2, c),
            "blk_bn_scale": bn_s, "blk_bn_shift": bn_t,
            "proj_w": draw(cs, c, scale=0.3), "proj_s": proj_s,
            "proj_t": proj_t,
        }
        jax_mods.append(dict(mod, ups_k=np.stack(
            [np.asarray(jax_trunk.polyphase_taps(jnp.asarray(k)))
             for k in dw])))
        port_mods.append(dict(
            {k: _t(v) for k, v in mod.items()},
            ups=torch.stack([parity_taps(_t(k).permute(3, 2, 0, 1),
                                         torch.float32) for k in dw])))
        c_in = c
    return ctx, skips, jax_mods, port_mods


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_dec,w0", [(1, 5), (2, 5), (2, 4), (3, 5)])
def test_plain_trunk_matches_jax_kernel(dtype, n_dec, w0):
    """D = 3 is the semantic + instance + normal stacking the TPU kernel
    takes; w0 = 5 is no multiple of 8 (the TPU kernel pads it)."""
    ctx, skips, jax_mods, port_mods = _trunk_case(40 + n_dec, n_dec, 2, 2, w0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_trunk.decoder_trunk(
        jnp.asarray(ctx, jdt), [jnp.asarray(s, jdt) for s in skips],
        [{k: jnp.asarray(v) for k, v in m.items()} for m in jax_mods]),
        np.float32)
    tdt = getattr(torch, dtype)
    per_module = [{k: (v.to(tdt) if k in ("cin_w", "blk_w31", "blk_w13",
                                          "proj_w") else v)
                   for k, v in m.items()} for m in port_mods]
    got = trunk_ops.decoder_trunk_plain(
        _t(ctx).to(tdt), [_t(s).to(tdt) for s in skips], per_module)
    assert got.dtype == tdt
    assert tuple(got.shape) == (n_dec, 2, 16, 8 * w0, N_CHANNELS[-1])
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL_BF16, err


def test_decoder_trunk_on_cpu_tensors_is_the_plain_version():
    _, skips, _, port_mods = _trunk_case(7, 2, 1, 2, 3)
    ctx = torch.randn(1, 2, 3, N_CHANNELS[0], generator=torch.Generator()
                      .manual_seed(0))
    trunk_ops.decoder_trunk.launches = 0
    got = trunk_ops.decoder_trunk(ctx, [_t(s) for s in skips], port_mods)
    want = trunk_ops.decoder_trunk_plain(ctx, [_t(s) for s in skips],
                                         port_mods)
    assert torch.equal(got, want)
    assert trunk_ops.decoder_trunk.launches == 0  # no kernel launched


# ---------------------------------------------------------------------------
# gate and config


def test_trunk_supported_flagship():
    assert trunk_ops.trunk_supported(1, *FLAGSHIP)
    assert trunk_ops.trunk_supported(2, *FLAGSHIP)
    assert not trunk_ops.trunk_supported(8, *FLAGSHIP)  # 'auto'
    assert trunk_ops.trunk_supported(8, *FLAGSHIP, max_batch=8)  # 'on'
    assert trunk_ops.MAX_BATCH == jax_trunk.MAX_BATCH
    # the kernel's limits: C a multiple of 64, C_s a multiple of 8
    assert not trunk_ops.trunk_supported(
        1, 15, 20, (512, 256, 96), 512, (256, 128, 64), 3)
    assert not trunk_ops.trunk_supported(
        1, 15, 20, (512, 256, 128), 512, (256, 128, 60), 3)
    # the reference's structural checks
    assert not trunk_ops.trunk_supported(1, 1, 20, *FLAGSHIP[2:])
    assert not trunk_ops.trunk_supported(
        1, 15, 20, (512, 256, 128), 512, (256, 128), 3)
    assert not trunk_ops.trunk_supported(1, *FLAGSHIP[:-1], 0)


class _Spy:
    """Counts the calls of `decoder_trunk` through the module attribute
    the model calls."""

    def __init__(self, monkeypatch):
        self.calls = 0
        orig = trunk_ops.decoder_trunk

        def spy(*args):
            self.calls += 1
            return orig(*args)

        monkeypatch.setattr(trunk_ops, "decoder_trunk", spy)


def _small_model(megakernel, train=False, **overrides):
    cfg = _port_cfg(64, 64, decoder_megakernel=megakernel, **overrides)
    ds = get_dataset_config("synthetic")
    if train:
        return build_train_model(cfg, ds, device="cpu", seed=0)
    return build_model(cfg, ds, device="cpu", seed=0)


def _batch(n, h=64, w=64):
    rng = np.random.RandomState(n)
    return {"rgb": _t(rng.randn(n, h, w, 3).astype(np.float32)),
            "depth": _t(rng.randn(n, h, w, 1).astype(np.float32))}


def test_auto_on_cpu_runs_the_unfused_decoders(monkeypatch):
    spy = _Spy(monkeypatch)
    trunk_ops.decoder_trunk.launches = 0
    assert port_config.ModelConfig().decoder_megakernel == "auto"
    _small_model("auto")(_batch(1))
    assert spy.calls == 0
    assert trunk_ops.decoder_trunk.launches == 0


@pytest.mark.parametrize("n", [1, 8])
def test_on_runs_the_trunk_at_any_batch(monkeypatch, n):
    spy = _Spy(monkeypatch)
    out = _small_model("on")(_batch(n))
    assert spy.calls == 1
    assert tuple(out["semantic"]["logits"].shape) == (n, 64, 64, 40)


def test_no_trunk_when_a_skip_needs_no_projection(monkeypatch):
    """Decoder channels equal to the skips' (256, 128, 64): the decoder
    adds the skip without a projection, which the kernel always applies."""
    spy = _Spy(monkeypatch)
    chans = (256, 128, 64)
    model = _small_model("on", semantic_decoder_n_channels=chans,
                         instance_decoder_n_channels=chans)
    model(_batch(1))
    assert spy.calls == 0


def test_training_ignores_on(monkeypatch):
    spy = _Spy(monkeypatch)
    cfg = port_config.EMSANetConfig(
        model=_port_cfg(64, 64, decoder_megakernel="on"),
        data=port_config.DataConfig(dataset="synthetic"))
    port_config.validate_train_for_port(cfg)  # no longer refused
    model = _small_model("on", train=True)
    assert model.training
    out = model(_batch(2))
    assert spy.calls == 0
    assert len(out["semantic"]["side_outputs"]) == 3


# ---------------------------------------------------------------------------
# the whole model, 'on' against the JAX model with 'on'


MODES = ("interleave", "decode-planes")


@pytest.fixture(scope="module")
def flagship_on():
    """One set of random flax variables; per mode the JAX model's raw
    outputs with 'on' and the port's with 'on' and 'off'."""
    jds = jax_ds_config(_jax_cfg().data)
    variables = _jax_variables(_jax_cfg(), 51)
    rng = np.random.RandomState(52)
    batch = {"rgb": rng.randn(2, H, W, 3).astype(np.float32),
             "depth": rng.randn(2, H, W, 1).astype(np.float32)}
    runs = {}
    for mode in MODES:
        jcfg = _jax_cfg(mode)
        jmodel = JaxEMSANet(cfg=jcfg.model, dataset_config=jds)
        jout = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, batch)
        pouts = {}
        for mk in ("on", "off"):
            pcfg = _port_cfg(head_decode_fusion=mode, decoder_megakernel=mk)
            pmodel = build_model(pcfg, get_dataset_config("synthetic"),
                                 device="cpu", seed=None)
            load_flax_variables(pmodel, variables)
            pouts[mk] = pmodel({k: _t(v) for k, v in batch.items()})
        runs[mode] = (jcfg, jout, pcfg, pouts)
    return runs, variables


def _compare_tree(jtree, ptree, path=""):
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ptree), (path, sorted(jtree),
                                                sorted(ptree))
        for k in jtree:
            _compare_tree(jtree[k], ptree[k], f"{path}/{k}")
    elif isinstance(jtree, (tuple, list)):
        assert len(jtree) == len(ptree), path
        for i, (a, b) in enumerate(zip(jtree, ptree)):
            _compare_tree(a, b, f"{path}/{i}")
    else:
        got, want = np.asarray(ptree), np.asarray(jtree)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=TOL_F32, rtol=TOL_F32,
                                   err_msg=path)


@pytest.mark.parametrize("mode", MODES)
def test_on_forward_matches_jax_on(flagship_on, mode):
    runs, _ = flagship_on
    _, jout, _, pouts = runs[mode]
    _compare_tree(jout, pouts["on"])


@pytest.mark.parametrize("mode", MODES)
def test_on_frame_matches_jax_on(flagship_on, mode):
    """Each side postprocesses its own raw outputs."""
    runs, _ = flagship_on
    jcfg, jout, pcfg, pouts = runs[mode]
    ds = get_dataset_config("synthetic")
    is_thing = np.asarray(ds.classes_is_thing, bool)
    want = jax.jit(lambda o, t: jax_pp.postprocess(o, t, jcfg.model))(
        jout, jnp.asarray(is_thing))
    got = pp.postprocess(pouts["on"], _t(is_thing), pcfg)
    assert sorted(want) == sorted(got)
    for key, share in (("semantic_segmentation_idx", 0.999),
                       ("panoptic_segmentation_deeplab", 0.99)):
        agree = (got[key].numpy() == np.asarray(want[key])).mean()
        assert agree >= share, (key, agree)
    np.testing.assert_array_equal(got["scene_class_idx"].numpy(),
                                  np.asarray(want["scene_class_idx"]))
    np.testing.assert_allclose(
        got["semantic_segmentation_score"].numpy(),
        np.asarray(want["semantic_segmentation_score"]), atol=TOL_F32,
        rtol=TOL_F32)


def test_on_matches_off(flagship_on):
    """The trunk against the port's own unfused decoders (which round
    elsewhere only in bf16; this is f32)."""
    runs, _ = flagship_on
    pouts = runs["interleave"][3]
    _compare_tree(pouts["off"], pouts["on"])


def test_trunk_params_cache_is_reused_and_rebuilt(flagship_on):
    _, variables = flagship_on
    model = build_model(_port_cfg(decoder_megakernel="on"),
                        get_dataset_config("synthetic"), device="cpu", seed=3)
    decoders = [model.semantic_decoder, model.instance_decoder]
    first = port_emsanet._cached_trunk_params(decoders, torch.float32)
    assert port_emsanet._cached_trunk_params(decoders, torch.float32) is first
    load_flax_variables(model, variables)
    second = port_emsanet._cached_trunk_params(decoders, torch.float32)
    assert second is not first
    want = trunk_ops.stack_trunk_params(decoders, torch.float32)
    for g, w in zip(second, want):
        for key in w:
            assert torch.equal(g[key], w[key]), key
