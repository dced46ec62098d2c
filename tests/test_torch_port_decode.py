"""The port's 'decode*' inference modes against the JAX package, on the CPU.

Covers the three kernels of those modes through their plain versions
(`ops/semantic_decode.py`, `ops/instance_head.py`,
`ops/plane_interleave.py`; the JAX kernels run in Pallas interpret mode,
as their own tests run them), the parity-plane postprocessing helpers,
and a whole 128x160 resnet18 flagship in 'decode', 'decode-both' and
'decode-planes'. 128x160 is the smallest flagship size at which the heads
defer: the final x2 stage's input, 64x80, passes the 60*80 polyphase
gate. Inputs and weights come from numpy seeds; everything runs at f32.

Tolerances:
- polyphase parity weights: 1e-6 (sums of up to four taps, added in
  another order); the kernels' parity taps are exactly those weights;
- semantic decode: index exact; score 1e-5 relative;
- instance head: 1e-5 relative to the largest magnitude;
- plane interleave, NMS masks, centers, grouping: bit-exact;
- the whole model's raw outputs: atol 1e-4 / rtol 1e-3 (conv
  accumulation order differs between XLA and PyTorch), as the model
  tests; postprocessing of the same raw outputs: integer and bool maps
  exact, float maps atol 1e-4 / rtol 1e-3; the port's own frame against
  the JAX frame: at least 0.999 of the semantic and 0.99 of the panoptic
  pixels agree (a near-tie argmax may flip under the 1e-5 raw-output
  differences).
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
from emsanet_tpu.config import best_head_decode_fusion as jax_best_mode
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.ops import instance_head as jax_head
from emsanet_tpu.ops import polyphase_upsample as jax_polyphase
from emsanet_tpu.ops import semantic_decode as jax_decode
from emsanet_tpu.ops.plane_interleave import interleave_planes_pallas
from emsanet_tpu_torch import config as port_config
from emsanet_tpu_torch import postprocessing as pp
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.models.emsanet import build_model
from emsanet_tpu_torch.ops import instance_head, plane_interleave
from emsanet_tpu_torch.ops import polyphase_upsample, semantic_decode
from emsanet_tpu_torch.weights import load_flax_variables

H, W = 128, 160
MODES = ("decode", "decode-both", "decode-planes")
ATOL, RTOL = 1e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _weight(kernel):
    """flax (3, 3, 1, C) depthwise kernel -> torch (C, 1, 3, 3)."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _head_case(seed, n, h2, w2, c):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h2, w2, c) * 2).astype(np.float32)
    k = rng.randn(3, 3, 1, c).astype(np.float32)
    return x, k


# ---------------------------------------------------------------------------
# the mode choice and the parity weights the kernels share


@pytest.mark.parametrize("batch", [1, 8, 15, 16, 32])
@pytest.mark.parametrize("with_postprocessing", [True, False])
def test_best_head_decode_fusion_matches_jax(batch, with_postprocessing):
    mode = port_config.best_head_decode_fusion(batch, with_postprocessing)
    assert mode == jax_best_mode(batch, with_postprocessing)
    assert mode in port_config.HEAD_DECODE_FUSIONS


def test_config_runs_every_head_mode_and_defaults_to_decode():
    assert port_config.ModelConfig().head_decode_fusion == "decode"
    for mode in port_config.HEAD_DECODE_FUSIONS:
        cfg = port_config.flagship_config(head_decode_fusion=mode)
        assert port_config.validate_for_port(cfg) is cfg
    with pytest.raises(ValueError, match="head_decode_fusion"):
        port_config.validate_for_port(
            port_config.flagship_config(head_decode_fusion="fused"))


@pytest.mark.parametrize("c", [1, 5, 40])
def test_polyphase_kernels_match_jax(c):
    _, k = _head_case(c, 1, 1, 1, c)
    want = np.asarray(jax_polyphase.polyphase_kernels(jnp.asarray(k)))
    got = polyphase_upsample.polyphase_kernels(_weight(k))  # (4C, 1, 3, 3)
    # flax (3, 3, 1, 4C) layout; sums of up to four taps, in another order
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_parity_taps_are_the_nonzero_polyphase_taps(dtype):
    """(4, 4, C) taps, tap a*2+b of parity pr*2+pc at row pr+a and column
    pc+b of that parity's 3x3 kernel, rounded to the compute dtype; the
    other five taps of each parity kernel are zero."""
    c = 7
    w = _weight(_head_case(3, 1, 1, 1, c)[1])
    kp = polyphase_upsample.polyphase_kernels(w).reshape(c, 4, 3, 3)
    taps = polyphase_upsample.parity_taps(w, dtype)
    assert tuple(taps.shape) == (4, 4, c) and taps.dtype == torch.float32
    for p in range(4):
        pr, pc = divmod(p, 2)
        used = torch.zeros(3, 3, dtype=torch.bool)
        for a in (0, 1):
            for b in (0, 1):
                used[pr + a, pc + b] = True
                torch.testing.assert_close(
                    taps[p, a * 2 + b], kp[:, p, pr + a, pc + b].to(dtype)
                    .float(), rtol=0, atol=0)
        assert not bool(kp[:, p][:, ~used].any())


# ---------------------------------------------------------------------------
# semantic decode (TPU kernel 5)

DECODE_CASES = [
    pytest.param(2, 16, 24, 40, None, id="c40"),
    pytest.param(1, 10, 12, 37, None, id="c37-unaligned"),
    pytest.param(1, 6, 130, 8, None, id="w130-not-128-multiple"),
    pytest.param(2, 8, 16, 5, 8, id="one-tile"),
]


@pytest.mark.parametrize("n,h2,w2,c,tile_h", DECODE_CASES)
@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["planes", "interleaved"])
def test_semantic_decode_plain_matches_jax(n, h2, w2, c, tile_h,
                                           interleaved):
    x, k = _head_case(n * 100 + h2 + w2 + c, n, h2, w2, c)
    jfn = (jax_decode.semantic_decode_fused_interleaved if interleaved
           else jax_decode.semantic_decode_fused_planes)
    want_idx, want_score = jfn(jnp.asarray(x), jnp.asarray(k), tile_h=tile_h)
    pfn = (semantic_decode.semantic_decode_interleaved if interleaved
           else semantic_decode.semantic_decode_planes)
    idx, score = pfn(_t(x), _weight(k))
    shape = (n, 2 * h2, 2 * w2) if interleaved else (n, 4, h2, w2)
    assert tuple(idx.shape) == shape and idx.dtype == torch.int32
    assert score.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               rtol=1e-5, atol=0)
    if interleaved:  # and the jnp oracle of the TPU kernel
        ridx, rscore = jax_decode.semantic_decode_reference(
            jnp.asarray(x), jnp.asarray(k))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_allclose(score.numpy(), np.asarray(rscore),
                                   rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# instance head (TPU kernel 6)


@pytest.mark.parametrize("c", [5, 3])
@pytest.mark.parametrize("sigmoid,tanh", [(True, True), (False, False)])
@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["planes", "interleaved"])
def test_instance_head_plain_matches_jax(c, sigmoid, tanh, interleaved):
    n, h2, w2 = 2, 12, 20
    x, k = _head_case(c * 10 + sigmoid, n, h2, w2, c)
    enc = instance_head.encodings_for(c, sigmoid, tanh)
    assert enc == jax_head.encodings_for(c, sigmoid, tanh)
    jfn = (jax_head.instance_head_upsample_interleaved if interleaved
           else jax_head.instance_head_upsample)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k), encodings=enc))
    pfn = (instance_head.instance_head_upsample_interleaved if interleaved
           else instance_head.instance_head_upsample)
    got = pfn(_t(x), _weight(k), enc)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    if not interleaved:
        ref = jax_head.instance_head_upsample_reference(
            jnp.asarray(x), jnp.asarray(k), enc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                                   rtol=0)


# ---------------------------------------------------------------------------
# plane interleave (TPU kernel 7) and the plane helpers


@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_interleave_planes_plain_matches_jax(dtype):
    rng = np.random.RandomState(0)
    shape = (2, 4, 6, 10)
    maps = {
        "float32": rng.randn(*shape).astype(np.float32),
        "int32": rng.randint(-2**31, 2**31 - 1, shape).astype(np.int32),
        "bool": rng.rand(*shape) > 0.5,
    }
    named = {"a": maps[dtype], "b": maps[dtype][::-1].copy()}
    want = interleave_planes_pallas({k: jnp.asarray(v)
                                     for k, v in named.items()},
                                    interpret=True)
    got = plane_interleave.interleave_planes({k: _t(v)
                                              for k, v in named.items()})
    assert sorted(got) == sorted(want)
    for key in named:
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
        np.testing.assert_array_equal(
            got[key].numpy(),
            np.asarray(jax_pp.interleave_plane(jnp.asarray(named[key]))))


def test_deinterleave_plane_matches_jax_and_round_trips():
    full = np.random.RandomState(1).randn(3, 8, 12).astype(np.float32)
    got = pp.deinterleave_plane(_t(full))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pp.deinterleave_plane(jnp.asarray(full))))
    np.testing.assert_array_equal(pp.interleave_plane(got).numpy(), full)


@pytest.mark.parametrize("lo,hi,axis", [(-4, 4, 2), (-4, 3, 3), (1, 2, 2),
                                        (-3, -1, 3), (2, 1, 2)])
def test_pool1d_matches_jax(lo, hi, axis):
    x = np.random.RandomState(2).randn(2, 2, 7, 9).astype(np.float32)
    want = jax_pp._pool1d(jnp.asarray(x), lo, hi, axis)
    got = pp._pool1d(_t(x), lo, hi, axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [2, 3, 4, 16, 17])
def test_nms_keep_mask_planes_matches_jax(k):
    rng = np.random.RandomState(k)
    hm = rng.rand(2, 2, 2, 12, 16).astype(np.float32)
    hm[0, :, :, 3:5, 3:6] = 2.0  # a plateau across parities
    want = jax_pp._nms_keep_mask_planes(jnp.asarray(hm), k)
    got = pp._nms_keep_mask_planes(_t(hm), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = pp.interleave_plane(_t(hm).reshape(2, 4, 12, 16))
    np.testing.assert_array_equal(
        pp.interleave_plane(got.reshape(2, 4, 12, 16)).numpy(),
        pp._nms_keep_mask(full, k).numpy())


def _center_planes(seed, n=2, h=24, w=32):
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    hm = np.zeros((n, h, w), np.float32)
    for i in range(n):
        for _ in range(4):
            cy, cx = rng.randint(2, h - 2), rng.randint(2, w - 2)
            hm[i] = np.maximum(hm[i], 0.9 * np.exp(
                -((ys - cy) ** 2 + (xs - cx) ** 2) / 8.0))
        hm[i, 4:7, 20:24] = 0.95  # a tied plateau
    return np.asarray(jax_pp.deinterleave_plane(jnp.asarray(hm)))


@pytest.mark.parametrize("with_fg", [False, True])
def test_find_instance_centers_planes_matches_jax(with_fg):
    planes = _center_planes(3)
    fg = np.random.RandomState(4).rand(*planes.shape) > 0.2 if with_fg \
        else None
    want = jax_pp.find_instance_centers_planes(
        jnp.asarray(planes), nms_kernel_size=5, top_k=16,
        foreground_planes=None if fg is None else jnp.asarray(fg))
    got = pp.find_instance_centers_planes(
        _t(planes), nms_kernel_size=5, top_k=16,
        foreground_planes=None if fg is None else _t(fg))
    assert int(got["valid"].sum()) >= 4
    for key in ("yx", "scores", "valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("threshold", [None, 6.0])
def test_group_pixels_to_instances_planes_matches_jax(threshold):
    rng = np.random.RandomState(5)
    n, h2, w2, k = 2, 12, 16, 8
    off_y = (rng.randn(n, 4, h2, w2) * 0.1).astype(np.float32)
    off_x = (rng.randn(n, 4, h2, w2) * 0.1).astype(np.float32)
    yx = rng.randint(0, 2 * h2, (n, k, 2)).astype(np.int32)
    valid = rng.rand(n, k) > 0.3
    fg = rng.rand(n, 4 * h2 * w2) > 0.4
    want = jax_pp.group_pixels_to_instances_planes(
        jnp.asarray(yx), jnp.asarray(valid), jnp.asarray(off_y),
        jnp.asarray(off_x), jnp.asarray(fg), (2 * h2, 2 * w2),
        offset_distance_threshold=threshold)
    got = pp.group_pixels_to_instances_planes(
        _t(yx), _t(valid), _t(off_y), _t(off_x), _t(fg), (2 * h2, 2 * w2),
        offset_distance_threshold=threshold)
    assert (got.numpy() > 0).mean() > 0.3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the slice: a 128x160 flagship in each decode mode


@pytest.fixture(scope="module")
def flagship():
    """A resnet18 flagship at 128x160 with random flax variables drawn
    once; per mode, the flax model's and the port's raw outputs on one
    batch."""
    def jax_cfg(mode):
        return EMSANetConfig(
            model=JaxModelConfig(
                tasks=("semantic", "instance", "orientation", "scene"),
                enable_panoptic=True, input_height=H, input_width=W,
                rgb_encoder_backbone="resnet18",
                depth_encoder_backbone="resnet18",
                fused_inference=True, head_decode_fusion=mode,
                decoder_megakernel="off",
            ),
            data=DataConfig(dataset="synthetic"),
        ).validate()

    jds = jax_ds_config(jax_cfg(MODES[0]).data)
    dummy = {"rgb": jnp.zeros((1, H, W, 3)), "depth": jnp.zeros((1, H, W, 1))}
    shapes = jax.eval_shape(
        JaxEMSANet(cfg=jax_cfg(MODES[0]).model, dataset_config=jds).init,
        jax.random.PRNGKey(0), dummy)
    variables = _random_variables(dict(shapes), 21)
    rng = np.random.RandomState(22)
    batch = {"rgb": rng.randn(2, H, W, 3).astype(np.float32),
             "depth": rng.randn(2, H, W, 1).astype(np.float32)}
    gt_fg = rng.rand(2, H, W) > 0.5
    runs = {}
    for mode in MODES:
        jcfg = jax_cfg(mode)
        jmodel = JaxEMSANet(cfg=jcfg.model, dataset_config=jds)
        jout = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, batch)
        pcfg = port_config.flagship_config(
            input_height=H, input_width=W, rgb_encoder_backbone="resnet18",
            depth_encoder_backbone="resnet18", head_decode_fusion=mode)
        pmodel = build_model(pcfg, get_dataset_config("synthetic"),
                             device="cpu", seed=None)
        load_flax_variables(pmodel, variables)
        pout = pmodel({k: _t(v) for k, v in batch.items()})
        runs[mode] = (jcfg, jout, pcfg, pout)
    return runs, gt_fg


def _flax_layout(tree):
    """The port's raw outputs with the depthwise weight in flax layout."""
    if isinstance(tree, dict):
        return {k: (v.permute(2, 3, 1, 0) if k == "kernel" else
                    _flax_layout(v)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_flax_layout(v) for v in tree)
    return tree


def _to_port(tree):
    """JAX raw outputs -> torch, the depthwise weight in torch layout."""
    if isinstance(tree, dict):
        return {k: (_weight(v) if k == "kernel" else _to_port(v))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_port(v) for v in tree)
    return _t(tree)


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
        got = ptree.detach().numpy()
        want = np.asarray(jtree)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=path)


@pytest.mark.parametrize("mode", MODES)
def test_decode_mode_forward_matches_flax(flagship, mode):
    runs, _ = flagship
    _, jout, _, pout = runs[mode]
    assert "decode_input" in pout["semantic"]
    assert ("decode_input" in pout["instance"]) == (mode != "decode")
    assert tuple(pout["semantic"]["decode_input"]["x"].shape) == (
        2, H // 2, W // 2, 40)
    _compare_tree(jout, _flax_layout(pout))


def _postprocess_both(run, heads, gt_fg):
    jcfg, jout, pcfg, _ = run
    ds = get_dataset_config("synthetic")
    is_thing = np.asarray(ds.classes_is_thing, bool)
    use_orient = np.asarray(ds.classes_use_orientations, bool)
    want = jax.jit(lambda o, t, u, g: jax_pp.postprocess(
        o, t, jcfg.model, gt_foreground=g, use_orientations=u))(
        jout, jnp.asarray(is_thing), jnp.asarray(use_orient),
        jnp.asarray(gt_fg))
    got = pp.postprocess(heads, _t(is_thing), pcfg,
                         gt_foreground=_t(gt_fg),
                         use_orientations=_t(use_orient))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("mode", MODES)
def test_decode_mode_postprocess_matches_jax(flagship, mode):
    """Both postprocessings on the same (the flax model's) raw outputs."""
    runs, gt_fg = flagship
    want, got = _postprocess_both(runs[mode], _to_port(runs[mode][1]), gt_fg)
    assert sorted(want) == sorted(got)
    assert ("instance_head_planes" in got) == (mode == "decode-planes")
    for key in want:
        w, g = want[key], got[key]
        assert w.shape == g.shape and w.dtype == g.dtype, key
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    # the inputs exercise centers, grouping and the merge
    assert want["instance_centers_valid"].sum() >= 4
    assert (want["instance_segmentation"] > 0).mean() > 0.05
    assert (want["instance_segmentation_gt_foreground"] > 0).mean() > 0.05


@pytest.mark.parametrize("mode", MODES)
def test_decode_mode_frame_matches_jax(flagship, mode):
    """The port's whole frame (its own raw outputs) against the JAX one."""
    runs, gt_fg = flagship
    want, got = _postprocess_both(runs[mode], runs[mode][3], gt_fg)
    assert sorted(want) == sorted(got)
    for key, share in (("semantic_segmentation_idx", 0.999),
                       ("panoptic_segmentation_deeplab", 0.99),
                       ("instance_segmentation_gt_foreground", 0.99)):
        agree = (got[key] == want[key]).mean()
        assert agree >= share, (key, agree)
    np.testing.assert_array_equal(got["scene_class_idx"],
                                  want["scene_class_idx"])
