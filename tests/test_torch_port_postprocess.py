"""The port's postprocessing (emsanet_tpu_torch/postprocessing.py) against
the JAX package's `postprocess`, on identical head outputs.

Head outputs are made with numpy: block-wise semantic logits, a center
heatmap of Gaussian bumps (one of them a flat plateau, so the top-k tie
order and the duplicate-center suppression matter), offsets that vote
towards the bumps, orientations and scene logits. Integer maps and masks
must be equal; scores agree to 1e-6; orientation angles (atan2 of vector
sums taken in another order) to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu import postprocessing as jax_pp
from emsanet_tpu.datasets.metadata import get_metadata_config
from emsanet_tpu_torch import postprocessing as pp
from emsanet_tpu_torch.config import ModelConfig
from emsanet_tpu_torch.datasets.metadata import get_dataset_config

N, H, W, C = 2, 48, 64, 40
ORIENTATION_KEYS = ("orientations_instance",)


def _heads(seed, polyphase=False):
    rng = np.random.RandomState(seed)
    blocks = rng.randn(N, H // 8, W // 8, C).astype(np.float32) * 3
    logits = np.repeat(np.repeat(blocks, 8, 1), 8, 2)
    logits += rng.randn(N, H, W, C).astype(np.float32) * 0.5
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    center = np.zeros((N, H, W), np.float32)
    dy = np.zeros((N, H, W), np.float32)
    dx = np.zeros((N, H, W), np.float32)
    best = np.full((N, H, W), np.inf)
    for n in range(N):
        for _ in range(6):
            cy, cx = rng.randint(4, H - 4), rng.randint(4, W - 4)
            d2 = (ys - cy) ** 2 + (xs - cx) ** 2
            center[n] = np.maximum(center[n], 0.9 * np.exp(-d2 / 18.0))
            closer = d2 < best[n]
            best[n][closer] = d2[closer]
            dy[n][closer] = (cy - ys)[closer] / H
            dx[n][closer] = (cx - xs)[closer] / W
        # a flat plateau: tied maxima a few pixels apart
        center[n, 10:13, 30:34] = 0.95
    offset = np.stack([dy, dx], -1) + rng.randn(N, H, W, 2).astype(
        np.float32) * 0.01
    out = {
        "semantic": {"side_outputs": ()},
        "instance": {
            "side_outputs": (),
            "center": center[..., None],
            "offset": offset.astype(np.float32),
            "orientation": rng.randn(N, H, W, 2).astype(np.float32),
        },
        "scene": {"logits": rng.randn(N, 9).astype(np.float32)},
    }
    if polyphase:
        y = logits.reshape(N, H // 2, 2, W // 2, 2, C)
        out["semantic"]["logits_polyphase"] = np.ascontiguousarray(
            y.transpose(0, 1, 3, 5, 2, 4).reshape(N, H // 2, W // 2, 4 * C))
    else:
        out["semantic"]["logits"] = logits
    return out


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, fn) for v in tree)
    return fn(tree)


def _run_both(heads, panoptic=True, gt_foreground=None):
    is_thing = np.asarray(
        get_dataset_config("synthetic").classes_is_thing, bool)
    use_orient = np.asarray(
        get_dataset_config("synthetic").classes_use_orientations, bool)
    assert tuple(is_thing) == tuple(
        get_metadata_config("synthetic").semantic_label_list.classes_is_thing)
    jcfg = JaxModelConfig(tasks=("semantic", "instance", "orientation",
                                 "scene"), enable_panoptic=panoptic,
                          head_decode_fusion="interleave")
    pcfg = ModelConfig(tasks=jcfg.tasks, enable_panoptic=panoptic)
    jgt = None if gt_foreground is None else jnp.asarray(gt_foreground)
    want = jax.jit(lambda o, t, u, g: jax_pp.postprocess(
        o, t, jcfg, gt_foreground=g, use_orientations=u))(
        _to(heads, jnp.asarray), jnp.asarray(is_thing),
        jnp.asarray(use_orient), jgt)
    got = pp.postprocess(
        _to(heads, torch.from_numpy), torch.from_numpy(is_thing), pcfg,
        gt_foreground=(None if gt_foreground is None
                       else torch.from_numpy(gt_foreground)),
        use_orientations=torch.from_numpy(use_orient))
    return {k: np.asarray(v) for k, v in want.items()}, {
        k: v.numpy() for k, v in got.items()}


def _compare(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = want[k], got[k]
        assert w.shape == g.shape, k
        if np.issubdtype(w.dtype, np.floating):
            tol = 1e-5 if k in ORIENTATION_KEYS else 1e-6
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("polyphase", [False, True])
def test_postprocess_matches_jax(polyphase):
    want, got = _run_both(_heads(0, polyphase))
    _compare(want, got)
    # the inputs must exercise centers, grouping and the merge
    assert want["instance_centers_valid"].sum() >= 4
    assert (want["instance_segmentation"] > 0).mean() > 0.2
    assert want["panoptic_instance_meta_valid"].sum() >= 2


def test_postprocess_without_panoptic_matches_jax():
    want, got = _run_both(_heads(1), panoptic=False)
    assert "orientations_instance" in got
    _compare(want, got)


def test_postprocess_gt_foreground_matches_jax():
    fg = np.random.RandomState(2).rand(N, H, W) > 0.3
    want, got = _run_both(_heads(2), gt_foreground=fg)
    assert "instance_segmentation_gt_foreground" in got
    _compare(want, got)


def test_top_k_breaks_ties_by_lowest_index():
    flat = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9]])
    vals, idx = pp._top_k(flat, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(flat.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("k", [3, 4, 17])
def test_nms_keep_mask_matches_jax(k):
    hm = np.random.RandomState(k).rand(2, 20, 24).astype(np.float32)
    hm[0, 5:8, 5:8] = 2.0  # plateau
    want = jax_pp._nms_keep_mask(jnp.asarray(hm), k)
    got = pp._nms_keep_mask(torch.from_numpy(hm), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
