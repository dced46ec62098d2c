"""The port's visualization (`emsanet_tpu_torch/visualization.py`) and
host image operations (`imaging.py`) against the JAX package's and PIL,
on the CPU.

Every renderer is held to the JAX package's bit for bit on numpy-seeded
maps; the colour generators keep their assignments across images, as
the reference's shared ones do. The orientation overlay's mask fill is
bit for bit (`draw_arrows=False`). Its arrows and text are the port's
own rendering, held by this measure: with arrows, every pixel outside
both renderers' strokes (the pixels where each differs from its
arrow-free fill), dilated by `thickness`, is equal; and on the black
background, the port's white (arrow) pixels have an IoU >= 0.6 with
PIL's. The bicubic resize is held to PIL's `Image.resize` within one
level per channel (it agrees exactly on these inputs), and is an
unchanged copy where the size does not change. `visualize_predictions`
and `visualize_batches` write the same files as the JAX package's for a
synthetic validation batch, compared decoded (the port's zlib stream
is not PIL's), in both prediction layouts.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image, ImageDraw

from emsanet_tpu import visualization as jv
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu_torch import imaging
from emsanet_tpu_torch import visualization as pv
from emsanet_tpu_torch.config import (
    DataConfig,
    EMSANetConfig,
    ModelConfig,
    TrainConfig,
    validate_train_for_port,
)
from emsanet_tpu_torch.data import get_datahelper
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.png import read_png
from emsanet_tpu_torch.metrics import LABEL_DIVISOR
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor

H, W = 48, 64
THICKNESS = 3
IOU_MIN = 0.6


def _rng(seed=0):
    return np.random.RandomState(seed)


def _instance_map(rng, n=6, h=H, w=W):
    """Rectangles of ids 1..n on 0."""
    inst = np.zeros((h, w), np.int32)
    for i in range(1, n + 1):
        y, x = rng.randint(0, h - 12), rng.randint(0, w - 12)
        inst[y:y + rng.randint(6, 12), x:x + rng.randint(6, 12)] = i
    return inst


def _ds():
    return get_dataset_config("nyuv2"), jax_ds_config(
        JaxDataConfig(dataset="nyuv2"))


def _maps(seed=0):
    rng = _rng(seed)
    return {
        "semantic": rng.randint(-2, 45, (H, W)),
        "heat": rng.uniform(-0.2, 1.2, (H, W)).astype(np.float32),
        "depth": np.where(rng.rand(H, W) < 0.2, 0,
                          rng.uniform(0.5, 9, (H, W))).astype(np.float32),
        "vec": rng.randn(H, W, 2).astype(np.float32),
        "fg": rng.rand(H, W) < 0.6,
        "rgb": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
    }


RENDERERS = {
    "semantic": lambda m, mod, ds: mod.visualize_semantic(
        m["semantic"], ds.semantic_label_list.colors_array
        if mod is jv else pv.semantic_colors(ds)),
    "heatmap": lambda m, mod, ds: mod.visualize_heatmap(m["heat"]),
    "score": lambda m, mod, ds: mod.visualize_score(m["heat"]),
    "depth": lambda m, mod, ds: mod.visualize_depth(m["depth"]),
    "depth_hw1": lambda m, mod, ds: mod.visualize_depth(m["depth"][..., None]),
    "depth_empty": lambda m, mod, ds: mod.visualize_depth(0 * m["depth"]),
    "instance_offset": lambda m, mod, ds: mod.visualize_instance_offset(
        m["vec"]),
    "instance_center": lambda m, mod, ds: mod.visualize_instance_center(
        m["heat"]),
    "instance_center_hw1": lambda m, mod, ds: mod.visualize_instance_center(
        m["heat"][..., None]),
    "orientation": lambda m, mod, ds: mod.visualize_orientation(m["vec"]),
    "orientation_fg": lambda m, mod, ds: mod.visualize_orientation(
        m["vec"], m["fg"]),
    "blend": lambda m, mod, ds: mod.blend(m["rgb"], 255 - m["rgb"], 0.3),
}


@pytest.mark.parametrize("name", sorted(RENDERERS))
def test_renderer_matches_jax(name):
    m = _maps()
    ds, jds = _ds()
    got = RENDERERS[name](m, pv, ds)
    want = RENDERERS[name](m, jv, jds)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_color_generators_keep_their_assignments_across_images():
    """Instance and panoptic maps of three images through one set of
    generators, as the reference's shared ones: the same colours."""
    ds, jds = _ds()
    gens = pv.ColorGenerators.for_dataset(ds)
    jv.setup_shared_color_generators(jds)
    rng = _rng(3)
    is_thing = np.asarray(ds.classes_is_thing)
    for _ in range(3):
        inst = _instance_map(rng, n=rng.randint(2, 9))
        np.testing.assert_array_equal(
            pv.visualize_instance(inst, gens.instance),
            jv.visualize_instance(inst))
        sem = rng.randint(0, 41, (H, W))
        pan = sem * LABEL_DIVISOR + np.where(is_thing[sem], inst, 0)
        np.testing.assert_array_equal(
            pv.visualize_panoptic(pan, color_generator=gens.panoptic),
            jv.visualize_panoptic(pan, jds))
    # without a generator: a fresh one, as the reference without setup
    jv._SHARED.clear()
    np.testing.assert_array_equal(pv.visualize_instance(inst),
                                  jv.visualize_instance(inst))
    np.testing.assert_array_equal(pv.visualize_panoptic(pan, ds),
                                  jv.visualize_panoptic(pan, jds))


def test_dense_instance_maps_match_jax():
    rng = _rng(4)
    dense = {"instance_centers": rng.rand(2, H, W, 1),
             "instance_offsets": rng.randn(2, H, W, 2),
             "instance_orientation": rng.randn(2, H, W, 2)}
    planes = {"instance_head_planes": rng.randn(2, 5, 4, H // 2, W // 2)}
    for preds in (dense, planes, {"instance_head_planes":
                                  planes["instance_head_planes"][:, :3]},
                  {}):
        for got, want in zip(pv.dense_instance_maps(preds, 1),
                             jv.dense_instance_maps(preds, 1)):
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)


def _overlay_case(seed):
    rng = _rng(seed)
    inst = _instance_map(rng, n=7, h=96, w=128)
    oris = {i: float(rng.uniform(0, 2 * np.pi)) for i in range(1, 8)}
    oris[9] = 1.0  # absent from the map: skipped
    return inst, oris


@pytest.mark.parametrize("bg", [0, 255])
@pytest.mark.parametrize("shared", [True, False])
def test_orientation_fill_matches_jax(bg, shared):
    inst, oris = _overlay_case(5)
    kw = dict(bg_color=bg, bg_color_font="black" if bg == 0 else "white",
              draw_arrows=False)
    gen = pv.InstanceColorGenerator() if shared else None
    jgen = jv.InstanceColorGenerator() if shared else None
    np.testing.assert_array_equal(
        pv.visualize_instance_orientations(inst, oris, gen, **kw),
        jv.visualize_instance_orientations(inst, oris, jgen, **kw))


def _dilate(mask, r):
    out = np.zeros_like(mask)
    h, w = mask.shape
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] |= \
                mask[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("bg", [0, 255])
def test_orientation_arrows_against_pil(seed, bg):
    """The measure of the module docstring: equal outside both strokes
    (dilated by the thickness); on black, white-pixel IoU >= 0.6."""
    inst, oris = _overlay_case(seed)
    kw = dict(bg_color=bg, bg_color_font="black" if bg == 0 else "white",
              thickness=THICKNESS)
    gen, jgen = pv.InstanceColorGenerator(), jv.InstanceColorGenerator()
    fill = pv.visualize_instance_orientations(inst, oris, gen,
                                              draw_arrows=False, **kw)
    got = pv.visualize_instance_orientations(inst, oris, gen, **kw)
    want = jv.visualize_instance_orientations(inst, oris, jgen, **kw)
    strokes = (got != fill).any(-1) | (want != fill).any(-1)
    assert strokes.any()
    outside = ~_dilate(strokes, THICKNESS)
    np.testing.assert_array_equal(got[outside], want[outside])
    if bg == 0:
        white_got = (got == 255).all(-1) & ~(fill == 255).all(-1)
        white_want = (want == 255).all(-1) & ~(fill == 255).all(-1)
        assert white_want.any()
        assert _iou(white_got, white_want) >= IOU_MIN


def test_draw_line_against_pil():
    """Each of 40 random 3-pixel-wide segments: IoU >= 0.6 with PIL's
    `ImageDraw.line`, the end points truncated alike."""
    rng = _rng(8)
    for _ in range(40):
        p0, p1 = tuple(rng.uniform(5, 75, 2)), tuple(rng.uniform(5, 75, 2))
        ref = Image.new("RGB", (80, 80))
        ImageDraw.Draw(ref).line([p0, p1], fill=(255, 255, 255),
                                 width=THICKNESS)
        got = np.zeros((80, 80, 3), np.uint8)
        imaging.draw_line(got, p0, p1, (255, 255, 255), THICKNESS)
        assert _iou(got[..., 0] > 0, np.asarray(ref)[..., 0] > 0) >= IOU_MIN


def test_draw_text_writes_digits_and_degree_sign():
    img = np.zeros((30, 80, 3), np.uint8)
    imaging.draw_text(img, (3.7, 2.2), "360°", (255, 255, 255), 2)
    ys, xs = np.nonzero(img[..., 0])
    assert ys.min() == 2 and xs.min() == 3 and ys.max() < 2 + 14
    # 4 glyphs, 1 font pixel apart; the last ('°') 4 wide
    assert xs.max() == 3 + 2 * (3 * 6 + 4) - 1
    with pytest.raises(KeyError):
        imaging.draw_text(img, (0, 0), "a", (255, 0, 0))


@pytest.mark.parametrize("shape", [
    (540, 960, 3, 480, 640),   # the Kinect-v2 panel case
    (97, 131, 3, 480, 640),    # upscaling
    (60, 200, 3, 61, 64),      # one axis nearly unchanged
    (50, 70, 1, 33, 21),
])
def test_resize_matches_pil(shape):
    h, w, c, oh, ow = shape
    rng = _rng(9)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    img[: h // 2] = img[: h // 2] // 32 * 32  # flat areas and edges
    if c == 1:
        img = img[..., 0]
    want = np.asarray(Image.fromarray(img).resize((ow, oh)))
    got = imaging.resize_bicubic_u8(img, oh, ow)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_resize_to_the_same_size_is_an_exact_copy():
    img = _rng(10).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    got = imaging.resize_bicubic_u8(img, 48, 64)
    assert got is not img
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(
        got, np.asarray(Image.fromarray(img).resize((64, 48))))


# ---------------------------------------------------------------------------
# the writers on a synthetic validation batch


@pytest.fixture(scope="module")
def batch():
    """A b2 synthetic validation batch of the test preprocessor (raw
    inputs kept), 64x96."""
    cfg = validate_train_for_port(EMSANetConfig(
        model=ModelConfig(tasks=("semantic", "instance", "orientation",
                                 "scene"), enable_panoptic=True,
                          input_height=64, input_width=96),
        data=DataConfig(dataset="synthetic", batch_size=2,
                        validation_batch_size=2, synthetic_n_samples=2,
                        n_workers=1),
        train=TrainConfig(visualize_validation=True)))
    ds = get_dataset_config("synthetic")
    data = get_datahelper(cfg)
    data.set_valid_preprocessor(get_preprocessor(cfg, ds, "test"))
    (loader,) = data.valid_loaders.values()
    out = next(iter(loader.batches(0)))
    data.close()
    return out


def _predictions(batch, layout):
    """Predictions drawn from the batch's ground truth and numpy."""
    rng = _rng(11)
    n, h, w = batch["semantic"].shape
    inst = batch["instance"].astype(np.int32)
    preds = {
        "semantic_segmentation_idx": np.clip(batch["semantic"] - 1, 0, 39),
        "semantic_segmentation_score": rng.rand(n, h, w).astype(np.float32),
        "instance_segmentation": inst,
        "panoptic_segmentation_deeplab": batch["panoptic"],
        "panoptic_foreground_mask": inst > 0,
        "orientations_instance": rng.uniform(
            0, 2 * np.pi, (n, 64)).astype(np.float32),
        "orientations_panoptic_instance_valid": rng.rand(n, 64) < 0.8,
        "scene_class_idx": np.array([2, 50]),
        "scene_class_score": rng.rand(n).astype(np.float32),
    }
    if layout == "dense":
        preds.update(
            instance_centers=rng.rand(n, h, w, 1).astype(np.float32),
            instance_offsets=rng.randn(n, h, w, 2).astype(np.float32),
            instance_orientation=rng.randn(n, h, w, 2).astype(np.float32))
    else:
        preds["instance_head_planes"] = rng.randn(
            n, 5, 4, h // 2, w // 2).astype(np.float32)
    return preds


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _without_arrows(fn):
    return lambda *a, **kw: fn(*a, **{**kw, "draw_arrows": False})


@pytest.mark.parametrize("layout", ["dense", "planes"])
def test_writers_match_jax(batch, layout, tmp_path, monkeypatch):
    """Every file, decoded, bit for bit; the orientation overlays
    without their arrows and text (held to PIL's above)."""
    for mod in (pv, jv):
        monkeypatch.setattr(mod, "visualize_instance_orientations",
                            _without_arrows(
                                mod.visualize_instance_orientations))
    ds = get_dataset_config("synthetic")
    jds = jax_ds_config(JaxDataConfig(dataset="synthetic"))
    preds = _predictions(batch, layout)
    got, want = tmp_path / "port", tmp_path / "jax"
    colors = pv.ColorGenerators.for_dataset(ds)
    pv.visualize_predictions(preds, batch, str(got), ds, colors)
    pv.visualize_batches(batch, str(got), ds, colors)
    jv.setup_shared_color_generators(jds)
    jv.visualize_predictions(preds, batch, str(want), jds)
    jv.visualize_batches(batch, str(want), jds)
    names = _files(want)
    assert _files(got) == names
    folders = {n.split(os.sep)[0] for n in names}
    assert {"semantic", "semantic_score", "instance", "instance_center",
            "instance_offset", "panoptic", "orientation", "orientations",
            "orientations_white_bg", "scene", "gt_semantic", "gt_instance",
            "gt_instance_center", "gt_panoptic", "gt_orientations",
            "gt_orientations_white_bg", "gt_depth"} == folders
    for name in names:
        if name.endswith(".json"):
            assert json.loads((got / name).read_text()) == json.loads(
                (want / name).read_text()), name
            continue
        g = read_png(str(got / name))
        w = np.asarray(Image.open(want / name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
