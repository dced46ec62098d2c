"""The port's inference scripts (`emsanet_tpu_torch/inference_samples.py`,
`inference_dataset.py`, `inference_time.py`) and the trainer's
`--visualize-validation` against the JAX package's, on the CPU.

Both packages get the same flags (R18 encoders, 96x128, semantic +
instance + orientation + scene, panoptic, f32), the same weights (a
JAX package checkpoint of numpy-seeded variables, read by the port
through `weights.load_weights_file`), and the same files: two
Kinect-style sample pairs (96x128 and 120x170, depth in mm with values
above `--depth-max`) and a prepared dataset of the JAX package's writer
(`tools/prepare_dataset.py`, 3 test samples at 72x100). Outputs are
compared decoded, not as PNG bytes (the port's zlib stream is not
PIL's):
- id maps (the semantic, instance and panoptic files, and the panel's
  tiles drawn from them) exactly: no decision flips on these inputs, so
  no tie allowance is needed;
- the panel's tiles drawn from float maps (centres, offsets,
  orientations: `(x * 255).astype(uint8)` of f32 values) within one
  level, since a value within rounding of a level boundary may land on
  either side; the RGB and depth tiles exactly;
- the instance scores and the mapping values within 1e-5;
- `meta.json` key for key, its values but elapsed time, weights path
  and configuration equal.
"""

import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_port_model import _random_variables
from torch_inference_cases import TILE_NAMES, panel_tiles
from torch_tmp_files import remove_large_files

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import native as jax_native
from emsanet_tpu import visualization as jv
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu.training import create_train_state, get_optimizer
from emsanet_tpu.training.checkpoint import save_checkpoint as jax_save
from emsanet_tpu.utils.cli import args_to_config, build_parser
from emsanet_tpu_torch import import_torch_checkpoint
from emsanet_tpu_torch import inference_dataset, inference_samples
from emsanet_tpu_torch import inference_time
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch import visualization as pv
from emsanet_tpu_torch.datasets.png import write_png

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import inference_dataset as jax_dataset  # noqa: E402
import inference_samples as jax_samples  # noqa: E402
import prepare_dataset  # noqa: E402

H, W = 96, 128
TASKS = ("semantic", "instance", "orientation", "scene")
FLOAT_TILES = ("instance_center", "instance_offset", "orientation")
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def jax_native_path():
    """The JAX package's native path (the port always takes its copy)."""
    assert jax_native.get_lib() is not None


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{'argv': the shared flags, 'samples': sample dir, 'dataset':
    prepared dataset, 'ckpt': the JAX checkpoint}."""
    tmp = tmp_path_factory.mktemp("inference")
    dataset = str(tmp / "dataset")
    prepare_dataset.prepare_synthetic(dataset, 2, 3, 72, 100)
    argv = ["--device", "cpu", "--dataset", "nyuv2", "--dataset-path",
            dataset, "--tasks", *TASKS, "--enable-panoptic",
            "--rgb-encoder-backbone", "resnet18", "--depth-encoder-backbone",
            "resnet18", "--input-height", str(H), "--input-width", str(W),
            "--fused-inference", "--raw-depth", "--n-workers", "1"]
    cfg = args_to_config(build_parser().parse_args(argv))
    model = JaxEMSANet(cfg=cfg.model, dataset_config=jax_ds_config(cfg.data))
    shapes = jax.eval_shape(
        lambda k: init_model(model, k, batch_size=1, train=True),
        jax.random.PRNGKey(0))
    state = create_train_state(model, _random_variables(dict(shapes), 31),
                               get_optimizer(cfg.train))
    ckpt = str(tmp / "ckpt.msgpack")
    jax_save(ckpt, state, 0)
    samples = tmp / "samples"
    rng = np.random.RandomState(5)
    for name, (h, w) in (("kinect_a", (H, W)), ("kinect_b", (120, 170))):
        write_png(str(samples / f"{name}_rgb.png"),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        write_png(str(samples / f"{name}_depth.png"),
                  rng.randint(0, 12000, (h, w)).astype(np.uint16))
    yield {"argv": argv + ["--weights-filepath", ckpt],
           "samples": str(samples), "dataset": dataset, "ckpt": ckpt}
    remove_large_files(tmp)


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """The checkpoints a test's run directory holds go once it is done."""
    yield
    remove_large_files(tmp_path)


def test_prepare_raw_depth_clips_before_scaling():
    d = np.array([[0, 1000, 10000, 10001, 65535]], np.uint16)
    for args in ((10000, 8.0), (None, 1.0)):
        np.testing.assert_array_equal(
            inference_samples.prepare_raw_depth(d, *args),
            jax_samples.prepare_raw_depth(d, *args))


def test_sample_inference_matches_jax(files, tmp_path, capsys):
    flags = files["argv"] + ["--sample-path", files["samples"],
                             "--depth-max", "8000", "--depth-scale", "1.5"]
    assert jax_samples.main(flags + ["--output-path",
                                     str(tmp_path / "jax")]) == 0
    want_out = capsys.readouterr().out
    assert inference_samples.main(flags + ["--output-path",
                                           str(tmp_path / "port")]) == 0
    got_out = capsys.readouterr().out
    for name in ("kinect_a", "kinect_b"):
        got = panel_tiles(np.asarray(Image.open(
            tmp_path / "port" / f"result_{name}.png")), H, W)
        want = panel_tiles(np.asarray(Image.open(
            tmp_path / "jax" / f"result_{name}.png")), H, W)
        for tile in TILE_NAMES:
            diff = np.abs(got[tile].astype(int) - want[tile].astype(int))
            limit = 1 if tile in FLOAT_TILES else 0
            assert diff.max() <= limit, (name, tile, diff.max())
        assert (want["instance"] > 0).any() and (want["panoptic"] > 0).any()
        scene = [ln for ln in want_out.splitlines()
                 if ln.startswith(f"{name}: scene")]
        assert scene and scene[0] in got_out


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_dataset_inference_matches_jax(files, tmp_path):
    flags = files["argv"] + [
        "--batch-size", "2", "--head-decode-fusion", "auto",
        "--inference-output-format", "semantic", "instance", "panoptic",
        "mapping", "--inference-output-fullres"]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    assert jax_dataset.main(flags + ["--inference-output-path",
                                     str(jdir)]) == 0
    assert inference_dataset.main(flags + ["--inference-output-path",
                                           str(pdir)]) == 0
    names = _tree(jdir)
    assert _tree(pdir) == names
    assert sum(n.startswith(os.path.join("instance", "masks"))
               for n in names) >= 3
    for name in names:
        g, w = pdir / name, jdir / name
        if name.endswith(".png"):
            gi, wi = np.asarray(Image.open(g)), np.asarray(Image.open(w))
            assert gi.shape == wi.shape and gi.dtype == wi.dtype, name
            if name.startswith(("semantic", "panoptic")):
                assert gi.shape[:2] == (72, 100), name  # full resolution
            np.testing.assert_array_equal(gi, wi, err_msg=name)
        elif name.endswith(".txt"):
            gl, wl = (p.read_text().splitlines() for p in (g, w))
            assert len(gl) == len(wl), name
            for a, b in zip(gl, wl):
                assert a.split()[:2] == b.split()[:2], name
                assert abs(float(a.split()[2]) - float(b.split()[2])) \
                    <= SCORE_TOL, name
        elif name.endswith(".npz"):
            np.testing.assert_allclose(np.load(g)["packed"],
                                       np.load(w)["packed"], rtol=0,
                                       atol=SCORE_TOL, err_msg=name)
        else:
            assert name == "meta.json"
            gm, wm = (json.loads(p.read_text()) for p in (g, w))
            assert sorted(gm) == sorted(wm)
            skip = ("elapsed_s", "weights", "config")
            assert {k: v for k, v in gm.items() if k not in skip} == {
                k: v for k, v in wm.items() if k not in skip}
            assert gm["n_samples"] == 3


def test_dataset_inference_max_samples_and_split(files, tmp_path):
    out = tmp_path / "out"
    meta = inference_dataset.run(files["argv"] + [
        "--inference-split", "train", "--inference-max-samples", "1",
        "--inference-output-path", str(out)])
    assert meta["split"] == "train" and meta["n_samples"] == 1
    assert _tree(out) == ["meta.json", os.path.join("semantic",
                                                    "train__0000.png")]


def test_inference_time_rows(files, tmp_path, capsys):
    """Runs on the CPU (host clock) and writes its CSV; the head mode is
    `best_head_decode_fusion`'s."""
    csv_path = tmp_path / "t.csv"
    rows = inference_time.run(files["argv"] + [
        "--with-postprocessing", "--time-batch-size", "2", "--n-runs", "2",
        "--n-runs-warmup", "1", "--csv", str(csv_path), "--profile-dir",
        str(tmp_path / "prof")])
    (row,) = rows
    assert row["device"] == "cpu" and row["batch_size"] == 2
    assert row["head_decode_fusion"] == "decode-planes"
    assert row["fps_mean"] > 0 and np.isfinite(row["fps_std"])
    assert csv_path.read_text().splitlines()[0].startswith("device,")
    assert (tmp_path / "prof" / "trace_b2_float32.json").exists()
    assert inference_time.SWEEP == [(b, d) for d in ("bfloat16", "float32")
                                    for b in (1, 8, 32)]


@pytest.mark.parametrize("script", [inference_samples, inference_dataset,
                                    inference_time, import_torch_checkpoint])
def test_scripts_default_to_the_card(script, tmp_path):
    """Without --device the scripts ask for the card, and raise without
    one (this machine has none); the import raises before it reads the
    checkpoint."""
    if script is import_torch_checkpoint:
        argv = [str(tmp_path / "missing.pth"), str(tmp_path)]
        ns = script.build_parser().parse_args(argv)
        entry = script.main
    else:
        argv = (["--dataset", "synthetic", "--sample-path", "."]
                if script is inference_samples else ["--dataset", "synthetic"])
        ns = script.build_parser().parse_args([])
        entry = script.run
    assert ns.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(argv)


def _without_arrows(fn):
    return lambda *a, **kw: fn(*a, **{**kw, "draw_arrows": False})


def test_visualize_validation_writes_the_reference_files(tmp_path,
                                                         monkeypatch):
    """One validation with --visualize-validation: `epoch_0000` holds the
    files the reference's composition (`main.py:260-267`: its
    `visualize_predictions` and `visualize_batches` on the first
    batch's predictions) writes, decoded equal (the orientation overlays
    without arrows and text, whose rendering is the port's own)."""
    for mod in (pv, jv):
        monkeypatch.setattr(mod, "visualize_instance_orientations",
                            _without_arrows(
                                mod.visualize_instance_orientations))
    cfg, _, _ = trainer.parse_args([
        "--device", "cpu", "--dataset", "synthetic", "--tasks", *TASKS,
        "--enable-panoptic", "--rgb-encoder-backbone", "resnet18",
        "--depth-encoder-backbone", "resnet18", "--input-height", "64",
        "--input-width", "96", "--batch-size", "2",
        "--validation-batch-size", "2", "--synthetic-n-samples", "3",
        "--class-weighting", "none", "--n-workers", "1",
        "--fused-inference", "--visualize-validation",
        "--visualization-output-path",
        str(tmp_path / "port")])
    run = trainer.setup(cfg, "cpu")
    assert isinstance(run.colors, pv.ColorGenerators)
    first = []
    step = run.eval_step

    def spy(batch):
        out = step(batch)
        if not first:
            first.append(inference_samples.host(out))
        return out

    run.eval_step = spy
    trainer.run_validation(run, 0, None,
                           cfg.train.visualization_output_path)
    (loader,) = run.data.valid_loaders.values()
    batch = next(iter(loader.batches(0)))
    run.data.close()
    jds = jax_ds_config(JaxDataConfig(dataset="synthetic"))
    want_dir = tmp_path / "jax" / "epoch_0000"
    jv.setup_shared_color_generators(jds)
    jv.visualize_predictions(first[0], batch, str(want_dir), jds)
    jv.visualize_batches(batch, str(want_dir), jds)
    got_dir = tmp_path / "port" / "epoch_0000"
    names = _tree(want_dir)
    assert _tree(got_dir) == names
    assert {n.split(os.sep)[0] for n in names} == {
        "semantic", "semantic_score", "instance", "instance_center",
        "instance_offset", "panoptic", "orientation", "orientations",
        "orientations_white_bg", "scene", "gt_semantic", "gt_instance",
        "gt_instance_center", "gt_panoptic", "gt_orientations",
        "gt_orientations_white_bg", "gt_depth"}
    for name in names:
        if name.endswith(".json"):
            assert json.loads((got_dir / name).read_text()) == json.loads(
                (want_dir / name).read_text())
        else:
            np.testing.assert_array_equal(
                np.asarray(Image.open(got_dir / name)),
                np.asarray(Image.open(want_dir / name)), err_msg=name)


def test_visualize_validation_in_the_run_directory(tmp_path):
    """Without --visualization-output-path the trainer draws into the
    run directory's examples/, once per validation."""
    argv = ["--device", "cpu", "--dataset", "synthetic", "--tasks", *TASKS,
            "--enable-panoptic", "--rgb-encoder-backbone", "resnet18",
            "--depth-encoder-backbone", "resnet18", "--input-height", "64",
            "--input-width", "96", "--batch-size", "2",
            "--synthetic-n-samples", "2", "--class-weighting", "none",
            "--n-workers", "1", "--n-epochs", "2", "--fused-inference",
            "--skip-sanity-check",
            "--validation-force-interval", "1", "--visualize-validation",
            "--results-basepath", str(tmp_path)]
    assert trainer.main(argv) == 0
    (run_dir,) = (tmp_path / "synthetic").iterdir()
    assert sorted(os.listdir(run_dir / "examples")) == ["epoch_0000",
                                                        "epoch_0001"]
    assert os.listdir(run_dir / "examples" / "epoch_0001" / "gt_depth")
