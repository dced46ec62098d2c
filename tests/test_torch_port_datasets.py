"""The port's prepared datasets on disk, their metadata, loaders and
weight loading against the JAX package's, on the CPU, bit for bit.

Data: tiny prepared datasets written into a temporary directory by the
JAX package's offline writer (`tools/prepare_dataset.py::
prepare_synthetic`): a 64x96 one ('kv1', 6 train and 3 test samples)
whose test split also gets 3 samples of a 50x70 one ('kv2') and a
`cameras.json`; two scene files hold class names in place of indices.
A packed copy comes from `tools/pack_dataset.py`; a `labels_20` copy
of the labels serves an explicit 20-class request. Model: R18, 64x96,
semantic + instance + orientation + scene. Both packages run their
native host libraries. No data is downloaded.
"""

import dataclasses
import functools
import json
import math
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_tmp_files import remove_large_files

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu import data as jax_data
from emsanet_tpu import native as jax_native
from emsanet_tpu import weights as jax_weights
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.datasets import disk as jax_disk
from emsanet_tpu.datasets import metadata as jax_meta
from emsanet_tpu.datasets import registry as jax_registry
from emsanet_tpu.preprocessing import get_preprocessor as jax_preprocessor
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import data
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch import weights
from emsanet_tpu_torch.datasets import disk, metadata, pack, registry
from emsanet_tpu_torch.models.emsanet import build_train_model
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import pack_dataset  # noqa: E402
import prepare_dataset  # noqa: E402

H, W = 64, 96
TASKS = ("semantic", "instance", "orientation", "scene")
KEYS = ("identifier", "rgb", "depth", "semantic", "instance",
        "orientations", "scene")


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """The checkpoints a test writes go once it is done."""
    yield
    remove_large_files(tmp_path)



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def jax_native_path():
    """The JAX package's native library, loaded before any loader runs:
    its first load is not thread-safe (a second thread finds it 'tried'
    but not yet loaded and takes the numpy path for that sample)."""
    assert jax_native.get_lib() is not None, (
        "the JAX package's native library is not available")


def _copy_split(src, dst, split, rename):
    for mod in os.listdir(os.path.join(src, split)):
        d = os.path.join(src, split, mod)
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            stem, ext = os.path.splitext(f)
            os.makedirs(os.path.join(dst, split, mod), exist_ok=True)
            shutil.copy(os.path.join(d, f),
                        os.path.join(dst, split, mod, rename(stem) + ext))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{'png', 'packed', 'no_meta'}: the two-camera dataset, its packed
    copy and a copy without meta.json."""
    tmp = tmp_path_factory.mktemp("prepared")
    png, other = str(tmp / "png"), str(tmp / "other")
    prepare_dataset.prepare_synthetic(png, 6, 3, H, W)
    prepare_dataset.prepare_synthetic(other, 0, 3, 50, 70)
    _copy_split(other, png, "test", lambda s: "1" + s[1:])
    ids = sorted(os.path.splitext(f)[0]
                 for f in os.listdir(os.path.join(png, "test", "rgb")))
    with open(os.path.join(png, "test", "cameras.json"), "w") as fh:
        json.dump({i: "kv2" if i.startswith("1") else "kv1" for i in ids},
                  fh)
    for sid, name in (("0001", "dinette"), ("1002", "some garage")):
        with open(os.path.join(png, "test", "scene_class", f"{sid}.txt"),
                  "w") as fh:
            fh.write(name)
    for split in ("train", "test"):  # for an explicit 20-class request
        shutil.copytree(os.path.join(png, split, "semantic_40"),
                        os.path.join(png, split, "labels_20"))
    packed = str(tmp / "packed")
    shutil.copytree(png, packed)
    for split in ("train", "test"):
        pack_dataset.pack_split(packed, split)
    no_meta = str(tmp / "no_meta")
    shutil.copytree(png, no_meta, ignore=shutil.ignore_patterns("meta.json"))
    return {"png": png, "packed": packed, "no_meta": no_meta}


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


def _same_config(got, want):
    """A port DatasetConfig against a JAX one, field for field."""
    sem, scene = want.semantic_label_list, want.scene_label_list
    assert got.semantic_class_names == sem.class_names
    assert got.classes_is_thing == sem.classes_is_thing
    assert got.classes_use_orientations == sem.classes_use_orientations
    assert got.semantic_colors == tuple(tuple(c) for c in sem.colors)
    assert got.scene_class_names == scene.class_names
    assert got.scene_colors == tuple(tuple(c) for c in scene.colors)
    assert dataclasses.asdict(got.depth_stats) == dataclasses.asdict(
        want.depth_stats)


# ---------------------------------------------------------------------------
# samples and metadata

SAMPLE_CASES = {
    "png": ("png", "nyuv2", {}),
    "packed": ("packed", "nyuv2", {}),
    "camera kv2": ("png", "nyuv2", dict(cameras=("kv2",))),
    "camera kv1, packed": ("packed", "nyuv2", dict(cameras=("kv1",))),
    "subsample": ("png", "nyuv2", dict(subsample=2)),
    "original scenes": ("png", "nyuv2",
                        dict(scene_use_indoor_domestic_labels=False)),
    "no meta.json": ("no_meta", "nyuv2", {}),
    "no meta.json, nyuv2 scenes": (
        "no_meta", "nyuv2", dict(scene_use_indoor_domestic_labels=False)),
    "meta.json, other class count": ("png", "scannet",
                                     dict(semantic_n_classes=20)),
}


@pytest.mark.parametrize("case, split", [
    (case, split) for case in SAMPLE_CASES for split in ("train", "test")
    if split == "test" or "cameras" not in SAMPLE_CASES[case][2]])
def test_prepared_samples_match_jax(roots, case, split):
    root, name, kwargs = SAMPLE_CASES[case]
    kwargs = {"scene_use_indoor_domestic_labels": True, **kwargs}
    got = disk.PreparedDataset(roots[root], name, split, KEYS, **kwargs)
    want = jax_disk.PreparedDataset(roots[root], name, split, KEYS, **kwargs)
    _same_config(got.config, want.config)
    assert got.cameras == want.cameras and len(got) == len(want) > 0
    for i in range(len(want)):
        _same(got.load_raw(i), want.load_raw(i))
    if split == "test" and case == "png":
        assert got.cameras == ("kv1", "kv2")
        scenes = [got.load_raw(i)["scene"] for i in range(len(got))]
        assert got.config.scene_class_names[scenes[1]] == "dining room"
        assert got.config.scene_class_names[scenes[-1]] == "other indoor"


@pytest.mark.parametrize("root", ["png", "packed"])
def test_filter_camera_matches_jax(roots, root):
    for cam in ("kv1", "kv2"):
        got = disk.PreparedDataset(roots[root], "nyuv2", "test",
                                   KEYS).filter_camera(cam)
        want = jax_disk.PreparedDataset(roots[root], "nyuv2", "test",
                                        KEYS).filter_camera(cam)
        assert len(got) == len(want) == 3
        for i in range(3):
            _same(got.load_raw(i), want.load_raw(i))


def test_port_pack_matches_tools_pack(roots, tmp_path):
    dst = str(tmp_path / "repacked")
    shutil.copytree(roots["png"], dst)
    for split in ("train", "test"):
        assert pack.pack_split(dst, split)
        a = os.path.join(dst, split, "packed")
        b = os.path.join(roots["packed"], split, "packed")
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for f in os.listdir(a):
            with open(os.path.join(a, f), "rb") as fa, \
                    open(os.path.join(b, f), "rb") as fb:
                assert fa.read() == fb.read(), f


@pytest.mark.parametrize("name", jax_registry.KNOWN_DATASETS)
@pytest.mark.parametrize("domestic", [False, True])
def test_metadata_tables_match_jax(name, domestic):
    for n in ((None, 20, 40, 549) if name == "scannet" else (None,)):
        _same_config(metadata.get_dataset_config(name, n, domestic),
                     jax_meta.get_metadata_config(name, n, domestic))
    assert metadata.map_scene_to_indoor_domestic("Study_Room") == (
        jax_meta.map_scene_to_indoor_domestic("Study_Room"))


def test_meta_json_round_trip_matches_jax(roots, tmp_path):
    for name in ("nyuv2", "sunrgbd", "cityscapes"):
        got = metadata.dataset_config_to_meta(
            metadata.get_dataset_config(name))
        assert got == jax_meta.dataset_config_to_meta(
            jax_meta.get_metadata_config(name))
        _same_config(metadata.dataset_config_from_meta(got),
                     jax_meta.dataset_config_from_meta(got))
    with open(os.path.join(roots["png"], "meta.json")) as fh:
        meta = json.load(fh)
    meta["depth_stats_raw"] = dict(meta["depth_stats"], mean=1.5)
    (tmp_path / "test").mkdir()
    (tmp_path / "test" / "meta.json").write_text(json.dumps(meta))
    for split, mode in (("test", "raw"), (None, "refined"), ("x", "raw")):
        got = metadata.load_meta_config(str(tmp_path), split, mode)
        want = jax_meta.load_meta_config(str(tmp_path), split, mode)
        assert (got is None) == (want is None)
        if want is not None:
            _same_config(got, want)


def _data_cfgs(**d):
    return pc.DataConfig(**d), JaxDataConfig(**d)


@pytest.mark.parametrize("case", [
    dict(dataset="nyuv2"),
    dict(dataset="nyuv2", use_original_scene_labels=True),
    dict(dataset="scannet", scannet_semantic_n_classes=20),
    dict(dataset="scannet"),
    dict(dataset="sunrgbd[kv1]:nyuv2", raw_depth=True),
])
def test_dataset_config_matches_jax(roots, case):
    for path in (roots["png"], roots["no_meta"]):
        port, ref = _data_cfgs(dataset_path=path, **case)
        pc.EMSANetConfig(data=port).validate()
        JaxEMSANetConfig(data=ref).validate()
        _same_config(registry.get_dataset_config(port),
                     jax_registry.get_dataset_config(ref))


def test_parse_datasets_matches_jax():
    spec = "sunrgbd[kv1, kv2]:nyuv2:scannet[]"
    assert registry.parse_datasets(spec) == jax_registry.parse_datasets(spec)
    for bad in ("nyu", "sunrgbd[kv1"):
        with pytest.raises(ValueError):
            registry.parse_datasets(bad)


# ---------------------------------------------------------------------------
# loaders


def _cfgs(roots, dataset="nyuv2", path="png", batch_size=2, train=None,
          **d):
    model = dict(tasks=TASKS, enable_panoptic=True, input_height=H,
                 input_width=W, rgb_encoder_backbone="resnet18",
                 depth_encoder_backbone="resnet18")
    paths = ":".join(roots[p] for p in path.split(":"))
    d = dict(dataset=dataset, dataset_path=paths, batch_size=batch_size,
             validation_batch_size=batch_size, n_workers=2, **d)
    port_d = dict(d)
    if port_d.get("worker_mode") == "process":  # the JAX side: threads
        d["worker_mode"] = "thread"
    port = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(**model), data=pc.DataConfig(**port_d),
        train=pc.TrainConfig(**(train or {}))))
    ref = JaxEMSANetConfig(model=JaxModelConfig(**model),
                           data=JaxDataConfig(**d),
                           train=JaxTrainConfig(**(train or {}))).validate()
    return port, ref


LOADER_CASES = {
    "two cameras": {},
    "two cameras, process workers": dict(worker_mode="process"),
    "full resolution": dict(validation_full_resolution=True),
    "full resolution, packed": dict(validation_full_resolution=True,
                                    path="packed"),
    "validation input size": dict(validation_input_height=32,
                                  validation_input_width=48),
    "concatenated, fractions": dict(dataset="nyuv2:nyuv2",
                                    path="png:packed",
                                    subset_train=(0.5, 1.0),
                                    validation_split="train"),
    "subset, deterministic": dict(subset_train=0.5,
                                  subset_deterministic=True),
    "scannet benchmark mode": dict(dataset="scannet",
                                   validation_scannet_benchmark_mode=True,
                                   scannet_subsample=1,
                                   validation_scannet_subsample=50),
    "sunrgbd combined": dict(dataset="sunrgbd:nyuv2", path="png:packed",
                             validation_split="train"),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_datahelper_batches_match_jax(roots, case):
    """The train batches of two epochs (native preprocessing, multiscale
    targets) and every camera's validation batches, bit for bit. (The
    concatenated cases validate on the train splits: a concatenation's
    camera filter keeps every sample, in both packages, so its test
    splits' two sizes would meet in one batch.)"""
    kwargs = dict(LOADER_CASES[case])
    if case.startswith("scannet"):
        kwargs["validation_split"] = "test"
    port, ref = _cfgs(roots, **kwargs)
    helper, jhelper = data.get_datahelper(port), jax_data.get_datahelper(ref)
    ds_port = registry.get_dataset_config(port.data)
    ds_ref = jax_registry.get_dataset_config(ref.data)
    combined = case == "sunrgbd combined"
    helper.set_train_preprocessor(get_preprocessor(
        port, ds_port, "train",
        multiscale_downscales=port.model.side_output_downscales,
        sunrgbd_combined=combined))
    jhelper.set_train_preprocessor(jax_preprocessor(
        ref, ds_ref, "train",
        multiscale_downscales=ref.model.side_output_downscales,
        sunrgbd_combined=combined))
    helper.set_valid_preprocessor(get_preprocessor(
        port, ds_port, "test", sunrgbd_combined=combined))
    jhelper.set_valid_preprocessor(jax_preprocessor(
        ref, ds_ref, "test", sunrgbd_combined=combined))
    assert len(helper.train_loader) == len(jhelper.train_loader) > 0
    assert helper.train_loader.worker_mode == port.data.worker_mode
    for epoch in (0, 1):
        _same(list(helper.train_loader.batches(epoch)),
              list(jhelper.train_loader.batches(epoch)))
    assert list(helper.valid_loaders) == list(jhelper.valid_loaders)
    for cam, loader in helper.valid_loaders.items():
        got = list(loader.batches(0))
        _same(got, list(jhelper.valid_loaders[cam].batches(0)))
        if port.data.validation_full_resolution:
            assert got[0]["rgb"].shape[1:3] == (H, W)  # 50x70 padded
            assert {tuple(b["_prepad_hw"][0]) for b in got} <= {(H, W),
                                                               (50, 70)}
    if case.startswith("two cameras"):
        assert list(helper.valid_loaders) == ["kv1", "kv2"]


def test_class_weights_from_disk_match_jax(roots):
    port, ref = _cfgs(roots, dataset="nyuv2:nyuv2", path="png:no_meta")
    got = registry.get_dataset(port.data, port.model, "train")
    want = jax_registry.get_dataset(ref.data, ref.model, "train")
    for mode in ("median-frequency", "logarithmic", "linear", "none"):
        np.testing.assert_array_equal(
            got.semantic_compute_class_weights(mode),
            want.semantic_compute_class_weights(mode))


def test_jpeg_rgb_is_refused(roots, tmp_path):
    """A baseline JPEG rgb file loads as the JAX package's loader (PIL)
    loads it; a progressive one is refused, naming the file."""
    from PIL import Image

    from emsanet_tpu_torch.config import NotPortedError

    root = str(tmp_path / "jpg")
    shutil.copytree(roots["no_meta"], root)
    rgb = os.path.join(root, "test", "rgb")
    Image.open(os.path.join(rgb, "0000.png")).save(
        os.path.join(rgb, "0000.jpg"))
    os.unlink(os.path.join(rgb, "0000.png"))
    Image.open(os.path.join(rgb, "0001.png")).save(
        os.path.join(rgb, "0001.jpg"), progressive=True)
    os.unlink(os.path.join(rgb, "0001.png"))
    ds = disk.PreparedDataset(root, "nyuv2", "test", KEYS)
    want = jax_disk.PreparedDataset(root, "nyuv2", "test", KEYS)
    _same(ds.load_raw(0), want.load_raw(0))
    with pytest.raises(NotPortedError, match="progressive.*0001.jpg"):
        ds.load_raw(1)


def test_trainer_on_disk_two_cameras_full_resolution(roots, tmp_path,
                                                     capsys):
    argv = ["--device", "cpu", "--dataset", "nyuv2", "--dataset-path",
            roots["packed"], "--tasks", *TASKS, "--enable-panoptic",
            "--rgb-encoder-backbone", "resnet18", "--depth-encoder-backbone",
            "resnet18", "--input-height", str(H), "--input-width", str(W),
            "--batch-size", "2", "--validation-batch-size", "2",
            "--n-epochs", "2", "--fused-training", "--fused-inference",
            "--n-workers", "2",
            "--validation-full-resolution", "--skip-sanity-check",
            "--results-basepath", str(tmp_path / "runs")]
    assert trainer.main(argv) == 0
    (run_dir,) = (tmp_path / "runs" / "nyuv2").iterdir()
    assert (run_dir / "finished").exists()
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["epoch"] == 1
    metrics = {k: v for k, v in last.items() if k.startswith(("valid_",
                                                              "train_"))}
    assert "valid_panoptic_all_with_gt_deeplab_pq" in metrics
    assert all(math.isfinite(v) for v in metrics.values()), metrics


# ---------------------------------------------------------------------------
# weights


def _model(dataset="nyuv2", n_classes=None, tasks=TASKS, block="basicblock"):
    cfg = pc.validate_for_port(pc.ModelConfig(
        tasks=tasks, enable_panoptic="instance" in tasks, input_height=H,
        input_width=W, rgb_encoder_backbone="resnet18",
        depth_encoder_backbone="resnet18",
        rgb_encoder_backbone_block=block,
        depth_encoder_backbone_block=block))
    ds = metadata.get_dataset_config(dataset, n_classes, dataset != "nyuv2")
    model = build_train_model(cfg, ds, device="cpu", seed=0)
    g = torch.Generator().manual_seed(len(ds.semantic_class_names))
    with torch.no_grad():  # every tensor random, so any copy shows
        for v in model.state_dict().values():
            v.copy_(torch.randn(v.shape, generator=g))
    return model


@functools.lru_cache(maxsize=None)
def _state(dataset="nyuv2", n_classes=None, tasks=TASKS):
    """A random model's state dict (read only: merging copies)."""
    return _model(dataset, n_classes, tasks).state_dict()


def _to_flax(state_dict):
    """A port state dict as the JAX package's flat (params, batch_stats)
    dicts of path tuples (the inverse of `weights.flax_to_state_dict`)."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        a = t.numpy()
        if leaf in ("running_mean", "running_var"):
            stats[tuple(path) + (leaf[len("running_"):],)] = a
        elif leaf == "weight" and a.ndim == 4:
            params[tuple(path) + ("kernel",)] = a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 2:
            params[tuple(path) + ("kernel",)] = a.T
        else:
            params[tuple(path) + ("scale" if leaf == "weight"
                                  else leaf,)] = a
    return params, stats


def _from_flax(params, stats):
    return weights.flax_to_state_dict({
        "params": jax_weights._unflatten(params),
        "batch_stats": jax_weights._unflatten(stats)})


def _same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


@pytest.mark.parametrize("source, target", [
    (dict(dataset="sunrgbd"), dict(dataset="nyuv2")),
    (dict(dataset="nyuv2"), dict(dataset="sunrgbd")),
    (dict(dataset="scannet", n_classes=40), dict(dataset="scannet",
                                                  n_classes=20)),
    (dict(dataset="nyuv2"), dict(dataset="nyuv2",
                                 tasks=("semantic", "instance", "scene"))),
    (dict(dataset="nyuv2", tasks=("semantic", "scene")),
     dict(dataset="nyuv2")),
])
def test_merge_loaded_params_matches_jax(source, target):
    """The transfer rules (37 <-> 40 classes, ScanNet 40 -> 20, the scene
    head of another class count, the orientation channels of the
    instance head, missing and extra keys) on the port's state dicts,
    against the JAX package's on the same tensors in flax layout."""
    loaded, own = _state(**source), _state(**target)
    got = weights.merge_loaded_params(loaded, own, verbose=False)
    (lp, ls), (tp, ts) = _to_flax(loaded), _to_flax(own)
    assert _from_flax(tp, ts).keys() == own.keys()
    want = _from_flax(jax_weights.merge_loaded_params(lp, tp, verbose=False),
                      jax_weights.merge_loaded_params(ls, ts, verbose=False))
    _same_state(got, want)


@dataclasses.dataclass
class _State:
    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _torchvision_resnet18(path):
    """A random torchvision-named ResNet-18 state dict, saved to `path`."""
    g = torch.Generator().manual_seed(7)
    sd = {"conv1.weight": torch.randn(64, 3, 7, 7, generator=g)}

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.{leaf}"] = torch.rand(c, generator=g) + 0.5
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    bn("bn1", 64)
    cin = 64
    for li, c in enumerate((64, 128, 256, 512)):
        for b in range(2):
            t = f"layer{li + 1}.{b}"
            sd[f"{t}.conv1.weight"] = torch.randn(c, cin if b == 0 else c,
                                                  3, 3, generator=g)
            bn(f"{t}.bn1", c)
            sd[f"{t}.conv2.weight"] = torch.randn(c, c, 3, 3, generator=g)
            bn(f"{t}.bn2", c)
            if b == 0 and li > 0:
                sd[f"{t}.downsample.0.weight"] = torch.randn(
                    c, cin, 1, 1, generator=g)
                bn(f"{t}.downsample.1", c)
        cin = c
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    torch.save({"state_dict": sd}, path)


@pytest.mark.parametrize("block", ["basicblock", "nonbottleneck1d"])
def test_load_backbone_pretrained_matches_jax(tmp_path, block):
    path = str(tmp_path / "resnet18.pth")
    _torchvision_resnet18(path)
    model = _model(block=block)
    state = _State(*_to_flax(model.state_dict()))
    state = _State(jax_weights._unflatten(state.params),
                   jax_weights._unflatten(state.batch_stats))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for mod in ("rgb", "depth"):
        weights.load_backbone_pretrained(model, path, mod, "resnet18",
                                         verbose=False)
        state = jax_weights.load_backbone_pretrained(state, path, mod,
                                                     "resnet18",
                                                     verbose=False)
    got = model.state_dict()
    _same_state(got, weights.flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}))
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    assert "encoder.depth_stem.Conv_0.weight" in changed
    # an NBt1D block's 3x1 / 1x3 convs take no 3x3 weights, its norms do
    assert ("encoder.rgb_stage0.block1.Conv_0.weight" in changed) == (
        block == "basicblock")
    assert "encoder.rgb_stage0.block1.Norm_0.BatchNorm_0.weight" in changed


def test_trainer_takes_pretrained_backbone_and_merged_weights(tmp_path):
    """`--encoder-backbone-pretrained-weights-filepath` fills both
    backbones; `--weights-filepath` of a 37-class checkpoint loads
    through the transfer rules."""
    from emsanet_tpu_torch.training.checkpoint import save_checkpoint

    path = str(tmp_path / "resnet18.pth")
    _torchvision_resnet18(path)
    cfg, _, _ = trainer.parse_args([
        "--device", "cpu", "--dataset", "synthetic", "--tasks", *TASKS,
        "--enable-panoptic", "--rgb-encoder-backbone", "resnet18",
        "--depth-encoder-backbone", "resnet18", "--input-height", str(H),
        "--input-width", str(W), "--synthetic-n-samples", "2",
        "--batch-size", "2", "--class-weighting", "none",
        "--encoder-backbone-pretrained-weights-filepath", path])
    assert cfg.model.depth_encoder_backbone_pretrained_weights_filepath == \
        path
    run = trainer.setup(cfg, "cpu")
    sd = torch.load(path, weights_only=True)["state_dict"]
    own = run.model.state_dict()
    assert torch.equal(own["encoder.rgb_stem.Conv_0.weight"],
                       sd["conv1.weight"])
    assert torch.equal(own["encoder.depth_stem.Conv_0.weight"],
                       sd["conv1.weight"].sum(1, keepdim=True))
    source = _model(dataset="sunrgbd", block="nonbottleneck1d")
    ckpt = str(tmp_path / "sunrgbd.pt")
    save_checkpoint(ckpt, source, None, 0)
    weights.load_weights_file(ckpt, run.model, verbose=False)
    got, src = run.model.state_dict(), source.state_dict()
    head = "semantic_decoder.head_conv.weight"
    assert got[head].shape[0] == 40 and torch.equal(got[head][:37],
                                                    src[head])


def test_process_workers_hold_no_torch_and_keep_across_epochs(roots):
    """A worker process imports neither torch nor JAX nor the JAX package
    (its forkserver preloads the numpy-only loader module), and a loader
    keeps its workers while the preprocessor stays the same."""
    port, _ = _cfgs(roots, worker_mode="process")
    helper = data.get_datahelper(port)
    ds_config = registry.get_dataset_config(port.data)
    helper.set_train_preprocessor(get_preprocessor(port, ds_config,
                                                   "train"))
    loader = helper.train_loader
    first = list(loader.batches(0))
    pool = loader._processes
    probe = "sorted(__import__('sys').modules.keys() & {'torch', 'jax'})"
    assert pool.submit(eval, probe).result() == []
    _same(list(loader.batches(0)), first)
    assert loader._processes is pool
    helper.set_train_preprocessor(get_preprocessor(port, ds_config,
                                                   "train"))
    _same(list(loader.batches(0)), first)
    assert loader._processes is not pool
    helper.close()
    assert loader._processes is None
