"""The port's host library (`emsanet_tpu_torch/native.py`) against the
JAX package's library and against the port's plain (numpy) versions, and
the plain versions against the JAX package's numpy path, on the CPU.

The two libraries are one source built with the same flags: equal bit
for bit. Library against plain, `tests/test_native.py`'s tolerances:
label maps equal, floats within 1e-5, HSV-jittered and resized uint8
within 1 LSB. Plain against the JAX numpy path (its native library
switched off): equal bit for bit, function by function and through the
whole train and test preprocessing. Inputs: seeded numpy, small maps.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu import native as jax_native
from emsanet_tpu.datasets.registry import get_dataset as jax_get_dataset
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.preprocessing import get_preprocessor as jax_preprocessor
from emsanet_tpu.preprocessing import transforms as jax_transforms
from emsanet_tpu_torch import config as pc
from emsanet_tpu_torch import native
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.registry import get_dataset
from emsanet_tpu_torch.preprocessing import transforms
from torch_jax_native import jax_native_lib
from torch_port_plain import plain_host_library

# the JAX package's library in this worker before its first test (a cold
# checkout's workers race to build it: tests/torch_jax_native.py)
jax_native_lib()

ROOT = Path(__file__).resolve().parent.parent
MEAN, STD = transforms.RGB_MEAN, transforms.RGB_STD


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package with its native library switched off."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)


def _labels(rng, shape=(37, 53)):
    is_thing = np.zeros(8, bool)
    is_thing[3:] = True
    semantic = rng.randint(0, 8, shape).astype(np.int32)
    instance = np.zeros(shape, np.int32)
    for iid, (y, x) in enumerate(((5, 10), (20, 30), (2, 40)), 1):
        instance[y:y + 12, x:x + 11] = iid
        semantic[y:y + 12, x:x + 11] = 3 + iid
    return semantic, instance, is_thing


CASES = ["instance_targets", "instance_targets_absolute",
         "resize_nearest_i32", "resize_bilinear_f32", "resize_bilinear_f32_2d",
         "resize_bilinear_u8", "resize_bilinear_u8_2d", "normalize_rgb",
         "hsv_jitter"]


def _call(lib, case, seed):
    """(outputs of `lib`'s function for the case, their plain versions)."""
    rng = np.random.RandomState(seed)
    if case.startswith("instance_targets"):
        sem, inst, thing = _labels(rng)
        args = (sem, inst, thing, 4.0, case == "instance_targets")
        return (lib.instance_targets(*args),
                transforms._instance_targets_plain(*args))
    if case == "resize_nearest_i32":
        src = rng.randint(-5, 1000, (37, 53)).astype(np.int32)
        return (lib.resize_nearest_i32(src, 61, 24),
                transforms._resize_nearest_plain(src, 61, 24))
    if case.startswith("resize_bilinear_f32"):
        src = rng.rand(33, 47, 3).astype(np.float32)
        src = src[..., 0] if case.endswith("2d") else src
        return (lib.resize_bilinear_f32(src, 20, 71),
                transforms._resize_bilinear_plain(src, 20, 71))
    if case.startswith("resize_bilinear_u8"):
        src = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        src = src[..., 0] if case.endswith("2d") else src
        return (lib.resize_bilinear_u8(src, 67, 90), np.round(
            transforms._resize_bilinear_plain(src, 67, 90)).astype(np.uint8))
    if case == "normalize_rgb":
        rgb = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
        return (lib.normalize_rgb(rgb, MEAN, STD),
                transforms._normalize_rgb_plain(rgb))
    rgb = rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)
    rgb[:4] = rgb[:4, :, :1]  # gray rows: zero saturation, hue 0
    jitter = (0.05, -0.07, 0.12)
    return (lib.hsv_jitter(rgb, *jitter),
            transforms._hsv_jitter_plain(rgb, *jitter))


def _items(out):
    return sorted(out.items()) if isinstance(out, dict) else [("", out)]


@pytest.mark.parametrize("case", CASES)
def test_host_library_equals_jax_library(case):
    assert jax_native.get_lib() is not None
    for seed in (0, 1):
        got, _ = _call(native, case, seed)
        want, _ = _call(jax_native, case, seed)
        for (k, g), (_, w) in zip(_items(got), _items(want)):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("case", CASES)
def test_host_library_within_tolerance_of_plain(case):
    for seed in (0, 1):
        got, want = _call(native, case, seed)
        for (k, g), (_, w) in zip(_items(got), _items(want)):
            assert g.shape == w.shape, k
            if g.dtype == np.uint8 and case.startswith(("hsv", "resize")):
                diff = np.abs(g.astype(int) - w.astype(int))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, k
            elif g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w.astype(g.dtype), k)


def test_plain_resizes_equal_jax_numpy(jax_numpy_path):
    rng = np.random.RandomState(2)
    maps = {"semantic": rng.randint(0, 41, (37, 53)).astype(np.int32),
            "depth": rng.rand(37, 53).astype(np.float32) * 5000,
            "rgb": rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),
            "normal": rng.rand(37, 53, 3).astype(np.float32)}
    for key, src in maps.items():
        for h, w in ((20, 71), (37, 53), (74, 106)):
            got = transforms._resize_sample_key_plain(key, src, h, w)
            want = jax_transforms._resize_sample_key(key, src, h, w)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        np.testing.assert_array_equal(
            transforms._resize_bilinear_plain(src, 20, 71),
            jax_transforms._resize_bilinear(src, 20, 71))
    np.testing.assert_array_equal(
        transforms._resize_nearest_plain(maps["semantic"], 61, 24),
        jax_transforms._resize_nearest(maps["semantic"], 61, 24))


def test_plain_transforms_equal_jax_numpy(jax_numpy_path):
    rng = np.random.RandomState(3)
    sem, inst, thing = _labels(rng)
    for normalized in (True, False):
        got = transforms._instance_targets_plain(sem, inst, thing, 4.0,
                                                 normalized)
        want = jax_transforms._instance_targets(sem, inst, thing, 4.0,
                                                normalized)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    rgb = rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)
    for seed in range(3):
        draw = np.random.default_rng(seed)
        jitter = [draw.uniform(-a, a) for a in (10 / 180, 20 / 255, 50 / 255)]
        want = jax_transforms.RandomHSVJitter()(
            {"rgb": rgb.copy(), "_rng": np.random.default_rng(seed)})["rgb"]
        np.testing.assert_array_equal(
            transforms._hsv_jitter_plain(rgb, *jitter), want)
    np.testing.assert_array_equal(
        transforms._normalize_rgb_plain(rgb),
        jax_transforms.NormalizeRGB()({"rgb": rgb})["rgb"])


@pytest.mark.parametrize("phase", ["train", "test"])
def test_plain_preprocessing_equals_jax_numpy(phase, jax_numpy_path):
    """The whole preprocessing of a phase on the plain versions against
    the JAX package's numpy path (48x64 synthetic samples, multiscale
    targets in training)."""
    model = dict(tasks=("semantic", "instance", "orientation", "scene"),
                 enable_panoptic=True, input_height=48, input_width=64)
    d = dict(dataset="synthetic", synthetic_n_samples=3)
    port = pc.validate_train_for_port(pc.EMSANetConfig(
        model=pc.ModelConfig(**model), data=pc.DataConfig(**d)))
    ref = JaxEMSANetConfig(model=JaxModelConfig(**model),
                           data=JaxDataConfig(**d)).validate()
    scales = port.model.side_output_downscales if phase == "train" else None
    pre = transforms.get_preprocessor(port, get_dataset_config("synthetic"),
                                      phase, multiscale_downscales=scales)
    jpre = jax_preprocessor(ref, jax_ds_config(ref.data), phase,
                            multiscale_downscales=scales)
    ds = get_dataset(port.data, port.model, "train")
    jds = jax_get_dataset(ref.data, ref.model, "train")
    with plain_host_library():
        for i in range(3):
            got = pre({**ds.load_raw(i), "_rng": np.random.default_rng(i)})
            want = jpre({**jds.load_raw(i),
                         "_rng": np.random.default_rng(i)})
            _same(got, want)


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert got == want, path


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f() { return undefined_name; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="undefined_name"):
        native.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_port_loads_its_own_library():
    """A process that preprocesses through the port maps the port's
    library from `build/host/` and not the JAX package's
    `native/libemsanet_native.so`."""
    code = ("import numpy as np\n"
            "from emsanet_tpu_torch.preprocessing import transforms\n"
            "transforms._resize_nearest(np.zeros((4, 4), np.int32), 2, 2)\n"
            "print(open('/proc/self/maps').read())\n")
    maps = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                          capture_output=True, text=True).stdout
    assert str(native.library_path()) in maps
    assert native.library_path().parent == ROOT / "build" / "host"
    assert str(ROOT / "native" / "libemsanet_native.so") not in maps
