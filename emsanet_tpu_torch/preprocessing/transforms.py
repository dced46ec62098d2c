"""Host-side preprocessing of the train and test phases.

A copy of the transforms of `emsanet_tpu/preprocessing/transforms.py`
that `get_preprocessor(..., phase="train" or "test")` composes, in the
order of `emsanet/preprocessing.py`: [clone raw inputs] -> [ScanNet
benchmark classes to void] -> [SUNRGB-D combined: its last 3 classes to
void] -> clear stuff instance ids -> train: random resize -> random crop
-> HSV jitter -> horizontal flip | test: panoptic target -> full-
resolution copies -> resize to the validation input size (not with
`validation_full_resolution`) -> multiscale sub-samples -> instance
targets -> orientation targets -> normalize -> canonicalize -> [full
resolution: pad to a multiple of 32, the pre-pad size in `_prepad_hw`].

The resizes, the HSV jitter, the instance targets and the RGB
normalization run in the port's host library (`native.py`) where the
JAX package runs its own, on the same inputs, so the batches equal the
JAX package's bit for bit; the numpy bodies beside them
(`_resize_nearest_plain`, ...) are the plain versions the tests hold the
library against. The depth normalization is numpy, as in the JAX
package.

Per-sample randomness comes from `sample['_rng']`, a
`np.random.Generator` the loader seeds per (epoch, index).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from emsanet_tpu_torch import native
from emsanet_tpu_torch.datasets import scannet as scannet_meta
from emsanet_tpu_torch.metrics import deeplab_merge_numpy

APPLIED_PREPROCESSING_KEY = "_applied_preprocessing"
DEFAULT_CLONE_KEY = "_no_preprocessing"

# ImageNet statistics (reference NormalizeRGB)
RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)

_GEOMETRY_KEYS = (
    "rgb", "depth", "semantic", "instance", "normal", "panoptic",
)
_NEAREST_KEYS = {"semantic", "instance", "panoptic", "depth"}


def _rng_of(sample: dict) -> np.random.Generator:
    rng = sample.get("_rng")
    if rng is None:
        rng = np.random.default_rng()
        sample["_rng"] = rng
    return rng


def _resize_nearest_plain(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    ys = np.minimum((np.arange(h) + 0.5) * ih / h, ih - 1).astype(np.int64)
    xs = np.minimum((np.arange(w) + 0.5) * iw / w, iw - 1).astype(np.int64)
    return img[ys][:, xs]


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.ndim == 2 and img.dtype in (np.int32, np.int64, np.uint8,
                                       np.uint16):
        return native.resize_nearest_i32(img.astype(np.int32), h,
                                         w).astype(img.dtype)
    return _resize_nearest_plain(img, h, w)


def _resize_bilinear_plain(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    ys = np.clip((np.arange(h) + 0.5) * ih / h - 0.5, 0, ih - 1)
    xs = np.clip((np.arange(w) + 0.5) * iw / w - 0.5, 0, iw - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    img_f = img.astype(np.float32)
    if img_f.ndim == 2:
        img_f = img_f[..., None]
    wy_ = wy[..., None]
    wx_ = wx[..., None]
    out = (
        img_f[y0][:, x0] * (1 - wy_) * (1 - wx_)
        + img_f[y0][:, x1] * (1 - wy_) * wx_
        + img_f[y1][:, x0] * wy_ * (1 - wx_)
        + img_f[y1][:, x1] * wy_ * wx_
    )
    if img.ndim == 2:
        out = out[..., 0]
    return out


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[:2] == (h, w):
        return img
    if img.dtype in (np.float32, np.uint8) and img.ndim <= 3:
        return native.resize_bilinear_f32(img.astype(np.float32), h, w)
    return _resize_bilinear_plain(img, h, w)


def _resize_sample_key_plain(key: str, value: np.ndarray, h: int, w: int):
    """The numpy path of `_resize_sample_key`."""
    if key in _NEAREST_KEYS:
        return _resize_nearest_plain(value, h, w)
    if value.dtype == np.uint8 and value.ndim <= 3 and (
            value.shape[:2] == (h, w)):
        return value
    out = _resize_bilinear_plain(value, h, w)
    if np.issubdtype(value.dtype, np.integer):
        return np.round(out).astype(value.dtype)
    return out.astype(value.dtype)


def _resize_sample_key(key: str, value: np.ndarray, h: int, w: int):
    if key in _NEAREST_KEYS:
        return _resize_nearest(value, h, w)
    if value.dtype == np.uint8 and value.ndim <= 3:
        if value.shape[:2] == (h, w):
            return value
        return native.resize_bilinear_u8(value, h, w)
    out = _resize_bilinear(value, h, w)
    if np.issubdtype(value.dtype, np.integer):
        return np.round(out).astype(value.dtype)
    return out.astype(value.dtype)


class Compose:
    def __init__(self, transforms: Sequence[Callable[[dict], dict]]):
        self.transforms = list(transforms)

    def __call__(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


class CloneEntries:
    """Copies of the raw inputs under DEFAULT_CLONE_KEY (for showing the
    inputs beside the predictions)."""

    def __init__(self, keys: Optional[Sequence[str]] = None):
        self.keys = keys

    def __call__(self, sample: dict) -> dict:
        keys = self.keys or [k for k in sample if not k.startswith("_")]
        sample[DEFAULT_CLONE_KEY] = {
            k: (sample[k].copy() if isinstance(sample[k], np.ndarray)
                else sample[k])
            for k in keys if k in sample
        }
        return sample


class FullResCloner:
    """Full-resolution copies as '<key>_fullres'."""

    def __init__(self, keys_to_keep_fullres: Sequence[str],
                 ignore_missing_keys: bool = True):
        self.keys = tuple(keys_to_keep_fullres)
        self.ignore_missing = ignore_missing_keys

    @staticmethod
    def get_fullres_key(key: str) -> str:
        return f"{key}_fullres"

    def __call__(self, sample: dict) -> dict:
        for k in self.keys:
            if k not in sample:
                if self.ignore_missing:
                    continue
                raise KeyError(k)
            v = sample[k]
            sample[self.get_fullres_key(k)] = (
                v.copy() if isinstance(v, np.ndarray) else v)
        return sample


class Resize:
    """Deterministic resize; records the original shape under
    APPLIED_PREPROCESSING_KEY."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, sample: dict) -> dict:
        trace = sample.setdefault(APPLIED_PREPROCESSING_KEY, [])
        for k in _GEOMETRY_KEYS:
            if k in sample:
                if "resize" not in [t[0] for t in trace]:
                    trace.append(("resize", {
                        "orig_height": sample[k].shape[0],
                        "orig_width": sample[k].shape[1],
                    }))
                sample[k] = _resize_sample_key(k, sample[k], self.height,
                                               self.width)
        return sample


class PanopticTargetGenerator:
    """Ground-truth panoptic map semantic * 2**16 + instance."""

    def __init__(self, semantic_classes_is_thing: Sequence[bool],
                 label_divisor: int = 2**16):
        self.is_thing = np.asarray(semantic_classes_is_thing, bool)
        self.label_divisor = label_divisor

    def __call__(self, sample: dict) -> dict:
        if "semantic" in sample and "instance" in sample:
            sample["panoptic"] = deeplab_merge_numpy(
                sample["semantic"], sample["instance"], self.is_thing,
                label_divisor=self.label_divisor)
        return sample


class RandomResize:
    """Random scale in [min_scale, max_scale]."""

    def __init__(self, min_scale: float = 1.0, max_scale: float = 1.4):
        self.min_scale = min_scale
        self.max_scale = max_scale

    def __call__(self, sample: dict) -> dict:
        scale = _rng_of(sample).uniform(self.min_scale, self.max_scale)
        for k in _GEOMETRY_KEYS:
            if k in sample:
                h = int(round(sample[k].shape[0] * scale))
                w = int(round(sample[k].shape[1] * scale))
                sample[k] = _resize_sample_key(k, sample[k], h, w)
        return sample


class RandomCrop:
    def __init__(self, crop_height: int, crop_width: int):
        self.crop_height = crop_height
        self.crop_width = crop_width

    def __call__(self, sample: dict) -> dict:
        rng = _rng_of(sample)
        some = next(k for k in _GEOMETRY_KEYS if k in sample)
        h, w = sample[some].shape[:2]
        ch, cw = self.crop_height, self.crop_width
        pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
        y0 = rng.integers(0, h + pad_h - ch + 1)
        x0 = rng.integers(0, w + pad_w - cw + 1)
        for k in _GEOMETRY_KEYS:
            if k not in sample:
                continue
            v = sample[k]
            if pad_h or pad_w:
                pad = [(0, pad_h), (0, pad_w)] + [(0, 0)] * (v.ndim - 2)
                v = np.pad(v, pad, mode="constant")
            sample[k] = v[y0 : y0 + ch, x0 : x0 + cw]
        return sample


class RandomHSVJitter:
    """HSV jitter of the RGB image."""

    def __init__(self, hue_jitter: float = 10 / 180,
                 saturation_jitter: float = 20 / 255,
                 value_jitter: float = 50 / 255):
        self.hue_jitter = hue_jitter
        self.saturation_jitter = saturation_jitter
        self.value_jitter = value_jitter

    def __call__(self, sample: dict) -> dict:
        if "rgb" not in sample:
            return sample
        rng = _rng_of(sample)
        dh = rng.uniform(-self.hue_jitter, self.hue_jitter)
        ds = rng.uniform(-self.saturation_jitter, self.saturation_jitter)
        dv = rng.uniform(-self.value_jitter, self.value_jitter)
        sample["rgb"] = native.hsv_jitter(sample["rgb"], dh, ds, dv)
        return sample


def _hsv_jitter_plain(rgb_u8: np.ndarray, dh: float, ds: float,
                      dv: float) -> np.ndarray:
    """The numpy path of `RandomHSVJitter` for drawn jitters."""
    rgb = rgb_u8.astype(np.float32) / 255.0
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        dd = np.maximum(delta, 1e-12)
        h = np.where(
            maxc == r, (g - b) / dd % 6,
            np.where(maxc == g, (b - r) / dd + 2, (r - g) / dd + 4),
        ) / 6.0
    h = np.where(delta > 0, h, 0.0)

    h = (h + dh) % 1.0
    s = np.clip(s + ds, 0, 1)
    v = np.clip(v + dv, 0, 1)
    i = np.floor(h * 6).astype(np.int32) % 6
    f = h * 6 - np.floor(h * 6)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ], 0)
    out = np.take_along_axis(
        choices, i[None, ..., None].astype(np.int64), axis=0
    )[0]
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample: dict) -> dict:
        if _rng_of(sample).random() >= self.p:
            return sample
        for k in _GEOMETRY_KEYS:
            if k in sample:
                sample[k] = np.ascontiguousarray(sample[k][:, ::-1])
        if "normal" in sample:
            normal = sample["normal"].copy()
            normal[..., 0] *= -1  # x component mirrors
            sample["normal"] = normal
        if "orientations" in sample:
            sample["orientations"] = {
                iid: float((-theta) % (2 * np.pi))
                for iid, theta in sample["orientations"].items()
            }
        return sample


class SemanticClassMapper:
    """Map a set of classes to a new label (the ScanNet benchmark mode,
    SUNRGB-D combined with other datasets)."""

    def __init__(self, classes_to_map: Sequence[int], new_label: int = 0):
        self.classes_to_map = np.asarray(tuple(classes_to_map), np.int64)
        self.new_label = new_label

    def __call__(self, sample: dict) -> dict:
        if "semantic" in sample and len(self.classes_to_map):
            sem = sample["semantic"]
            mask = np.isin(sem, self.classes_to_map)
            sample["semantic"] = np.where(mask, self.new_label, sem)
        return sample


class InstanceClearStuffIDs:
    """Force instance id 0 on stuff and void pixels."""

    def __init__(self, semantic_classes_is_thing: Sequence[bool]):
        self.is_thing = np.asarray(semantic_classes_is_thing, bool)

    def __call__(self, sample: dict) -> dict:
        if "instance" in sample and "semantic" in sample:
            thing = self.is_thing[sample["semantic"]]
            sample["instance"] = np.where(thing, sample["instance"], 0)
        return sample


def _instance_targets(semantic: np.ndarray, instance: np.ndarray,
                      is_thing: np.ndarray, sigma: float,
                      normalized_offset: bool) -> Dict[str, np.ndarray]:
    """Gaussian center heatmap, offsets to the center, foreground and the
    heatmap loss mask (Panoptic-DeepLab targets)."""
    return native.instance_targets(semantic, instance, is_thing, sigma,
                                   normalized_offset)


def _instance_targets_plain(semantic: np.ndarray, instance: np.ndarray,
                            is_thing: np.ndarray, sigma: float,
                            normalized_offset: bool
                            ) -> Dict[str, np.ndarray]:
    """The numpy path of `_instance_targets`."""
    h, w = instance.shape
    center = np.zeros((h, w), np.float32)
    offset = np.zeros((h, w, 2), np.float32)
    thing = is_thing[semantic] & (instance > 0)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for iid in np.unique(instance[thing]):
        mask = (instance == iid) & thing
        my = ys[mask].mean()
        mx = xs[mask].mean()
        # gaussian bump around (my, mx), accumulated with max
        y0, y1 = max(int(my - 3 * sigma), 0), min(int(my + 3 * sigma) + 1, h)
        x0, x1 = max(int(mx - 3 * sigma), 0), min(int(mx + 3 * sigma) + 1, w)
        if y1 > y0 and x1 > x0:
            gy = ys[y0:y1, x0:x1] - my
            gx = xs[y0:y1, x0:x1] - mx
            g = np.exp(-(gy**2 + gx**2) / (2 * sigma**2))
            center[y0:y1, x0:x1] = np.maximum(center[y0:y1, x0:x1], g)
        offset[mask, 0] = my - ys[mask]
        offset[mask, 1] = mx - xs[mask]

    if normalized_offset:
        offset[..., 0] /= h
        offset[..., 1] /= w

    return {
        "instance_center": center[..., None],
        "instance_offset": offset,
        "instance_foreground": thing,
        # heatmap loss mask: everything except void
        "instance_center_mask": semantic > 0,
    }


class InstanceTargetGenerator:
    """Center / offset / foreground targets, also per downscale."""

    def __init__(self, sigma: float,
                 semantic_classes_is_thing: Sequence[bool],
                 sigma_for_additional_downscales: Optional[
                     Dict[int, float]] = None,
                 normalized_offset: bool = True):
        self.sigma = sigma
        self.is_thing = np.asarray(semantic_classes_is_thing, bool)
        self.downscale_sigmas = sigma_for_additional_downscales or {}
        self.normalized_offset = normalized_offset

    def __call__(self, sample: dict) -> dict:
        if "instance" in sample and "semantic" in sample:
            sample.update(_instance_targets(
                sample["semantic"], sample["instance"], self.is_thing,
                self.sigma, self.normalized_offset))
        for downscale, sigma in self.downscale_sigmas.items():
            sub = sample.get(f"_down_{downscale}")
            if sub is None or "instance" not in sub:
                continue
            sub.update(_instance_targets(
                sub["semantic"], sub["instance"], self.is_thing,
                max(sigma, 1.0), self.normalized_offset))
        return sample


class OrientationTargetGenerator:
    """Dense orientation (biternion) target and its foreground."""

    def __init__(self, semantic_classes_estimate_orientation: Sequence[bool]):
        self.use_orientation = np.asarray(
            semantic_classes_estimate_orientation, bool)

    def _generate(self, sub: dict):
        instance = sub["instance"]
        semantic = sub["semantic"]
        orientations = sub.get("orientations", {})
        h, w = instance.shape
        target = np.zeros((h, w, 2), np.float32)
        fg = np.zeros((h, w), bool)
        present = {}
        for iid, theta in orientations.items():
            mask = instance == iid
            if not mask.any():
                continue
            cls = np.bincount(semantic[mask]).argmax()
            if not self.use_orientation[cls]:
                continue
            target[mask, 0] = np.sin(theta)
            target[mask, 1] = np.cos(theta)
            fg |= mask
            present[int(iid)] = float(theta)
        sub["orientation"] = target
        sub["orientation_foreground"] = fg
        sub["orientations_present"] = present

    def __call__(self, sample: dict) -> dict:
        if "instance" in sample and "semantic" in sample:
            self._generate(sample)
        for key in list(sample.keys()):
            if key.startswith("_down_") and isinstance(sample[key], dict):
                sub = sample[key]
                if "instance" in sub and "orientations" in sub:
                    self._generate(sub)
        return sample


class MultiscaleSupervisionGenerator:
    """Nested `_down_{s}` sub-samples for side-output supervision."""

    def __init__(self, downscales: Sequence[int], keys: Sequence[str]):
        self.downscales = tuple(downscales)
        self.keys = tuple(keys)

    def __call__(self, sample: dict) -> dict:
        for s in self.downscales:
            sub = {}
            for k in self.keys:
                if k not in sample:
                    continue
                v = sample[k]
                if isinstance(v, np.ndarray) and v.ndim >= 2:
                    h, w = v.shape[0] // s, v.shape[1] // s
                    sub[k] = _resize_sample_key(k, v, max(h, 1), max(w, 1))
                else:
                    sub[k] = v
            sample[f"_down_{s}"] = sub
        return sample


class NormalMaskGenerator:
    """`normal_mask`: the pixels whose ground-truth normal has a norm
    above 0.5 (prepared normals mark invalid pixels by the zero vector),
    for the sample and each `_down_{s}` sub-sample
    (`emsanet_tpu/preprocessing/transforms.py:536-562`)."""

    threshold = 0.5

    def _apply(self, d: dict):
        if "normal" in d and isinstance(d["normal"], np.ndarray):
            n = d["normal"].astype(np.float32)
            d["normal_mask"] = np.linalg.norm(n, axis=-1) > self.threshold

    def __call__(self, sample: dict) -> dict:
        self._apply(sample)
        for k, v in sample.items():
            if k.startswith("_down_") and isinstance(v, dict):
                self._apply(v)
        return sample


def _normalize_rgb_plain(rgb: np.ndarray) -> np.ndarray:
    return (rgb.astype(np.float32) / 255.0 - RGB_MEAN) / RGB_STD


class NormalizeRGB:
    def __call__(self, sample: dict) -> dict:
        if "rgb" in sample:
            rgb = sample["rgb"]
            if rgb.dtype == np.uint8 and rgb.ndim == 3 and rgb.shape[-1] == 3:
                sample["rgb"] = native.normalize_rgb(rgb, RGB_MEAN, RGB_STD)
            else:
                sample["rgb"] = _normalize_rgb_plain(rgb)
        return sample


class NormalizeDepth:
    """Depth standardization; raw depth keeps invalid (0) pixels at 0."""

    def __init__(self, depth_mean: float, depth_std: float, raw_depth: bool):
        self.mean = depth_mean
        self.std = depth_std
        self.raw_depth = raw_depth

    def __call__(self, sample: dict) -> dict:
        if "depth" in sample:
            d = sample["depth"].astype(np.float32)
            normalized = (d - self.mean) / self.std
            if self.raw_depth:
                normalized = np.where(d > 0, normalized, 0.0)
            if normalized.ndim == 2:
                normalized = normalized[..., None]
            sample["depth"] = normalized
        return sample


class PadToMultiple:
    """Pad the network-resolution arrays at the bottom and right to
    multiples of `multiple` (32, the encoder's stride) for validation at
    full resolution, so cameras whose sizes round up alike share shapes.
    The pre-pad size goes to `_prepad_hw`; the task helpers crop the
    predictions back before scoring. `*_fullres` targets stay as they
    are."""

    def __init__(self, multiple: int = 32):
        self.multiple = multiple

    def __call__(self, sample: dict) -> dict:
        ref = sample.get("rgb", sample.get("depth"))
        if ref is None:
            return sample
        h, w = ref.shape[:2]
        m = self.multiple
        hp = -(-h // m) * m
        wp = -(-w // m) * m
        sample["_prepad_hw"] = np.asarray([h, w], np.int32)
        if hp == h and wp == w:
            return sample
        for k in list(sample.keys()):
            v = sample[k]
            if (not isinstance(v, np.ndarray) or k.startswith("_")
                    or k.endswith("_fullres") or v.ndim < 2
                    or v.shape[:2] != (h, w)):
                continue
            pad = [(0, hp - h), (0, wp - w)] + [(0, 0)] * (v.ndim - 2)
            sample[k] = np.pad(v, pad)  # zeros: void labels, masked out
        return sample


class ToArrays:
    """Final dtype and shape canonicalization."""

    _f32 = ("rgb", "depth", "instance_center", "instance_offset",
            "orientation", "normal")
    _i32 = ("semantic", "instance", "scene")

    def _canon(self, d: dict):
        for k in list(d.keys()):
            v = d[k]
            if isinstance(v, dict) and k.startswith("_down_"):
                self._canon(v)
                continue
            if not isinstance(v, np.ndarray):
                continue
            if k in self._f32:
                v = v.astype(np.float32)
                if k == "rgb" and v.ndim == 2:
                    v = v[..., None]
            elif k in self._i32 or (k.endswith("_fullres")
                                    and k != "rgb_fullres"):
                if np.issubdtype(v.dtype, np.integer):
                    v = v.astype(np.int32)
            d[k] = v

    def __call__(self, sample: dict) -> dict:
        sample.pop("_rng", None)
        self._canon(sample)
        return sample


def get_preprocessor(cfg, dataset_config, phase: str,
                     multiscale_downscales: Optional[Tuple[int, ...]] = None,
                     keep_raw_inputs: bool = False,
                     sunrgbd_combined: bool = False) -> Compose:
    """The transform chain of a phase ('train' or 'test'). cfg:
    EMSANetConfig; dataset_config: `datasets.metadata.DatasetConfig`.
    The test phase resizes to the validation input size, or with
    `validation_full_resolution` keeps each sample's own size and pads it
    to a multiple of 32. `sunrgbd_combined`: SUNRGB-D first among other
    datasets, whose classes 38-40 it lacks, so they become void."""
    if phase not in ("train", "test"):
        raise ValueError(f"phase must be 'train' or 'test', got '{phase}'")
    m, d = cfg.model, cfg.data
    is_thing = dataset_config.classes_is_thing
    has_instance = "instance" in m.tasks
    transforms = []
    if keep_raw_inputs or cfg.train.visualize_validation:
        transforms.append(CloneEntries())
    if phase == "test" and d.validation_scannet_benchmark_mode:
        if d.scannet_semantic_n_classes not in (40, 549):
            raise ValueError("the ScanNet benchmark mode needs 40 or 549 "
                             "classes")
        mapping = (
            scannet_meta.SEMANTIC_CLASSES_40_MAPPING_TO_BENCHMARK
            if d.scannet_semantic_n_classes == 40
            else scannet_meta.SEMANTIC_CLASSES_549_MAPPING_TO_BENCHMARK200)
        transforms.append(SemanticClassMapper(
            scannet_meta.classes_to_ignore(mapping), new_label=0))
    if sunrgbd_combined:
        transforms.append(SemanticClassMapper((38, 39, 40), 0))
    if has_instance:
        transforms.append(InstanceClearStuffIDs(is_thing))
    if phase == "train":
        transforms.extend([
            RandomResize(d.aug_scale_min, d.aug_scale_max),
            RandomCrop(m.input_height, m.input_width),
        ])
        if not d.disable_color_flip_aug:
            transforms.extend([RandomHSVJitter(), RandomHorizontalFlip(0.5)])
    else:
        if "semantic" in m.tasks and has_instance:
            transforms.append(PanopticTargetGenerator(is_thing))
        transforms.append(FullResCloner(
            ("rgb", "depth", "semantic", "normal", "instance", "panoptic"),
            ignore_missing_keys=True))
        if not d.validation_full_resolution:
            transforms.append(Resize(d.validation_input_height,
                                     d.validation_input_width))

    if multiscale_downscales:
        keys = ["identifier"]
        if "semantic" in m.tasks:
            keys.append("semantic")
        if has_instance:
            keys.extend(["semantic", "instance"])
            if "orientation" in m.tasks:
                keys.append("orientations")
        if "normal" in m.tasks:
            keys.append("normal")
        transforms.append(MultiscaleSupervisionGenerator(
            multiscale_downscales, tuple(dict.fromkeys(keys))))
    else:
        multiscale_downscales = ()

    if has_instance:
        sigma = m.instance_center_sigma
        transforms.append(InstanceTargetGenerator(
            sigma=sigma, semantic_classes_is_thing=is_thing,
            sigma_for_additional_downscales={
                s: (4 * sigma) // s for s in multiscale_downscales},
            normalized_offset=m.instance_normalized_offset))
    if "orientation" in m.tasks:
        transforms.append(OrientationTargetGenerator(
            dataset_config.classes_use_orientations))
    if "normal" in m.tasks:
        transforms.append(NormalMaskGenerator())
    if "rgb" in m.input_modalities or "rgbd" in m.input_modalities:
        transforms.append(NormalizeRGB())
    if "depth" in m.input_modalities or "rgbd" in m.input_modalities:
        transforms.append(NormalizeDepth(
            depth_mean=dataset_config.depth_stats.mean,
            depth_std=dataset_config.depth_stats.std, raw_depth=d.raw_depth))
    transforms.append(ToArrays())
    if phase != "train" and d.validation_full_resolution:
        transforms.append(PadToMultiple(32))
    return Compose(transforms)
