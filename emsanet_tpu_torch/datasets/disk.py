"""Prepared datasets on disk.

A copy of `emsanet_tpu/datasets/disk.py::PreparedDataset`, reading the
layout that `tools/prepare_dataset.py` (or the reference's
`nicr_sa_prepare_dataset`) writes, with the same directory fallbacks:

    <root>/<split>/rgb/<id>.png                  (h, w, 3) uint8
    <root>/<split>/{depth,depth_raw}/<id>.png    (h, w) uint16
    <root>/<split>/{semantic_N,semantic,labels_N,labels}/<id>.png
    <root>/<split>/{instance,instances}/<id>.png (h, w) uint16
    <root>/<split>/orientations/<id>.json        {"<instance id>": yaw}
    <root>/<split>/{scene_class,scene}/<id>.txt  int or class name
    <root>/<split>/{normal,normals}/<id>.png     (h, w, 3) uint8
    <root>/<split>/cameras.json                  {"<id>": "<camera>"}
    <root>/<split>/packed/index.json + <modality>.bin (tools/pack_dataset.py
                                                 or datasets/pack.py)
    <root>[/<split>]/meta.json                   label tables, depth stats

Sample ids are the sorted stems of `rgb/`; `subsample` keeps every Nth,
`cameras` those of the named cameras. A split's packed binaries are
memory-mapped and preferred (no decode); PNGs are decoded by the port's
own reader (`datasets/png.py`). `meta.json` wins over the built-in
tables unless it disagrees with an explicit class count. Scene files
hold an index into the on-disk scene list or a class name; with the
indoor-domestic labels a name is remapped, an unknown one goes to
'other indoor' (else void).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from emsanet_tpu_torch.datasets.base import (
    SampleIdentifier,
    SceneAnalysisDataset,
)
from emsanet_tpu_torch.datasets.metadata import (
    INDOOR_DOMESTIC_SCENES,
    DatasetConfig,
    get_dataset_config,
    load_meta_config,
    map_scene_to_indoor_domestic,
)
from emsanet_tpu_torch.datasets.png import read_png


class PreparedDataset(SceneAnalysisDataset):
    def __init__(
        self,
        dataset_path: str,
        dataset_name: str,
        split: str,
        sample_keys: Sequence[str],
        semantic_n_classes: Optional[int] = None,
        depth_mode: str = "refined",
        use_cache: bool = False,
        cameras: Optional[Sequence[str]] = None,
        scene_use_indoor_domestic_labels: bool = False,
        subsample: Optional[int] = None,
        use_packed: bool = True,
    ):
        super().__init__(sample_keys=sample_keys, use_cache=use_cache)
        self.dataset_path = dataset_path
        self.dataset_name = dataset_name
        self.split = split
        self.depth_mode = depth_mode
        # the prepared dataset's meta.json (label tables used at conversion
        # time + depth stats computed from the real training data) is
        # authoritative; built-in tables are the fallback
        meta_config = load_meta_config(
            dataset_path, split=split, depth_mode=depth_mode
        )
        if meta_config is not None and semantic_n_classes is not None and (
            meta_config.n_semantic_classes_without_void != semantic_n_classes
        ):
            # an explicit class-count request (e.g. ScanNet-20 benchmark
            # mode on a 40-class prepared dataset) must not be silently
            # overridden by the prepared meta table
            meta_config = None
        self._config = meta_config or get_dataset_config(
            dataset_name,
            semantic_n_classes=semantic_n_classes,
            scene_use_indoor_domestic_labels=scene_use_indoor_domestic_labels,
        )
        # scene names as stored on disk (int scene_class files index this
        # list); the *exposed* scene list may be the indoor-domestic remap
        self._scene_names_on_disk = self._config.scene_class_names
        self._scene_domestic = bool(scene_use_indoor_domestic_labels)
        if self._scene_domestic and (
            meta_config is not None
            or self._config.scene_class_names[1:] != INDOOR_DOMESTIC_SCENES
        ):
            self._config = self._config.with_scenes(INDOOR_DOMESTIC_SCENES)

        split_dir = os.path.join(dataset_path, split)
        rgb_dir = os.path.join(split_dir, "rgb")
        if not os.path.isdir(rgb_dir):
            raise FileNotFoundError(
                f"Prepared dataset split not found: {rgb_dir}"
            )
        self._split_dir = split_dir
        self._ids: List[str] = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(rgb_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        if subsample and subsample > 1:
            # every Nth sample (ScanNet/Hypersim subsampling, args.py:887,940)
            self._ids = self._ids[::subsample]
        self._exts: Dict[str, str] = {}
        for f in os.listdir(rgb_dir):
            stem, ext = os.path.splitext(f)
            self._exts[stem] = ext

        # camera assignment (SUNRGB-D kv1/kv2/realsense/xtion etc.)
        cam_file = os.path.join(split_dir, "cameras.json")
        if os.path.isfile(cam_file):
            with open(cam_file) as fh:
                self._camera_by_id = json.load(fh)
        else:
            self._camera_by_id = {}
        self._all_cameras = tuple(
            sorted(set(self._camera_by_id.values()))
        ) or ("default",)
        if cameras:
            allowed = set(cameras)
            self._ids = [
                i for i in self._ids
                if self._camera_by_id.get(i, "default") in allowed
            ]
            self._all_cameras = tuple(sorted(allowed))

        def find_dir(*candidates: str) -> Optional[str]:
            for c in candidates:
                d = os.path.join(split_dir, c)
                if os.path.isdir(d):
                    return d
            return None

        # packed raw binaries (tools/pack_dataset.py): mmap-ed, zero-decode
        self._packed = None
        self._packed_maps: Dict[str, np.memmap] = {}
        if use_packed:
            idx_path = os.path.join(split_dir, "packed", "index.json")
            if os.path.isfile(idx_path):
                with open(idx_path) as fh:
                    packed = json.load(fh)
                packed["pos_by_id"] = {
                    sid: i for i, sid in enumerate(packed["ids"])
                }
                self._packed = packed

        n_cls = semantic_n_classes or self._config.n_semantic_classes_without_void
        self._dirs = {
            "rgb": rgb_dir,
            "depth": find_dir(
                "depth_raw" if depth_mode == "raw" else "depth",
                "depth", "depth_raw",
            ),
            "semantic": find_dir(
                f"semantic_{n_cls}", "semantic", f"labels_{n_cls}", "labels"
            ),
            "instance": find_dir("instance", "instances"),
            "orientations": find_dir("orientations"),
            "scene": find_dir("scene_class", "scene"),
            "normal": find_dir("normal", "normals"),
        }
        if self._packed is not None:
            mods = self._packed["modalities"]

            def find_mod(*candidates: str) -> Optional[str]:
                for c in candidates:
                    if c in mods:
                        return c
                return None

            self._packed_names = {
                "rgb": find_mod("rgb"),
                "depth": find_mod(
                    "depth_raw" if depth_mode == "raw" else "depth",
                    "depth", "depth_raw",
                ),
                "semantic": find_mod(
                    f"semantic_{n_cls}", "semantic",
                    f"labels_{n_cls}", "labels",
                ),
                "instance": find_mod("instance", "instances"),
                "normal": find_mod("normal", "normals"),
            }

    def __len__(self) -> int:
        return len(self._ids)

    def __getstate__(self):
        # a process worker maps the packed files itself
        state = super().__getstate__()
        state["_packed_maps"] = {}
        return state

    @property
    def config(self) -> DatasetConfig:
        return self._config

    @property
    def cameras(self) -> Tuple[str, ...]:
        return self._all_cameras

    def filter_camera(self, camera: str) -> "PreparedDataset":
        self._camera = camera
        self._ids = [
            i for i in self._ids
            if self._camera_by_id.get(i, "default") == camera
        ]
        return self

    def _resolve_scene(self, content: str) -> int:
        """Scene file content (int index into the on-disk list, or a raw
        class name) -> index into the *exposed* scene label list, applying
        the indoor-domestic remap when configured. Unknown names map to
        'other indoor' when available, else void (0)."""
        try:
            idx = int(content)
            in_range = 0 <= idx < len(self._scene_names_on_disk)
            name = self._scene_names_on_disk[idx] if in_range else "void"
            if not self._scene_domestic and (
                self._config.scene_class_names == self._scene_names_on_disk
            ):
                # fast path: exposed list is the on-disk list; an
                # out-of-range index (corrupt file) maps to void
                return idx if in_range else 0
        except ValueError:
            name = content
        if self._scene_domestic:
            name = map_scene_to_indoor_domestic(name)
        try:
            return self._config.scene_class_names.index(name)
        except ValueError:
            try:
                return self._config.scene_class_names.index("other indoor")
            except ValueError:
                return 0

    def _path(self, kind: str, sample_id: str, ext: str = ".png") -> str:
        d = self._dirs.get(kind)
        if d is None:
            raise FileNotFoundError(
                f"Dataset at {self._split_dir} has no '{kind}' directory but "
                f"sample key requires it."
            )
        return os.path.join(d, sample_id + ext)

    def _packed_read(self, kind: str, sid: str) -> Optional[np.ndarray]:
        """Zero-decode read from the packed binaries; None if unavailable."""
        if self._packed is None:
            return None
        name = self._packed_names.get(kind)
        if name is None:
            return None
        pos = self._packed["pos_by_id"].get(sid)
        if pos is None:
            return None
        mod = self._packed["modalities"][name]
        mm = self._packed_maps.get(name)
        if mm is None:
            mm = np.memmap(
                os.path.join(self._split_dir, "packed", name + ".bin"),
                dtype=np.dtype(mod["dtype"]), mode="r",
            )
            self._packed_maps[name] = mm
        shape = mod["shapes"][pos]
        off = mod["offsets"][pos] // mm.itemsize
        n = int(np.prod(shape))
        return np.asarray(mm[off:off + n]).reshape(shape)

    def _load(self, idx: int) -> dict:
        sid = self._ids[idx]
        sample: dict = {}
        if "identifier" in self.sample_keys:
            sample["identifier"] = SampleIdentifier((self.split, sid))
        if "rgb" in self.sample_keys:
            rgb = self._packed_read("rgb", sid)
            if rgb is None:
                rgb = read_png(
                    self._path("rgb", sid, self._exts.get(sid, ".png"))
                )
                if rgb.ndim == 2:
                    rgb = np.stack([rgb] * 3, axis=-1)
                rgb = rgb[..., :3]
            sample["rgb"] = rgb.astype(np.uint8)
        if "depth" in self.sample_keys:
            depth = self._packed_read("depth", sid)
            if depth is None:
                depth = read_png(self._path("depth", sid))
            sample["depth"] = depth.astype(np.float32)
        if "semantic" in self.sample_keys:
            sem = self._packed_read("semantic", sid)
            if sem is None:
                sem = read_png(self._path("semantic", sid))
            sample["semantic"] = sem.astype(np.int32)
        if "instance" in self.sample_keys:
            inst = self._packed_read("instance", sid)
            if inst is None:
                inst = read_png(self._path("instance", sid))
            sample["instance"] = inst.astype(np.int32)
        if "orientations" in self.sample_keys:
            if self._packed is not None and "orientations" in self._packed:
                raw_ori = self._packed["orientations"].get(sid, {})
                sample["orientations"] = {
                    int(k): float(v) for k, v in raw_ori.items()
                }
            else:
                try:
                    with open(
                        self._path("orientations", sid, ".json")
                    ) as fh:
                        sample["orientations"] = {
                            int(k): float(v)
                            for k, v in json.load(fh).items()
                        }
                except FileNotFoundError:
                    sample["orientations"] = {}
        if "scene" in self.sample_keys:
            if self._packed is not None and "scene" in self._packed:
                content = self._packed["scene"].get(sid)
                sample["scene"] = (
                    self._resolve_scene(content) if content is not None
                    else 0
                )
            else:
                try:
                    with open(self._path("scene", sid, ".txt")) as fh:
                        sample["scene"] = self._resolve_scene(
                            fh.read().strip()
                        )
                except FileNotFoundError:
                    sample["scene"] = 0
        if "normal" in self.sample_keys:
            raw = self._packed_read("normal", sid)
            if raw is None:
                raw = read_png(self._path("normal", sid))
            sample["normal"] = raw.astype(np.float32) / 127.5 - 1.0
        return sample
