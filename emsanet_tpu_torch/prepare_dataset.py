"""Dataset preparation: convert raw distributions into the prepared
on-disk layout that `emsanet_tpu_torch.datasets.disk.PreparedDataset`
reads.

    python -m emsanet_tpu_torch.prepare_dataset <dataset> --out DIR ...

Counterpart of the repository's `tools/prepare_dataset.py`, with the
same subcommands, flags and layout, and files whose decoded contents
equal that tool's. It runs on the host without an image library: every
image is written by `datasets/png.py::write_png`, PNG and JPEG inputs
are read by the port's own readers (`datasets/png.py`, `datasets/
jpeg.py`: baseline JPEG decoded as PIL decodes it; progressive and CMYK
JPEG raise `NotPortedError`), and PIL's BILINEAR and NEAREST resizes
are `imaging.resize_bilinear_u8` and `imaging.resize_nearest`.

  nyuv2         nyu_depth_v2_labeled.mat (v7.3, through h5py) + splits.mat
                + an optional 894->40 class mapping .mat (scipy)
  sunrgbd       the SUNRGB-D toolbox layout (seg.mat, 3D boxes, allsplit)
  hypersim      the apple-hypersim download (HDF5 through h5py)
  scannet       the ScanNet v2 download (.sens streams, label zips)
  coco          the COCO panoptic release
  cityscapes    leftImg8bit / gtFine / disparity PNGs
  scenenetrgbd  SceneNetRGBD trajectories and their protobufs
  synthetic     the synthetic dataset (no input data)

nyuv2 and hypersim need h5py, which is imported only there: where it is
missing they raise an ImportError that names it (the card's machine has
scipy but no h5py; preparation runs on any host).

Prepared layout (one directory per split):
  <out>/<split>/rgb/<id>.png            HWC uint8
  <out>/<split>/depth/<id>.png          HW uint16
  <out>/<split>/semantic_40/<id>.png    HW uint8  (0 = void)
  <out>/<split>/instance/<id>.png       HW uint16 (0 = no instance)
  <out>/<split>/orientations/<id>.json  {"<instance_id>": yaw_rad}
  <out>/<split>/scene_class/<id>.txt    class index (int)
  <out>/<split>/cameras.json            {"<id>": "<camera>"} (optional)
  <out>/meta.json                       label tables + depth statistics
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from emsanet_tpu_torch import imaging
from emsanet_tpu_torch.datasets.metadata import (
    NYUV2_40,
    SUNRGBD_37,
    generate_distinct_colors,
    get_dataset_config,
)
from emsanet_tpu_torch.datasets.png import (
    decode_image,
    read_png,
    read_rgb,
    write_png,
)


def _save_png(path, arr):
    write_png(path, np.asarray(arr))


def _h5py():
    """h5py, imported where a preparer needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is needed to read NYUv2's .mat (v7.3) and Hypersim's "
            "HDF5 files; install h5py on the host that prepares the "
            "dataset") from e
    return h5py


def compute_depth_stats(depth_dir, max_files=2000):
    """Depth statistics over a prepared split's depth PNGs.

    mean/std are computed over valid (non-zero) pixels — the convention of
    the published ESANet/EMSANet statistics (zero encodes missing depth).
    Uses a running sum/sumsq so arbitrarily many files fit in memory; for
    very large datasets an evenly-strided subset of `max_files` is used.
    """
    files = sorted(os.listdir(depth_dir))
    if max_files and len(files) > max_files:
        stride = len(files) // max_files
        files = files[::stride]
    n = 0
    s = 0.0
    sq = 0.0
    mx = 0.0
    for f in files:
        d = read_png(os.path.join(depth_dir, f)).astype(np.float64)
        valid = d[d > 0]
        n += valid.size
        s += float(valid.sum())
        sq += float((valid * valid).sum())
        if valid.size:
            mx = max(mx, float(valid.max()))
    mean = s / max(n, 1)
    var = max(sq / max(n, 1) - mean * mean, 0.0)
    return {
        "min": 0.0,
        "max": mx,
        "mean": mean,
        "std": float(np.sqrt(var)),
        "n_valid_pixels": n,
        "n_files": len(files),
    }


def write_meta(out_dir, semantic_entries, scene_names,
               train_split="train", max_files=2000):
    """Emit the authoritative meta.json for a prepared dataset.

    semantic_entries: ((name, is_thing, use_orientations), ...) WITHOUT
    void; scene_names: raw scene class names WITHOUT void, in the index
    order used by the converter's scene_class files. Depth statistics are
    computed from the actually-written training depth maps (they replace
    the built-in fallback stats).
    """
    colors = generate_distinct_colors(len(semantic_entries) + 1)
    meta = {
        "version": 1,
        "semantic_labels": [
            {"name": "void", "is_thing": False, "use_orientations": False,
             "color": [0, 0, 0]}
        ]
        + [
            {"name": name, "is_thing": bool(thing),
             "use_orientations": bool(orient), "color": list(color)}
            for (name, thing, orient), color in zip(
                semantic_entries, colors[1:]
            )
        ],
        "scene_labels": ["void"] + list(scene_names),
    }
    depth_dir = os.path.join(out_dir, train_split, "depth")
    if os.path.isdir(depth_dir) and os.listdir(depth_dir):
        stats = compute_depth_stats(depth_dir, max_files=max_files)
        meta["depth_stats"] = stats
    else:
        meta["depth_stats"] = {"min": 0.0, "max": 1.0, "mean": 0.5,
                               "std": 0.25}
    path = os.path.join(out_dir, "meta.json")
    with open(path, "w") as fh:
        json.dump(meta, fh, indent=2)
    print(f"wrote {path} (depth mean={meta['depth_stats']['mean']:.2f} "
          f"std={meta['depth_stats']['std']:.2f})")


# NYUv2 Kinect RGB-camera intrinsics (NYU toolbox camera_params.m;
# public constants used by the nicr toolchain's normal extraction)
_NYU_FX = 5.8262448167737955e02
_NYU_FY = 5.8269103270988637e02
_NYU_CX = 3.1304475870804731e02
_NYU_CY = 2.3844389626620386e02


def normals_from_depth(depth_m, fx=_NYU_FX, fy=_NYU_FY, cx=_NYU_CX,
                       cy=_NYU_CY, smooth=3):
    """Per-pixel surface normals from a metric depth map.

    Standard cross-product-of-gradients on the back-projected point
    cloud (the nicr toolchain's approach for NYUv2, which ships no
    rendered normals — reference `emsanet/data.py:230` expects a
    `normal` sample key on prepared NYUv2):

      P(u,v) = ((u-cx) Z / fx, (v-cy) Z / fy, Z)
      n = normalize(dP/dv x dP/du), oriented toward the camera.

    Invalid pixels (Z == 0 or any neighbor invalid) get the zero vector,
    which the prepared-layout encoding maps to "no normal". `smooth`
    box-filters the depth first to keep quantization noise out of the
    finite differences.

    Returns (H, W, 3) float32 with unit normals (or zeros).
    """
    z = np.asarray(depth_m, np.float32)
    valid = z > 0
    if smooth and smooth > 1:
        # box filter via cumulative sums, normalizing by the valid count
        k = int(smooth)
        pad = k // 2
        zp = np.pad(np.where(valid, z, 0.0), pad, mode="edge")
        vp = np.pad(valid.astype(np.float32), pad, mode="edge")

        def boxsum(a):
            c = np.cumsum(np.cumsum(a, 0), 1)
            c = np.pad(c, ((1, 0), (1, 0)))
            return (
                c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
            )

        cnt = boxsum(vp)
        zs = np.where(cnt > 0, boxsum(zp) / np.maximum(cnt, 1), 0.0)
        z = np.where(valid, zs, 0.0).astype(np.float32)

    h, w = z.shape
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    p = np.stack([x, y, z], axis=-1)

    # central differences (roll keeps shapes static; edges invalidated)
    dpdu = (np.roll(p, -1, axis=1) - np.roll(p, 1, axis=1)) * 0.5
    dpdv = (np.roll(p, -1, axis=0) - np.roll(p, 1, axis=0)) * 0.5
    n = np.cross(dpdv, dpdu)

    # validity: the pixel and its 4 difference neighbors must have depth
    ok = valid.copy()
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        ok &= np.roll(valid, sh, axis=ax)
    ok[0, :] = ok[-1, :] = False
    ok[:, 0] = ok[:, -1] = False

    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), 0.0)
    # orient toward the camera: flip where n . P > 0 (P points away)
    flip = np.sum(n * p, axis=-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    n = np.where(ok[..., None], n, 0.0)
    return n.astype(np.float32)


def encode_normals_png(n):
    """(H, W, 3) unit normals (zeros = invalid) -> uint8 ((v+1)/2*255)."""
    return np.clip((n + 1.0) * 127.5, 0, 255).astype(np.uint8)


def prepare_nyuv2(mat_path, splits_path, class_mapping_path, out_dir):
    """Convert the NYUv2 labeled .mat into the prepared layout.

    The labeled distribution stores: images (HWC x N), rawDepths/depths
    (float meters), labels (894-class), instances (per-label-instance
    ids), scenes/sceneTypes. The 894->40 mapping comes from the standard
    classMapping40.mat (mapClass field); without it, labels are written
    as-is into semantic_raw/.
    """
    from scipy import io as sio

    print(f"reading {mat_path} ...")
    f = _h5py().File(mat_path, "r")
    images = f["images"]  # (N, 3, W, H) in h5py order
    depths = f["depths"]  # refined, meters
    raw_depths = f.get("rawDepths", depths)
    labels = f["labels"]  # 894-class
    instances = f["instances"]
    scenes = None
    if "sceneTypes" in f:
        refs = f["sceneTypes"][0]
        scenes = [
            "".join(chr(c[0]) for c in f[r][:]) for r in refs
        ]

    n = images.shape[0]

    # splits: train/test indices (1-based in the official splits.mat)
    if splits_path:
        splits = sio.loadmat(splits_path)
        train_idx = set(int(i) - 1 for i in splits["trainNdxs"].ravel())
        test_idx = set(int(i) - 1 for i in splits["testNdxs"].ravel())
    else:
        train_idx = set(range(0, n, 2))
        test_idx = set(range(1, n, 2))

    mapping = None
    if class_mapping_path:
        m = sio.loadmat(class_mapping_path)
        key = "mapClass" if "mapClass" in m else "className"
        mapping = np.concatenate([[0], m[key].ravel()]).astype(np.int32)

    scene_names = sorted(set(scenes)) if scenes else []
    scene_index = {s: i + 1 for i, s in enumerate(scene_names)}

    for i in range(n):
        split = "train" if i in train_idx else (
            "test" if i in test_idx else None
        )
        if split is None:
            continue
        sid = f"{i:04d}"
        base = os.path.join(out_dir, split)

        rgb = np.transpose(np.asarray(images[i]), (2, 1, 0)).astype(np.uint8)
        _save_png(os.path.join(base, "rgb", f"{sid}.png"), rgb)

        depth_m = np.transpose(np.asarray(depths[i]), (1, 0))
        _save_png(
            os.path.join(base, "depth", f"{sid}.png"),
            np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16),
        )
        raw_m = np.transpose(np.asarray(raw_depths[i]), (1, 0))
        _save_png(
            os.path.join(base, "depth_raw", f"{sid}.png"),
            np.clip(raw_m * 1000.0, 0, 65535).astype(np.uint16),
        )

        # per-pixel normals from the refined depth (reference data.py:230
        # expects a 'normal' sample key on prepared NYUv2)
        _save_png(
            os.path.join(base, "normal", f"{sid}.png"),
            encode_normals_png(normals_from_depth(depth_m)),
        )

        label = np.transpose(np.asarray(labels[i]), (1, 0)).astype(np.int32)
        if mapping is not None:
            label40 = mapping[np.clip(label, 0, len(mapping) - 1)]
            _save_png(
                os.path.join(base, "semantic_40", f"{sid}.png"),
                label40.astype(np.uint8),
            )
        else:
            _save_png(
                os.path.join(base, "semantic_raw", f"{sid}.png"),
                np.clip(label, 0, 65535).astype(np.uint16),
            )

        inst = np.transpose(np.asarray(instances[i]), (1, 0)).astype(np.int32)
        # NYUv2 instances are per-class; combine to globally unique ids
        combined = np.zeros_like(inst)
        next_id = 1
        for cls in np.unique(label[inst > 0]):
            cls_mask = label == cls
            for raw_id in np.unique(inst[cls_mask & (inst > 0)]):
                combined[cls_mask & (inst == raw_id)] = next_id
                next_id += 1
        _save_png(
            os.path.join(base, "instance", f"{sid}.png"),
            np.clip(combined, 0, 65535).astype(np.uint16),
        )

        if scenes:
            os.makedirs(os.path.join(base, "scene_class"), exist_ok=True)
            with open(
                os.path.join(base, "scene_class", f"{sid}.txt"), "w"
            ) as fh:
                fh.write(str(scene_index[scenes[i]]))
        if i % 100 == 0:
            print(f"  {i}/{n}")

    if scene_names:
        with open(os.path.join(out_dir, "scene_names.json"), "w") as fh:
            json.dump(scene_names, fh, indent=2)
    if mapping is not None:  # 40-class layout: emit authoritative metadata
        write_meta(out_dir, NYUV2_40, scene_names)
    print(f"done: {out_dir}")


_SEG37_LIST = (
    # SUNRGB-D seg37list class names (toolbox order, 1-based), matching the
    # first 37 NYUv2-40 classes (metadata._SUNRGBD_37)
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "floor_mat",
    "clothes", "ceiling", "books", "fridge", "tv", "paper", "towel",
    "shower_curtain", "box", "whiteboard", "person", "night_stand",
    "toilet", "sink", "lamp", "bathtub", "bag",
)


def _points_in_polygon(px, py, poly_x, poly_y):
    """Vectorized even-odd-rule point-in-polygon test (no deps).

    px/py: arrays of query points; poly_x/poly_y: polygon vertices.
    """
    inside = np.zeros(px.shape, bool)
    n = len(poly_x)
    j = n - 1
    for i in range(n):
        xi, yi = poly_x[i], poly_y[i]
        xj, yj = poly_x[j], poly_y[j]
        crosses = (yi > py) != (yj > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_at = (xj - xi) * (py - yi) / (yj - yi + 1e-30) + xi
        inside ^= crosses & (px < x_at)
        j = i
    return inside


def _read_sunrgbd_camera(dirpath):
    """Read intrinsics.txt (3x3 K) + latest extrinsics/*.txt (Rtilt)."""
    k_file = os.path.join(dirpath, "intrinsics.txt")
    if not os.path.isfile(k_file):
        return None, None
    with open(k_file) as fh:
        k_vals = [float(v) for v in fh.read().split()]
    K = np.asarray(k_vals, np.float64).reshape(3, 3)
    rtilt = np.eye(3)
    ext_dir = os.path.join(dirpath, "extrinsics")
    if os.path.isdir(ext_dir):
        files = sorted(os.listdir(ext_dir))
        if files:
            with open(os.path.join(ext_dir, files[-1])) as fh:
                vals = [float(v) for v in fh.read().split()]
            arr = np.asarray(vals, np.float64)
            if arr.size >= 9:
                rtilt = arr.reshape(-1, 4)[:3, :3] if arr.size % 4 == 0 \
                    else arr.reshape(-1, 3)[:3, :3]
    return K, rtilt


def _load_annotation3d(dirpath):
    """Parse annotation3Dfinal/index.json into footprint boxes.

    Returns [(name, poly_x, poly_y, zmin, zmax, yaw_rad)] in SUNRGB-D room
    coordinates (x right, y forward, z up; the toolbox's
    `readframeSUNRGBD.m` maps the JSON polygon fields X/Z onto the ground
    plane and Ymin/Ymax onto the height interval). yaw is derived from the
    first polygon edge direction (the box basis' dominant axis).
    """
    idx_file = os.path.join(dirpath, "annotation3Dfinal", "index.json")
    if not os.path.isfile(idx_file):
        return []
    try:
        with open(idx_file) as fh:
            data = json.load(fh)
    except (json.JSONDecodeError, OSError):
        return []
    boxes = []
    objects = data.get("objects", data if isinstance(data, list) else [])
    for obj in objects:
        if not obj:
            continue
        name = str(obj.get("name", "")).strip().lower()
        for poly in obj.get("polygon", []):
            if not poly:
                continue
            try:
                xs = np.asarray(poly["X"], np.float64)
                ys = np.asarray(poly["Z"], np.float64)
                zmin = float(poly.get("Ymin", -np.inf))
                zmax = float(poly.get("Ymax", np.inf))
            except (KeyError, TypeError, ValueError):
                continue
            if len(xs) < 3 or len(xs) != len(ys):
                continue
            yaw = float(np.arctan2(ys[1] - ys[0], xs[1] - xs[0]))
            boxes.append((name, xs, ys, zmin, zmax, yaw))
    return boxes


def _extract_box_instances(
    depth_m, K, rtilt, boxes, semantic, name_to_idx, aliases,
    min_pixels=32,
):
    """Rasterize 3D-box annotations into a 2D instance map.

    The reference's `--instances-version emsanet` preparation
    (`prepare_datasets.sh:10-19`) derives instances from the 3D boxes:
    back-project the depth map to a room-coordinate point cloud
    (SUNRGBDtoolbox `read3dPoints.m` convention: p = Rtilt' @ [x, z, -y]),
    then mark pixels whose points fall inside a box footprint polygon +
    height interval AND carry the box's semantic class.

    Returns (instance_map uint16, {instance_id: yaw}).
    """
    h, w = depth_m.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    z = depth_m
    x = (us - cx) * z / fx
    y = (vs - cy) * z / fy
    pts = np.stack([x, z, -y], axis=-1) @ rtilt  # == (Rtilt' @ p.T).T
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    valid = depth_m > 0

    instance = np.zeros((h, w), np.uint16)
    orientations = {}
    next_id = 1
    for name, poly_x, poly_y, zmin, zmax, yaw in boxes:
        cls = name_to_idx.get(aliases.get(name, name), 0)
        if cls == 0 or cls < 3:  # not a mapped thing class
            continue
        mask = (
            valid
            & (instance == 0)
            & (semantic == cls)
            & (pz >= zmin)
            & (pz <= zmax)
            & _points_in_polygon(px, py, poly_x, poly_y)
        )
        if int(mask.sum()) < min_pixels:
            continue
        instance[mask] = next_id
        orientations[next_id] = yaw
        next_id += 1
    return instance, orientations


def prepare_sunrgbd(toolbox_root, out_dir, splits=("train", "test"),
                    instances_version="emsanet"):
    """Convert the SUNRGB-D toolbox layout into the prepared layout.

    Expects the official per-image directory structure
    (`<root>/<sensor>/<...>/<scene>/` with image/, depth_bfx/ or depth/,
    seg.mat (seglabel + names), scene.txt, intrinsics.txt, extrinsics/,
    annotation3Dfinal/ JSON 3D boxes) plus allsplit.mat for the
    train/test split (reference `prepare_datasets.sh:10-19`).

    instances_version:
      'emsanet'  — instances from the 3D box annotations (projected into
                   the depth point cloud; the reference's version) with
                   per-instance yaw orientations; falls back to segments
                   for images without annotation3Dfinal.
      'segments' — instances from seg.mat segment labels of thing classes.

    Also records the per-image sensor (kv1/kv2/realsense/xtion) into
    cameras.json for per-camera evaluation, and emits meta.json with the
    label tables + depth statistics computed from the converted data.
    """
    from scipy import io as sio

    name_to_idx = {n: i + 1 for i, n in enumerate(_SEG37_LIST)}
    # a few common alias spellings in seg.mat names
    aliases = {
        "floormat": "floor_mat", "floor mat": "floor_mat",
        "night stand": "night_stand", "nightstand": "night_stand",
        "shower curtain": "shower_curtain", "refridgerator": "fridge",
        "refrigerator": "fridge", "television": "tv", "bookcase": "bookshelf",
    }

    split_file = os.path.join(toolbox_root, "traintestSUNRGBD",
                              "allsplit.mat")
    train_dirs = test_dirs = None
    if os.path.isfile(split_file):
        m = sio.loadmat(split_file)
        def norm(paths):
            return set(
                "/".join(str(p[0]).rstrip("/").split("/")[-4:])
                for p in paths.ravel()
            )
        train_dirs = norm(m["alltrain"]) | norm(m.get("trainvalsplit",
                                                      m["alltrain"]))
        test_dirs = norm(m["alltest"])

    counters = {s: 0 for s in splits}
    cameras = {s: {} for s in splits}
    scene_names = set()
    root = os.path.abspath(toolbox_root)
    for dirpath, dirnames, filenames in os.walk(toolbox_root):
        if "seg.mat" not in filenames:
            continue
        rel4 = "/".join(dirpath.rstrip("/").split("/")[-4:])
        if test_dirs is not None:
            split = "test" if rel4 in test_dirs else "train"
        else:
            split = "train"
        if split not in splits:
            continue
        try:
            seg = sio.loadmat(os.path.join(dirpath, "seg.mat"))
            seglabel = seg["seglabel"].astype(np.int32)
            names = [str(n[0]) if len(n) else "" for n in
                     seg["names"].ravel()]
        except Exception as e:
            print(f"skip {dirpath}: {e}")
            continue

        img_dir = os.path.join(dirpath, "image")
        depth_dir = os.path.join(dirpath, "depth_bfx")
        if not os.path.isdir(depth_dir):
            depth_dir = os.path.join(dirpath, "depth")
        if not (os.path.isdir(img_dir) and os.path.isdir(depth_dir)):
            continue
        img_file = os.path.join(img_dir, sorted(os.listdir(img_dir))[0])
        depth_file = os.path.join(depth_dir,
                                  sorted(os.listdir(depth_dir))[0])

        sid = f"{counters[split]:05d}"
        counters[split] += 1
        base = os.path.join(out_dir, split)

        # sensor = first path component below the toolbox root
        rel = os.path.relpath(os.path.abspath(dirpath), root)
        sensor = rel.split(os.sep)[0].lower()
        if sensor.startswith("kv1"):
            sensor = "kv1"
        elif sensor.startswith("kv2"):
            sensor = "kv2"
        elif "realsense" in sensor:
            sensor = "realsense"
        elif "xtion" in sensor:
            sensor = "xtion"
        cameras[split][sid] = sensor

        rgb = read_png(img_file)[..., :3]
        _save_png(os.path.join(base, "rgb", f"{sid}.png"),
                  rgb.astype(np.uint8))
        # SUNRGB-D depth PNGs store shifted values; >>3 yields millimeters
        depth_raw = read_png(depth_file).astype(np.uint16)
        depth_mm = ((depth_raw >> 3) | (depth_raw << 13)).astype(np.uint16)
        _save_png(os.path.join(base, "depth", f"{sid}.png"), depth_mm)

        semantic = np.zeros_like(seglabel, np.uint8)
        seg_instance = np.zeros_like(seglabel, np.uint16)
        next_inst = 1
        for seg_id in range(1, seglabel.max() + 1):
            if seg_id - 1 >= len(names):
                continue
            raw_name = names[seg_id - 1].strip().lower()
            cls = name_to_idx.get(aliases.get(raw_name, raw_name), 0)
            mask = seglabel == seg_id
            semantic[mask] = cls
            if cls and cls >= 3:  # thing classes (wall/floor are stuff)
                seg_instance[mask] = next_inst
                next_inst += 1
        _save_png(os.path.join(base, "semantic_37", f"{sid}.png"), semantic)

        instance, orientations = seg_instance, {}
        if instances_version == "emsanet":
            boxes = _load_annotation3d(dirpath)
            K, rtilt = _read_sunrgbd_camera(dirpath)
            if boxes and K is not None and depth_mm.shape == semantic.shape:
                instance, orientations = _extract_box_instances(
                    depth_mm.astype(np.float64) / 1000.0, K, rtilt,
                    boxes, semantic, name_to_idx, aliases,
                )
        _save_png(os.path.join(base, "instance", f"{sid}.png"), instance)
        os.makedirs(os.path.join(base, "orientations"), exist_ok=True)
        with open(os.path.join(base, "orientations", f"{sid}.json"),
                  "w") as fh:
            json.dump({str(k): v for k, v in orientations.items()}, fh)

        scene_file = os.path.join(dirpath, "scene.txt")
        if os.path.isfile(scene_file):
            os.makedirs(os.path.join(base, "scene_class"), exist_ok=True)
            with open(scene_file) as fh:
                scene = fh.read().strip()
            scene_names.add(scene)
            with open(
                os.path.join(base, "scene_class", f"{sid}.txt"), "w"
            ) as out_fh:
                out_fh.write(scene)
        if counters[split] % 500 == 0:
            print(f"  {split}: {counters[split]}")

    for split in splits:
        if cameras[split]:
            path = os.path.join(out_dir, split, "cameras.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as fh:
                json.dump(cameras[split], fh)
    write_meta(out_dir, SUNRGBD_37, sorted(scene_names))
    print(f"done: {counters} -> {out_dir}")


def _hypersim_planar_depth(dist_m, focal_px):
    """Hypersim depth_meters.hdf5 stores distance to the camera center
    along the ray; convert to planar depth (z along the optical axis):
    z = dist * f / sqrt(x^2 + y^2 + f^2) with (x, y) the pixel offsets
    from the image center (the standard apple/ml-hypersim recipe)."""
    h, w = dist_m.shape
    x = np.linspace(-0.5 * w + 0.5, 0.5 * w - 0.5, w, dtype=np.float32)
    y = np.linspace(-0.5 * h + 0.5, 0.5 * h - 0.5, h, dtype=np.float32)
    xx, yy = np.meshgrid(x, y)
    norm = np.sqrt(xx * xx + yy * yy + focal_px * focal_px)
    return dist_m * (focal_px / norm)


def _read_h5(path):
    with _h5py().File(path, "r") as fh:
        return np.asarray(fh["dataset"])


def prepare_hypersim(raw_root, out_dir, splits=("train", "valid", "test"),
                     subsample=None, max_scenes=None):
    """Convert the apple-hypersim raw download into the prepared layout.

    Reference: prepare_datasets.sh:48-57 (`nicr_sa_prepare_dataset
    hypersim ... --no-tilt-shift-conversion`); the L2 converter lives in
    the unvendored nicr_scene_analysis_datasets package, so this is an
    independent implementation of the documented raw layout:

      <raw>/metadata_images_split_scene_v1.csv   (official split)
      <raw>/<scene>/images/scene_<cam>_final_preview/frame.NNNN.tonemap.jpg
      <raw>/<scene>/images/scene_<cam>_geometry_hdf5/frame.NNNN.
          {depth_meters,semantic,semantic_instance,normal_cam}.hdf5

    Depth is converted from ray distance to planar z (see
    `_hypersim_planar_depth`) and stored as uint16 millimetres. Semantic
    is NYUv2-40 (-1 -> 0 void). Scene classes come from
    metadata_camera_trajectories.csv ('Scene type' column) when present.
    The reference's `--additional-subsamples 2 5 10 20` become load-time
    `PreparedDataset(subsample=N)` over the same sorted id order; an
    explicit `--subsample N` here writes every Nth frame instead.
    """
    import csv

    split_csv = os.path.join(raw_root, "metadata_images_split_scene_v1.csv")
    if not os.path.isfile(split_csv):
        raise FileNotFoundError(
            f"missing official split file: {split_csv}"
        )
    split_map = {"train": "train", "val": "valid", "test": "test"}
    rows = []
    with open(split_csv) as fh:
        for row in csv.DictReader(fh):
            if row.get("included_in_public_release", "True") not in (
                "True", "true", "1"
            ):
                continue
            split = split_map.get(
                row["split_partition_name"], row["split_partition_name"]
            )
            if split not in splits:
                continue
            rows.append((row["scene_name"], row["camera_name"],
                         int(row["frame_id"]), split))
    rows.sort()
    if max_scenes:
        keep = sorted({r[0] for r in rows})[:max_scenes]
        rows = [r for r in rows if r[0] in set(keep)]
    if subsample and subsample > 1:
        counters = {}
        kept = []
        for r in rows:
            k = counters.get(r[3], 0)
            counters[r[3]] = k + 1
            if k % subsample == 0:
                kept.append(r)
        rows = kept

    # scene types (metadata_camera_trajectories.csv: 'Animation' is
    # '<scene>_<cam>', 'Scene type' is e.g. 'living room')
    scene_type = {}
    traj_csv = os.path.join(raw_root, "metadata_camera_trajectories.csv")
    if os.path.isfile(traj_csv):
        with open(traj_csv) as fh:
            for row in csv.DictReader(fh):
                anim = row.get("Animation", "")
                stype = (row.get("Scene type") or "").strip().lower()
                if anim and stype:
                    scene_type[anim] = stype
    scene_names = sorted(set(scene_type.values()))

    n_written = 0
    for scene, cam, frame, split in rows:
        img_dir = os.path.join(raw_root, scene, "images")
        prev = os.path.join(img_dir, f"scene_{cam}_final_preview",
                            f"frame.{frame:04d}.tonemap.jpg")
        geom = os.path.join(img_dir, f"scene_{cam}_geometry_hdf5")
        dep_p = os.path.join(geom, f"frame.{frame:04d}.depth_meters.hdf5")
        sem_p = os.path.join(geom, f"frame.{frame:04d}.semantic.hdf5")
        ins_p = os.path.join(geom,
                             f"frame.{frame:04d}.semantic_instance.hdf5")
        nrm_p = os.path.join(geom, f"frame.{frame:04d}.normal_cam.hdf5")
        if not (os.path.isfile(prev) and os.path.isfile(dep_p)
                and os.path.isfile(sem_p)):
            continue
        sid = f"{scene}_{cam}_{frame:04d}"

        rgb = read_rgb(prev)
        _save_png(os.path.join(out_dir, split, "rgb", sid + ".png"), rgb)

        dist = _read_h5(dep_p).astype(np.float32)
        # hypersim renders at 1024x768 with f=886.81px; scale if resized
        focal = 886.81 * (dist.shape[1] / 1024.0)
        planar = _hypersim_planar_depth(np.nan_to_num(dist), focal)
        depth_mm = np.clip(planar * 1000.0, 0, 65535).astype(np.uint16)
        _save_png(os.path.join(out_dir, split, "depth", sid + ".png"),
                  depth_mm)

        sem = _read_h5(sem_p).astype(np.int32)
        sem = np.where(sem < 0, 0, sem)  # -1 -> void
        _save_png(os.path.join(out_dir, split, "semantic_40", sid + ".png"),
                  np.clip(sem, 0, 40).astype(np.uint8))

        if os.path.isfile(ins_p):
            inst = _read_h5(ins_p).astype(np.int32)
            inst = np.where(inst < 0, 0, inst)
            # remap to consecutive per-frame ids (fits uint16)
            uniq = np.unique(inst)
            uniq = uniq[uniq > 0]
            out = np.zeros_like(inst)
            for new_id, old in enumerate(uniq, start=1):
                out[inst == old] = new_id
            _save_png(os.path.join(out_dir, split, "instance",
                                   sid + ".png"), out.astype(np.uint16))

        if os.path.isfile(nrm_p):
            nrm = np.nan_to_num(_read_h5(nrm_p).astype(np.float32))
            enc = np.clip((nrm + 1.0) * 127.5, 0, 255).astype(np.uint8)
            _save_png(os.path.join(out_dir, split, "normal", sid + ".png"),
                      enc)

        stype = scene_type.get(f"{scene}_{cam}")
        if stype:
            sc_path = os.path.join(out_dir, split, "scene_class",
                                   sid + ".txt")
            os.makedirs(os.path.dirname(sc_path), exist_ok=True)
            with open(sc_path, "w") as fh:
                fh.write(str(scene_names.index(stype) + 1))  # 0 = void
        n_written += 1
        if n_written % 200 == 0:
            print(f"  {n_written} frames written...", flush=True)

    write_meta(out_dir, NYUV2_40, scene_names)
    print(f"done: {out_dir} ({n_written} frames)")


def _parse_sens(path):
    """Parse a ScanNet .sens RGB-D stream (documented public format:
    header with intrinsics + per-frame jpeg/png color and zlib'ed uint16
    depth). Yields (frame_idx, color_bytes, color_kind, depth_u16)."""
    import struct
    import zlib

    with open(path, "rb") as fh:
        def rd(fmt):
            size = struct.calcsize(fmt)
            return struct.unpack(fmt, fh.read(size))

        (version,) = rd("<I")
        if version != 4:
            raise ValueError(f".sens version {version} != 4: {path}")
        (strlen,) = rd("<Q")
        fh.read(strlen)  # sensor name
        fh.read(4 * 16 * 4)  # color/depth intrinsics + extrinsics (4x 4x4)
        (color_comp,) = rd("<i")
        (depth_comp,) = rd("<i")
        cw, ch, dw, dh = rd("<4I")
        (depth_shift,) = rd("<f")
        (num_frames,) = rd("<Q")
        color_kind = {0: "raw", 1: "png", 2: "jpeg"}.get(color_comp, "jpeg")
        for idx in range(num_frames):
            fh.read(16 * 4)  # camera_to_world
            fh.read(8 + 8)  # timestamps
            (color_size,) = rd("<Q")
            (depth_size,) = rd("<Q")
            color_bytes = fh.read(color_size)
            depth_bytes = fh.read(depth_size)
            if depth_comp == 1:  # zlib_ushort
                depth_bytes = zlib.decompress(depth_bytes)
            depth = np.frombuffer(depth_bytes, "<u2").reshape(dh, dw)
            # depth_shift converts stored units to mm when it is not 1000
            if depth_shift and depth_shift != 1000.0:
                depth = np.clip(
                    depth.astype(np.float64) * (1000.0 / depth_shift),
                    0, 65535,
                ).astype(np.uint16)
            yield idx, color_bytes, color_kind, depth


def _scannet_label_map(tsv_path):
    """scannetv2-labels.combined.tsv: raw label id -> nyu40 id."""
    import csv

    mapping = {0: 0}
    with open(tsv_path) as fh:
        for row in csv.DictReader(fh, delimiter="\t"):
            try:
                mapping[int(row["id"])] = int(row["nyu40id"] or 0)
            except (KeyError, ValueError):
                continue
    return mapping


def prepare_scannet(raw_root, out_dir, splits=("train", "valid"),
                    subsample=50, max_scenes=None):
    """Convert the raw ScanNet v2 download into the prepared layout.

    Reference: the L2 `nicr_sa_prepare_dataset scannet` CLI (unvendored;
    SURVEY.md D6) — independent implementation of the documented raw
    distribution:

      <raw>/scannetv2-labels.combined.tsv       raw-id -> nyu40 mapping
      <raw>/scannetv2_{train,val}.txt           official scene splits
      <raw>/scans/<scene>/<scene>.sens          RGB-D stream (v4)
      <raw>/scans/<scene>/<scene>_2d-label-filt.zip     label-filt/N.png
      <raw>/scans/<scene>/<scene>_2d-instance-filt.zip  instance-filt/N.png
      <raw>/scans/<scene>/<scene>.txt           sceneType = <name>

    Every `subsample`-th frame is exported (ScanNet ~2.5M frames total;
    the reference trains with --subsample 50/100, args.py:887-896). Color
    + labels are resampled to the depth resolution (the 640x480 geometric
    reference). Semantic is stored in the NYUv2-40 space; the 40->20
    benchmark remap stays a load-time preprocessing step
    (emsanet_tpu/datasets/scannet.py).
    """
    import zipfile

    tsv = os.path.join(raw_root, "scannetv2-labels.combined.tsv")
    label_map_arr = None
    if os.path.isfile(tsv):
        m = _scannet_label_map(tsv)
        label_map_arr = np.zeros(max(m) + 1, np.uint8)
        for k, v in m.items():
            label_map_arr[k] = v if 0 <= v <= 40 else 0

    split_files = {"train": "scannetv2_train.txt",
                   "valid": "scannetv2_val.txt",
                   "test": "scannetv2_test.txt"}
    scene_types = []
    n_written = 0
    for split in splits:
        lst = os.path.join(raw_root, split_files.get(split, ""))
        if not os.path.isfile(lst):
            print(f"[scannet] no split list {lst}; skipping {split}")
            continue
        with open(lst) as fh:
            scenes = [ln.strip() for ln in fh if ln.strip()]
        if max_scenes:
            scenes = scenes[:max_scenes]
        scans_dir = "scans_test" if split == "test" else "scans"
        for scene in scenes:
            sdir = os.path.join(raw_root, scans_dir, scene)
            sens = os.path.join(sdir, scene + ".sens")
            if not os.path.isfile(sens):
                continue

            def zopen(suffix, inner):
                z = os.path.join(sdir, scene + suffix)
                if os.path.isfile(z):
                    zf = zipfile.ZipFile(z)
                    names = {}
                    for n in zf.namelist():
                        base = os.path.basename(n)
                        if base.endswith(".png") and inner in n:
                            names[os.path.splitext(base)[0]] = n
                    return zf, names
                return None, {}

            zl, lnames = zopen("_2d-label-filt.zip", "label-filt")
            zi, inames = zopen("_2d-instance-filt.zip", "instance-filt")

            stype = None
            meta_txt = os.path.join(sdir, scene + ".txt")
            if os.path.isfile(meta_txt):
                with open(meta_txt) as fh:
                    for ln in fh:
                        if ln.startswith("sceneType"):
                            stype = ln.split("=", 1)[1].strip().lower()
            if stype and stype not in scene_types:
                scene_types.append(stype)

            for idx, color_bytes, kind, depth in _parse_sens(sens):
                if idx % subsample:
                    continue
                sid = f"{scene}_{idx:06d}"
                dh, dw = depth.shape
                rgb = decode_image(color_bytes, f"{sens} frame {idx}",
                                   rgb=True)
                if rgb.shape[:2] != (dh, dw):
                    rgb = imaging.resize_bilinear_u8(rgb, dh, dw)
                _save_png(os.path.join(out_dir, split, "rgb",
                                       sid + ".png"), rgb)
                _save_png(os.path.join(out_dir, split, "depth",
                                       sid + ".png"), depth)

                def read_mask(zf, names):
                    n = names.get(str(idx))
                    if zf is None or n is None:
                        return None
                    arr = decode_image(zf.read(n), n)
                    if arr.shape != (dh, dw):
                        arr = imaging.resize_nearest(arr, dh, dw)
                    return arr

                lab = read_mask(zl, lnames)
                if lab is not None and label_map_arr is not None:
                    in_range = lab < len(label_map_arr)
                    sem = np.where(
                        in_range,
                        label_map_arr[np.where(in_range, lab, 0)],
                        0,  # ids beyond the tsv table -> void
                    ).astype(np.uint8)
                    _save_png(os.path.join(out_dir, split, "semantic_40",
                                           sid + ".png"), sem)
                inst = read_mask(zi, inames)
                if inst is not None:
                    _save_png(
                        os.path.join(out_dir, split, "instance",
                                     sid + ".png"),
                        inst.astype(np.uint16),
                    )
                if stype:
                    sc = os.path.join(out_dir, split, "scene_class",
                                      sid + ".txt")
                    os.makedirs(os.path.dirname(sc), exist_ok=True)
                    with open(sc, "w") as fh:
                        fh.write(stype)
                n_written += 1
                if n_written % 500 == 0:
                    print(f"  {n_written} frames written...", flush=True)
            if zl:
                zl.close()
            if zi:
                zi.close()

    write_meta(out_dir, NYUV2_40, sorted(scene_types))
    print(f"done: {out_dir} ({n_written} frames)")


# Cityscapes labelId -> trainId (standard 19-class benchmark subset);
# stored as trainId+1 with 0 = void, matching datasets/metadata.py order
_CITYSCAPES_LABEL_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
    22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
    32: 17, 33: 18,
}
# stereo rig constants for disparity -> depth (baseline m * focal px)
_CITYSCAPES_BF = 0.209313 * 2262.52


def prepare_cityscapes(raw_root, out_dir, splits=("train", "valid"),
                       max_frames=None, depth_scale=100.0):
    """Convert the raw Cityscapes download into the prepared layout.

    Reference: the L2 `nicr_sa_prepare_dataset cityscapes` CLI
    (unvendored; SURVEY.md D2/D6) — independent implementation of the
    documented raw distribution:

      <raw>/leftImg8bit/{train,val,test}/<city>/<id>_leftImg8bit.png
      <raw>/gtFine/{train,val}/<city>/<id>_gtFine_labelIds.png
      <raw>/gtFine/{train,val}/<city>/<id>_gtFine_instanceIds.png
      <raw>/disparity/{train,val}/<city>/<id>_disparity.png

    Semantic: labelIds -> the 19 train classes (+1, 0 = void). Instance:
    instanceIds >= 1000 (thing pixels) -> consecutive per-frame ids.
    Depth: disparity p -> d = (p - 1) / 256 px -> depth = B*f/d meters,
    stored as uint16 centimetres (`depth_scale`=100/m); real stats land
    in meta.json and override the built-ins at load time.
    """
    split_map = {"train": "train", "valid": "val", "test": "test"}
    map_arr = np.zeros(64, np.uint8)
    for k, v in _CITYSCAPES_LABEL_TO_TRAIN.items():
        map_arr[k] = v + 1

    n_written = 0
    for split in splits:
        raw_split = split_map.get(split, split)
        img_root = os.path.join(raw_root, "leftImg8bit", raw_split)
        if not os.path.isdir(img_root):
            print(f"[cityscapes] no {img_root}; skipping {split}")
            continue
        for city in sorted(os.listdir(img_root)):
            cdir = os.path.join(img_root, city)
            if not os.path.isdir(cdir):
                continue
            for f in sorted(os.listdir(cdir)):
                if not f.endswith("_leftImg8bit.png"):
                    continue
                if max_frames and n_written >= max_frames:
                    break
                sid = f[: -len("_leftImg8bit.png")]
                rgb = read_rgb(os.path.join(cdir, f))
                _save_png(os.path.join(out_dir, split, "rgb",
                                       sid + ".png"), rgb)

                gt_dir = os.path.join(raw_root, "gtFine", raw_split, city)
                lab_p = os.path.join(gt_dir, sid + "_gtFine_labelIds.png")
                if os.path.isfile(lab_p):
                    lab = read_png(lab_p)
                    sem = map_arr[np.clip(lab, 0, 63)]
                    _save_png(os.path.join(out_dir, split, "semantic_19",
                                           sid + ".png"), sem)
                ins_p = os.path.join(gt_dir,
                                     sid + "_gtFine_instanceIds.png")
                if os.path.isfile(ins_p):
                    raw_inst = read_png(ins_p).astype(np.int32)
                    inst_pix = np.where(raw_inst >= 1000, raw_inst, 0)
                    uniq = np.unique(inst_pix)
                    uniq = uniq[uniq > 0]
                    out = np.zeros_like(inst_pix)
                    for new_id, old in enumerate(uniq, start=1):
                        out[inst_pix == old] = new_id
                    _save_png(
                        os.path.join(out_dir, split, "instance",
                                     sid + ".png"),
                        out.astype(np.uint16),
                    )
                disp_p = os.path.join(raw_root, "disparity", raw_split,
                                      city, sid + "_disparity.png")
                if os.path.isfile(disp_p):
                    p = read_png(disp_p).astype(np.float32)
                    disp = np.where(p > 0, (p - 1.0) / 256.0, 0.0)
                    depth_m = np.where(disp > 0,
                                       _CITYSCAPES_BF / np.maximum(disp,
                                                                   1e-6),
                                       0.0)
                    depth = np.clip(depth_m * depth_scale, 0,
                                    65535).astype(np.uint16)
                    _save_png(os.path.join(out_dir, split, "depth",
                                           sid + ".png"), depth)
                n_written += 1
                if n_written % 200 == 0:
                    print(f"  {n_written} frames written...", flush=True)

    write_meta(out_dir, *_label_entries(get_dataset_config("cityscapes")))
    print(f"done: {out_dir} ({n_written} frames)")


def prepare_coco(raw_root, out_dir, splits=("train", "valid"),
                 max_frames=None):
    """Convert COCO panoptic annotations into the prepared layout.

    Reference: the L2 `nicr_sa_prepare_dataset coco` CLI (unvendored;
    SURVEY.md D2). Works directly on the documented panoptic release (no
    pycocotools needed):

      <raw>/{train,val}2017/<img>.jpg
      <raw>/annotations/panoptic_{train,val}2017.json
      <raw>/annotations/panoptic_{train,val}2017/<img>.png

    Segment PNGs encode ids as R + 256*G + 65536*B. The sparse COCO
    category ids map to a contiguous 1..133 space (order = categories
    sorted by id); real names + isthing flags land in meta.json, which
    overrides the built-in placeholder tables at load time. Thing
    segments (not iscrowd) become consecutive per-image instance ids;
    COCO has no depth (RGB-only pretraining in the reference).
    """
    import shutil

    split_map = {"train": "train2017", "valid": "val2017",
                 "test": "test2017"}
    cat_entries = None
    cat_to_class = {}
    n_written = 0
    for split in splits:
        raw_split = split_map.get(split, split)
        ann_json = os.path.join(raw_root, "annotations",
                                f"panoptic_{raw_split}.json")
        seg_dir = os.path.join(raw_root, "annotations",
                               f"panoptic_{raw_split}")
        img_dir = os.path.join(raw_root, raw_split)
        if not os.path.isfile(ann_json):
            print(f"[coco] no {ann_json}; skipping {split}")
            continue
        with open(ann_json) as fh:
            ann = json.load(fh)
        if cat_entries is None:
            cats = sorted(ann["categories"], key=lambda c: c["id"])
            cat_to_class = {c["id"]: i + 1 for i, c in enumerate(cats)}
            cat_isthing = {
                c["id"]: bool(c.get("isthing", 1)) for c in cats
            }
            cat_entries = tuple(
                (c["name"], bool(c.get("isthing", 1)), False)
                for c in cats
            )
        images_by_id = {im["id"]: im for im in ann.get("images", [])}
        for a in ann["annotations"]:
            if max_frames and n_written >= max_frames:
                break
            im = images_by_id.get(a["image_id"], {})
            img_name = im.get("file_name",
                              a["file_name"].replace(".png", ".jpg"))
            sid = os.path.splitext(img_name)[0]
            src_img = os.path.join(img_dir, img_name)
            seg_png = os.path.join(seg_dir, a["file_name"])
            if not (os.path.isfile(src_img) and os.path.isfile(seg_png)):
                continue
            dst = os.path.join(out_dir, split, "rgb", img_name)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(src_img, dst)

            seg_rgb = read_rgb(seg_png)
            seg_id = (
                seg_rgb[..., 0].astype(np.int32)
                + seg_rgb[..., 1].astype(np.int32) * 256
                + seg_rgb[..., 2].astype(np.int32) * 65536
            )
            semantic = np.zeros(seg_id.shape, np.uint8)
            instance = np.zeros(seg_id.shape, np.uint16)
            next_inst = 1
            for s in a["segments_info"]:
                mask = seg_id == s["id"]
                cls = cat_to_class.get(s["category_id"], 0)
                semantic[mask] = cls
                if cat_isthing.get(s["category_id"], True) and not s.get(
                    "iscrowd", 0
                ):
                    instance[mask] = next_inst
                    next_inst += 1
            _save_png(
                os.path.join(out_dir, split,
                             f"semantic_{len(cat_entries)}",
                             sid + ".png"),
                semantic,
            )
            _save_png(os.path.join(out_dir, split, "instance",
                                   sid + ".png"), instance)
            n_written += 1
            if n_written % 500 == 0:
                print(f"  {n_written} images written...", flush=True)

    if cat_entries:
        write_meta(out_dir, cat_entries, ())
    print(f"done: {out_dir} ({n_written} images)")


# --------------------------------------------------------------------------
# SceneNetRGBD


def _pb_read_varint(buf, i):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _pb_fields(buf):
    """Decode one protobuf message into {field_number: [raw values]}.

    Generic wire-format decode (the format itself is a stable public
    standard): varints stay ints, fixed32/64 stay raw bytes, and
    length-delimited values stay bytes for the caller to interpret
    (nested message vs. string). Raises on malformed input, so callers
    can probe "is this a submessage?" with try/except.
    """
    out = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _pb_read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if field == 0:
            raise ValueError("field 0 is invalid")
        if wt == 0:
            val, i = _pb_read_varint(buf, i)
        elif wt == 1:
            val = bytes(buf[i:i + 8])
            i += 8
        elif wt == 2:
            ln, i = _pb_read_varint(buf, i)
            if i + ln > n:
                raise ValueError("length-delimited field overruns buffer")
            val = bytes(buf[i:i + ln])
            i += ln
        elif wt == 5:
            val = bytes(buf[i:i + 4])
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if wt in (1, 5) and len(val) < (8 if wt == 1 else 4):
            raise ValueError("truncated fixed field")
        out.setdefault(field, []).append(val)
    return out


def _pb_text(val):
    """bytes -> str if it looks like text, else None."""
    if not isinstance(val, bytes) or not val:
        return None
    try:
        s = val.decode("ascii")
    except UnicodeDecodeError:
        return None
    if all(32 <= ord(c) < 127 for c in s):
        return s
    return None


import re as _re

_WNID_RE = _re.compile(r"^\d{8}$")
_PATH_RE = _re.compile(r"^[\w./-]+$")

# NYU 13-class indoor segmentation (SceneNet's semantic space; the L2
# `nicr_scene_analysis_datasets` SceneNetRGBD dataset uses these 13
# classes + void). Order is the standard alphabetical NYU13 order.
SCENENET_NYU13 = (
    # (name, is_thing, use_orientations)
    ("bed", True, False),
    ("books", True, False),
    ("ceiling", False, False),
    ("chair", True, False),
    ("floor", False, False),
    ("furniture", True, False),
    ("objects", True, False),
    ("picture", True, False),
    ("sofa", True, False),
    ("table", True, False),
    ("tv", True, False),
    ("wall", False, False),
    ("window", False, False),
)
_NYU13_INDEX = {name: i + 1 for i, (name, _, _) in enumerate(SCENENET_NYU13)}

# WordNet-id -> NYU13 class for common SceneNet furniture wnids. The
# canonical full table ships with pySceneNetRGBD (not vendorable in this
# offline environment); `--wnid-map` accepts it as a CSV. Everything not
# covered falls back to the english-name keyword map below (the .pb
# carries `semantic_english` alongside the wnid).
_WNID_TO_NYU13 = {
    "02818832": "bed",
    "03001627": "chair",
    "04256520": "sofa",
    "04379243": "table",
    "02933112": "furniture",   # cabinet
    "03636649": "objects",     # lamp
    "03938244": "objects",     # pillow
    "02773838": "objects",     # bag
}

_ENGLISH_TO_NYU13 = (
    # (keyword, class); first match wins, matched on word boundaries
    ("bed", "bed"), ("mattress", "bed"), ("headboard", "bed"),
    ("book", "books"), ("magazine", "books"),
    ("ceiling", "ceiling"),
    ("chair", "chair"), ("stool", "chair"), ("seat", "chair"),
    ("bench", "chair"),
    ("floor", "floor"), ("carpet", "floor"), ("rug", "floor"),
    ("mat", "floor"),
    ("cabinet", "furniture"), ("cupboard", "furniture"),
    ("wardrobe", "furniture"), ("dresser", "furniture"),
    ("shelf", "furniture"), ("shelves", "furniture"),
    ("bookcase", "furniture"), ("drawer", "furniture"),
    ("chest", "furniture"), ("nightstand", "furniture"),
    ("counter", "furniture"), ("furniture", "furniture"),
    ("picture", "picture"), ("painting", "picture"),
    ("photo", "picture"), ("poster", "picture"), ("frame", "picture"),
    ("sofa", "sofa"), ("couch", "sofa"),
    ("table", "table"), ("desk", "table"),
    ("tv", "tv"), ("television", "tv"), ("monitor", "tv"),
    ("screen", "tv"), ("display", "tv"),
    ("wall", "wall"), ("door", "wall"),
    ("window", "window"), ("curtain", "window"), ("blind", "window"),
)


def _classify_wnid(wnid, english, wnid_map):
    if wnid and wnid in wnid_map:
        name = wnid_map[wnid]
        return _NYU13_INDEX.get(name, 0)
    if english:
        words = _re.split(r"[^a-z]+", english.lower())
        for kw, cls in _ENGLISH_TO_NYU13:
            if kw in words:
                return _NYU13_INDEX[cls]
    return 0  # void


def _parse_scenenet_instance(msg):
    """(instance_id, wnid, english) from a decoded Instance message.

    pySceneNetRGBD schema (scenenet.proto): instance_id=1,
    instance_type=2, semantic_wordnet_id=3, semantic_english=4. Fields
    are found structurally: the lowest-numbered varint is the id, an
    8-digit string is the wordnet id, any other text is the name — so a
    re-numbered schema still parses as long as the field kinds exist.
    """
    int_fields = sorted(
        f for f, vals in msg.items()
        if any(isinstance(v, int) for v in vals)
    )
    if not int_fields:
        return None
    inst_id = next(
        v for v in msg[int_fields[0]] if isinstance(v, int)
    )
    wnid = english = None
    for vals in msg.values():
        for v in vals:
            s = _pb_text(v)
            if s is None:
                continue
            if _WNID_RE.match(s):
                wnid = s
            elif _re.search(r"[a-zA-Z]", s):
                english = s
    return inst_id, wnid, english


def _parse_scenenet_pb(pb_path):
    """Yield (render_path, {instance_id: nyu13_class_args}) per trajectory.

    Returns a list of (render_path, [(inst_id, wnid, english), ...]).
    Trajectories/instances are identified structurally (see
    `_parse_scenenet_instance`); views (frame poses) carry no text fields
    and are skipped automatically.
    """
    with open(pb_path, "rb") as fh:
        top = _pb_fields(fh.read())
    trajectories = []
    for vals in top.values():
        for v in vals:
            if not isinstance(v, bytes):
                continue
            try:
                traj = _pb_fields(v)
            except ValueError:
                continue
            render_path = None
            instances = []
            for tvals in traj.values():
                for tv in tvals:
                    if not isinstance(tv, bytes):
                        continue
                    s = _pb_text(tv)
                    if s is not None and "/" in s and _PATH_RE.match(s):
                        render_path = s
                        continue
                    try:
                        sub = _pb_fields(tv)
                    except ValueError:
                        continue
                    if not any(
                        _pb_text(x) is not None and
                        _re.search(r"[a-zA-Z0-9]", _pb_text(x))
                        for xs in sub.values() for x in xs
                        if isinstance(x, bytes)
                    ):
                        continue  # views/poses: no text payload
                    parsed = _parse_scenenet_instance(sub)
                    if parsed is not None:
                        instances.append(parsed)
            if render_path is not None:
                trajectories.append((render_path, instances))
    return trajectories


def prepare_scenenetrgbd(raw_root, out_dir, splits=("train", "valid"),
                         subsample=None, max_trajectories=None,
                         wnid_map_csv=None):
    """Convert raw SceneNetRGBD into the prepared layout.

    Reference: the L2 `nicr_sa_prepare_dataset scenenetrgbd` CLI family
    (SURVEY.md D6; the reference's `prepare_datasets.sh` pattern). Raw
    layout (as distributed by the SceneNet RGB-D project):

      <raw>/<split>/<batch>/<traj>/photo/<frame>.jpg     RGB
      <raw>/<split>/<batch>/<traj>/depth/<frame>.png     uint16 mm
      <raw>/<split>/<batch>/<traj>/instance/<frame>.png  uint16 ids
      <raw>/scenenet_rgbd_<split>.pb                     trajectory meta

    The .pb is protobuf (pySceneNetRGBD's scenenet.proto, whose compiled
    schema is not vendorable offline) — it is decoded with a generic
    wire-format reader and structural field identification
    (`_parse_scenenet_pb`). Per trajectory, instance ids map to NYU13
    semantic classes via wordnet id (built-in subset or `--wnid-map`
    CSV rows `wnid,nyu13_name`) with an english-name keyword fallback;
    unmapped instances become void. Semantic maps are derived as
    `class_of_instance[instance_map]`; depth (already uint16 mm) and
    photos are copied through.
    """
    import shutil

    wnid_map = dict(_WNID_TO_NYU13)
    if wnid_map_csv:
        with open(wnid_map_csv) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                wnid, name = [p.strip() for p in line.split(",")[:2]]
                wnid_map[wnid] = name
    split_aliases = {"valid": ("valid", "val"), "train": ("train",),
                     "test": ("test",)}
    n_written = 0
    unmapped = {}
    for split in splits:
        pb_path = None
        raw_split_dir = None
        for alias in split_aliases.get(split, (split,)):
            cand = os.path.join(raw_root, f"scenenet_rgbd_{alias}.pb")
            # train ships sharded: scenenet_rgbd_train_0.pb ...
            shards = sorted(
                f for f in os.listdir(raw_root)
                if f.startswith(f"scenenet_rgbd_{alias}")
                and f.endswith(".pb")
            ) if os.path.isdir(raw_root) else []
            if os.path.isfile(cand):
                shards = [os.path.basename(cand)]
            if shards and os.path.isdir(os.path.join(raw_root, alias)):
                pb_path = [os.path.join(raw_root, s) for s in shards]
                raw_split_dir = os.path.join(raw_root, alias)
                break
        if pb_path is None:
            print(f"[scenenetrgbd] no .pb + image dir for '{split}'; "
                  "skipping")
            continue
        trajectories = []
        for p in pb_path:
            trajectories.extend(_parse_scenenet_pb(p))
        if max_trajectories:
            trajectories = trajectories[:max_trajectories]
        print(f"[scenenetrgbd] {split}: {len(trajectories)} trajectories")
        for render_path, instances in trajectories:
            # render_path is '<batch>/<traj>' relative to the split dir
            traj_dir = os.path.join(raw_split_dir, render_path)
            photo_dir = os.path.join(traj_dir, "photo")
            if not os.path.isdir(photo_dir):
                print(f"  missing {photo_dir}; skipping trajectory")
                continue
            # instance-id -> class lookup table
            max_id = max((i for i, _, _ in instances), default=0)
            lut = np.zeros(max(max_id + 1, 1), np.uint8)
            for inst_id, wnid, english in instances:
                cls = _classify_wnid(wnid, english, wnid_map)
                if cls == 0:
                    unmapped[(wnid, english)] = (
                        unmapped.get((wnid, english), 0) + 1
                    )
                if 0 <= inst_id <= max_id:
                    lut[inst_id] = cls
            frames = sorted(
                os.listdir(photo_dir),
                key=lambda f: int(os.path.splitext(f)[0]),
            )
            if subsample:
                frames = frames[::subsample]
            sid_prefix = render_path.replace("/", "_")
            for frame in frames:
                fid = os.path.splitext(frame)[0]
                sid = f"{sid_prefix}_{fid}"
                inst_png = os.path.join(traj_dir, "instance", fid + ".png")
                depth_png = os.path.join(traj_dir, "depth", fid + ".png")
                if not (os.path.isfile(inst_png)
                        and os.path.isfile(depth_png)):
                    continue
                dst_rgb = os.path.join(
                    out_dir, split, "rgb",
                    sid + os.path.splitext(frame)[1],
                )
                os.makedirs(os.path.dirname(dst_rgb), exist_ok=True)
                shutil.copyfile(os.path.join(photo_dir, frame), dst_rgb)
                depth = read_png(depth_png).astype(np.uint16)
                _save_png(os.path.join(out_dir, split, "depth",
                                       sid + ".png"), depth)
                inst = read_png(inst_png).astype(np.int64)
                semantic = lut[np.clip(inst, 0, max_id)].astype(np.uint8)
                _save_png(
                    os.path.join(out_dir, split, "semantic_13",
                                 sid + ".png"), semantic)
                _save_png(
                    os.path.join(out_dir, split, "instance", sid + ".png"),
                    np.clip(inst, 0, 65535).astype(np.uint16))
                n_written += 1
                if n_written % 500 == 0:
                    print(f"  {n_written} frames written...", flush=True)
    if unmapped:
        top = sorted(unmapped.items(), key=lambda kv: -kv[1])[:15]
        print("[scenenetrgbd] unmapped labels -> void "
              "(pass --wnid-map to refine):")
        for (wnid, english), cnt in top:
            print(f"  {wnid or '--------'} {english or '?'}: {cnt}")
    write_meta(out_dir, SCENENET_NYU13, ())
    print(f"done: {out_dir} ({n_written} frames)")


def _label_entries(config):
    """(semantic entries without void, scene names without void) of a
    dataset's built-in tables, for `write_meta`."""
    semantic = tuple(zip(config.semantic_class_names,
                         config.classes_is_thing,
                         config.classes_use_orientations))[1:]
    return semantic, config.scene_class_names[1:]


def prepare_synthetic(out_dir, n_train, n_test, height, width):
    from emsanet_tpu_torch.datasets.synthetic import SyntheticDataset

    for split, count in (("train", n_train), ("test", n_test)):
        ds = SyntheticDataset(
            split=split, n_samples=count, height=height, width=width,
            sample_keys=("identifier", "rgb", "depth", "semantic",
                         "instance", "orientations", "scene"),
        )
        base = os.path.join(out_dir, split)
        for i in range(count):
            s = ds.load_raw(i)
            sid = f"{i:04d}"
            _save_png(os.path.join(base, "rgb", f"{sid}.png"), s["rgb"])
            _save_png(
                os.path.join(base, "depth", f"{sid}.png"),
                np.clip(s["depth"], 0, 65535).astype(np.uint16),
            )
            _save_png(
                os.path.join(base, "semantic_40", f"{sid}.png"),
                s["semantic"].astype(np.uint8),
            )
            _save_png(
                os.path.join(base, "instance", f"{sid}.png"),
                s["instance"].astype(np.uint16),
            )
            os.makedirs(os.path.join(base, "orientations"), exist_ok=True)
            with open(
                os.path.join(base, "orientations", f"{sid}.json"), "w"
            ) as fh:
                json.dump({str(k): v for k, v in s["orientations"].items()},
                          fh)
            os.makedirs(os.path.join(base, "scene_class"), exist_ok=True)
            with open(
                os.path.join(base, "scene_class", f"{sid}.txt"), "w"
            ) as fh:
                fh.write(str(s["scene"]))
        print(f"wrote {count} {split} samples")

    write_meta(out_dir, *_label_entries(get_dataset_config("synthetic")))
    print(f"done: {out_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="dataset", required=True)

    p_nyu = sub.add_parser("nyuv2")
    p_nyu.add_argument("--mat", required=True,
                       help="nyu_depth_v2_labeled.mat")
    p_nyu.add_argument("--splits", default=None, help="splits.mat")
    p_nyu.add_argument("--class-mapping", default=None,
                       help="classMapping40.mat (894->40)")
    p_nyu.add_argument("--out", required=True)

    p_sun = sub.add_parser("sunrgbd")
    p_sun.add_argument("--toolbox-root", required=True,
                       help="SUNRGBD toolbox root (contains kv1/kv2/... and "
                       "traintestSUNRGBD/allsplit.mat)")
    p_sun.add_argument("--out", required=True)
    p_sun.add_argument("--instances-version", default="emsanet",
                       choices=("emsanet", "segments"),
                       help="'emsanet': instances from projected 3D boxes "
                       "(reference prepare_datasets.sh:10-19); 'segments': "
                       "from seg.mat segment labels")

    p_hyp = sub.add_parser("hypersim")
    p_hyp.add_argument("--raw", required=True,
                       help="apple-hypersim download root (contains "
                       "metadata_images_split_scene_v1.csv and ai_* dirs)")
    p_hyp.add_argument("--out", required=True)
    p_hyp.add_argument("--subsample", type=int, default=None,
                       help="write every Nth frame per split")
    p_hyp.add_argument("--max-scenes", type=int, default=None)

    p_scn = sub.add_parser("scannet")
    p_scn.add_argument("--raw", required=True,
                       help="ScanNet v2 download root (scans/, "
                       "scannetv2_train.txt, scannetv2-labels.combined.tsv)")
    p_scn.add_argument("--out", required=True)
    p_scn.add_argument("--subsample", type=int, default=50,
                       help="export every Nth frame (args.py:887-896)")
    p_scn.add_argument("--max-scenes", type=int, default=None)

    p_coco = sub.add_parser("coco")
    p_coco.add_argument("--raw", required=True,
                        help="COCO root (train2017/, annotations/"
                        "panoptic_*.json + PNG dirs)")
    p_coco.add_argument("--out", required=True)
    p_coco.add_argument("--max-frames", type=int, default=None)

    p_cs = sub.add_parser("cityscapes")
    p_cs.add_argument("--raw", required=True,
                      help="Cityscapes root (leftImg8bit/, gtFine/, "
                      "disparity/)")
    p_cs.add_argument("--out", required=True)
    p_cs.add_argument("--max-frames", type=int, default=None)

    p_sn = sub.add_parser("scenenetrgbd")
    p_sn.add_argument("--raw", required=True,
                      help="SceneNetRGBD root (train/ val/ dirs + "
                      "scenenet_rgbd_*.pb trajectory protobufs)")
    p_sn.add_argument("--out", required=True)
    p_sn.add_argument("--subsample", type=int, default=None,
                      help="write every Nth frame per trajectory")
    p_sn.add_argument("--max-trajectories", type=int, default=None)
    p_sn.add_argument("--wnid-map", default=None,
                      help="CSV 'wnid,nyu13_name' rows overriding/extending "
                      "the built-in WordNet-id mapping (e.g. derived from "
                      "pySceneNetRGBD)")

    p_syn = sub.add_parser("synthetic")
    p_syn.add_argument("--out", required=True)
    p_syn.add_argument("--n-train", type=int, default=16)
    p_syn.add_argument("--n-test", type=int, default=8)
    p_syn.add_argument("--height", type=int, default=480)
    p_syn.add_argument("--width", type=int, default=640)

    ns = parser.parse_args(argv)
    if ns.dataset == "nyuv2":
        prepare_nyuv2(ns.mat, ns.splits, ns.class_mapping, ns.out)
    elif ns.dataset == "sunrgbd":
        prepare_sunrgbd(ns.toolbox_root, ns.out,
                        instances_version=ns.instances_version)
    elif ns.dataset == "hypersim":
        prepare_hypersim(ns.raw, ns.out, subsample=ns.subsample,
                         max_scenes=ns.max_scenes)
    elif ns.dataset == "scannet":
        prepare_scannet(ns.raw, ns.out, subsample=ns.subsample,
                        max_scenes=ns.max_scenes)
    elif ns.dataset == "cityscapes":
        prepare_cityscapes(ns.raw, ns.out, max_frames=ns.max_frames)
    elif ns.dataset == "coco":
        prepare_coco(ns.raw, ns.out, max_frames=ns.max_frames)
    elif ns.dataset == "scenenetrgbd":
        prepare_scenenetrgbd(
            ns.raw, ns.out, subsample=ns.subsample,
            max_trajectories=ns.max_trajectories,
            wnid_map_csv=ns.wnid_map,
        )
    elif ns.dataset == "synthetic":
        prepare_synthetic(ns.out, ns.n_train, ns.n_test, ns.height, ns.width)
    return 0


if __name__ == "__main__":
    sys.exit(main())
