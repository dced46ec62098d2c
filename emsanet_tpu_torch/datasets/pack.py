"""Pack a prepared dataset split into memory-mapped raw binaries.

A copy of `tools/pack_dataset.py` that decodes with the port's own PNG
reader (`datasets/png.py`): one contiguous little-endian binary per
modality and a JSON index (ids, dtypes, shapes, offsets, and the
orientations and scene files inlined), which `PreparedDataset` maps
instead of decoding PNGs:

    <root>/<split>/packed/<modality>.bin
    <root>/<split>/packed/index.json

    python -m emsanet_tpu_torch.datasets.pack <prepared_root> [--splits train test]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from emsanet_tpu_torch.datasets.png import read_png

# modality -> canonical on-disk dtype (matches PreparedDataset._load inputs)
_DTYPES = {
    "rgb": np.uint8,
    "depth": np.uint16,
    "semantic": np.uint16,
    "instance": np.uint16,
    "normal": np.uint8,
}
_DIR_CANDIDATES = {
    "rgb": ("rgb",),
    "depth": ("depth", "depth_raw"),
    "semantic": None,  # resolved by prefix scan (semantic_N/labels_N)
    "instance": ("instance", "instances"),
    "normal": ("normal", "normals"),
}


def _find_modality_dirs(split_dir: str):
    """Return {packed_name: dir_path}; semantic dirs keep their real name
    (semantic_40 etc.) so multiple class counts can coexist."""
    out = {}
    entries = set(os.listdir(split_dir))
    for name, cands in _DIR_CANDIDATES.items():
        if cands is None:
            continue
        for c in cands:
            if c in entries and os.path.isdir(os.path.join(split_dir, c)):
                out[name if name != "depth" else c] = os.path.join(
                    split_dir, c
                )
                if name != "depth":  # pack both depth and depth_raw
                    break
    for e in sorted(entries):
        full = os.path.join(split_dir, e)
        if os.path.isdir(full) and (
            e.startswith("semantic") or e.startswith("labels")
        ):
            out[e] = full
    return out


def _dtype_for(packed_name: str) -> np.dtype:
    base = packed_name.split("_")[0]
    base = {"labels": "semantic", "depth": "depth", "instances": "instance",
            "normals": "normal"}.get(base, base)
    return np.dtype(_DTYPES.get(base, np.uint16))


def pack_split(root: str, split: str, force: bool = False) -> bool:
    split_dir = os.path.join(root, split)
    rgb_dir = os.path.join(split_dir, "rgb")
    if not os.path.isdir(rgb_dir):
        return False
    out_dir = os.path.join(split_dir, "packed")
    index_path = os.path.join(out_dir, "index.json")
    if os.path.isfile(index_path) and not force:
        print(f"[{split}] already packed (use --force to redo)")
        return True
    os.makedirs(out_dir, exist_ok=True)

    exts = {}
    for f in sorted(os.listdir(rgb_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in (".png", ".jpg", ".jpeg"):
            exts[stem] = ext
    ids = sorted(exts)

    modal_dirs = _find_modality_dirs(split_dir)
    index = {"ids": ids, "modalities": {}}
    for packed_name, d in modal_dirs.items():
        dtype = _dtype_for(packed_name)
        bin_path = os.path.join(out_dir, packed_name + ".bin")
        shapes, offsets = [], []
        off = 0
        with open(bin_path, "wb") as out:
            for sid in ids:
                ext = exts[sid] if packed_name == "rgb" else ".png"
                path = os.path.join(d, sid + ext)
                arr = read_png(path)
                if packed_name == "rgb":
                    if arr.ndim == 2:
                        arr = np.stack([arr] * 3, axis=-1)
                    arr = arr[..., :3]
                arr = np.ascontiguousarray(arr.astype(dtype, copy=False))
                out.write(arr.tobytes())
                shapes.append(list(arr.shape))
                offsets.append(off)
                off += arr.nbytes
        index["modalities"][packed_name] = {
            "dtype": np.dtype(dtype).name,
            "shapes": shapes,
            "offsets": offsets,
            "nbytes": off,
        }
        print(f"[{split}] {packed_name}: {len(ids)} samples, "
              f"{off / 1e6:.1f} MB")

    # tiny sidecar modalities inlined into the index
    ori_dir = os.path.join(split_dir, "orientations")
    if os.path.isdir(ori_dir):
        oris = {}
        for sid in ids:
            p = os.path.join(ori_dir, sid + ".json")
            if os.path.isfile(p):
                with open(p) as fh:
                    oris[sid] = json.load(fh)
        index["orientations"] = oris
    scene_dir = None
    for c in ("scene_class", "scene"):
        if os.path.isdir(os.path.join(split_dir, c)):
            scene_dir = os.path.join(split_dir, c)
            break
    if scene_dir:
        scenes = {}
        for sid in ids:
            p = os.path.join(scene_dir, sid + ".txt")
            if os.path.isfile(p):
                with open(p) as fh:
                    scenes[sid] = fh.read().strip()
        index["scene"] = scenes

    tmp = index_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(index, fh)
    os.replace(tmp, index_path)
    print(f"[{split}] wrote {index_path}")
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", help="prepared dataset root")
    ap.add_argument("--splits", nargs="*", default=None,
                    help="default: every dir containing an rgb/ subdir")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    splits = args.splits
    if not splits:
        splits = [
            d for d in sorted(os.listdir(args.root))
            if os.path.isdir(os.path.join(args.root, d, "rgb"))
        ]
    if not splits:
        raise SystemExit(f"no splits with rgb/ found under {args.root}")
    for s in splits:
        pack_split(args.root, s, force=args.force)


if __name__ == "__main__":
    main()
