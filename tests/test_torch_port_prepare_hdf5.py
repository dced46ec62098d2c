"""The committed HDF5 fixture sets (`tests/data/hdf5/`) and their expected
digests, on the CPU.

  nyuv2/nyu_depth_v2_labeled.mat  a NYUv2-layout MATLAB v7.3 file of 3
      frames at NYUv2's 640x480: a 512-byte user block holding MATLAB's
      header, one deflate chunk per frame and array, `sceneTypes` and
      `scenes` cells (object references into `#refs#`), `MATLAB_class`
      attributes. `splits.mat` and the 894 -> 40 class mapping are not
      committed: `chip_smoke.nyuv2_tables` writes them with
      `scipy.io.savemat`.
  hypersim/  an apple-hypersim raw tree of one scene (2 frames at a
      quarter of Hypersim's 1024x768, one frame left out of the public
      release): float16 depth and normals, int16 semantic and instance
      maps (gzip, as Hypersim's files), a progressive `tonemap.jpg`.
  expected.json  the SHA-256 of every file `tools/prepare_dataset.py`
      writes from them (`chip_smoke.tree_digests`: a PNG's decoded
      array, a JSON file's value, other files' bytes).

The tool regenerates `expected.json` here; the port, with `h5py` and PIL
blocked, writes trees with the same digests (as `chip_smoke.py`'s
`[prepare]` phase checks on the card's machine, where neither exists).
Write the fixtures anew with `python tests/test_torch_port_prepare_hdf5.py`.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
from torch_prepare_cases import ROOT, port, tool

import chip_smoke

h5py = pytest.importorskip("h5py")

DATA = ROOT / "tests" / "data" / "hdf5"
NYU_H, NYU_W, NYU_SCENES = 480, 640, ("kitchen", "bedroom", "living_room")
HYP_H, HYP_W, HYP_FRAMES = 192, 256, (0, 1)
MATLAB_HEADER = (b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: "
                 b"Thu Jan  1 00:00:00 2015 HDF5 schema 1.00 .").ljust(116)


def _blocks(rng, n, block, extra, lo, hi, dtype, h, w):
    """(n, h, w, *extra) arrays of constant `block`-pixel squares: they
    compress well, and their random values show any transposition."""
    g = rng.uniform(lo, hi, (n, -(-h // block), -(-w // block)) + extra)
    if np.dtype(dtype).kind in "iu":
        g = np.floor(g)
    full = np.repeat(np.repeat(g, block, 1), block, 2)[:, :h, :w]
    return full.astype(dtype)


def write_nyuv2(path):
    """The NYUv2-layout .mat: MATLAB arrays (H, W, C, N) stored reversed,
    (N, C, W, H) as h5py reads them."""
    rng = np.random.RandomState(0)
    n = len(NYU_SCENES)
    args = (NYU_H, NYU_W)
    images = _blocks(rng, n, 160, (3,), 0, 256, np.uint8, *args)
    depths = _blocks(rng, n, 160, (), 0.5, 9.9, np.float32, *args)
    raw = depths.copy()
    raw[:, :160, :320] = 0.0  # missing raw depth
    labels = _blocks(rng, n, 160, (), 0, 895, np.uint16, *args)
    instances = _blocks(rng, n, 160, (), 0, 4, np.uint8, *args)
    with h5py.File(path, "w", userblock_size=512) as f:
        for name, arr, cls in (("images", images, "uint8"),
                               ("depths", depths, "single"),
                               ("rawDepths", raw, "single"),
                               ("labels", labels, "uint16"),
                               ("instances", instances, "uint8")):
            stored = np.ascontiguousarray(arr.transpose(
                (0,) + tuple(range(arr.ndim - 1, 0, -1))))
            ds = f.create_dataset(name, data=stored,
                                  chunks=(1,) + stored.shape[1:],
                                  compression="gzip", compression_opts=9)
            ds.attrs["MATLAB_class"] = np.bytes_(cls)
        for cell, words in (("sceneTypes", NYU_SCENES),
                            ("scenes", [f"{s}_{i + 1:04d}"
                                        for i, s in enumerate(NYU_SCENES)])):
            refs = f.create_dataset(cell, (1, n), dtype=h5py.ref_dtype)
            refs.attrs["MATLAB_class"] = np.bytes_("cell")
            for i, word in enumerate(words):
                ds = f.create_dataset(f"#refs#/{cell}_{i}", data=np.array(
                    [[ord(c)] for c in word], np.uint16))
                ds.attrs["MATLAB_class"] = np.bytes_("char")
                refs[0, i] = ds.ref
    with open(path, "r+b") as fh:  # MATLAB's header in the user block
        fh.write(MATLAB_HEADER + bytes(8) + b"\x00\x02IM")


def write_hypersim(root):
    rng = np.random.RandomState(1)
    scene, cam = "ai_001_001", "cam_00"
    rows = ["scene_name,camera_name,frame_id,included_in_public_release,"
            "split_partition_name"]
    rows += [f"{scene},{cam},{i},True,train" for i in HYP_FRAMES]
    rows.append(f"{scene},{cam},9,False,train")
    (root / "metadata_images_split_scene_v1.csv").write_text(
        "\n".join(rows) + "\n")
    (root / "metadata_camera_trajectories.csv").write_text(
        f"Animation,Scene type\n{scene}_{cam},living room\n")
    images = root / scene / "images"
    preview = images / f"scene_{cam}_final_preview"
    geometry = images / f"scene_{cam}_geometry_hdf5"
    preview.mkdir(parents=True)
    geometry.mkdir(parents=True)
    y, x = np.mgrid[0:HYP_H, 0:HYP_W]
    for frame in HYP_FRAMES:
        rgb = np.stack([(x + 40 * frame) % 256, (y * 2) % 256,
                        (x + y) // 2 % 256], -1)
        rgb = np.clip(rgb + rng.randint(-8, 9, rgb.shape), 0, 255)
        Image.fromarray(rgb.astype(np.uint8)).save(
            preview / f"frame.{frame:04d}.tonemap.jpg", quality=75,
            progressive=True)
        args = (1, 32)
        dist = _blocks(rng, *args, (), 1.0, 8.0, np.float16, HYP_H, HYP_W)[0]
        dist[:4, :6] = np.nan  # Hypersim's missing rays
        normal = _blocks(rng, *args, (3,), -1.0, 1.0, np.float16, HYP_H,
                         HYP_W)[0]
        semantic = _blocks(rng, *args, (), -1, 41, np.int16, HYP_H,
                           HYP_W)[0]
        instance = _blocks(rng, *args, (), -1, 12, np.int16, HYP_H,
                           HYP_W)[0] * 37
        for kind, arr in (("depth_meters", dist), ("normal_cam", normal),
                          ("semantic", semantic),
                          ("semantic_instance", instance)):
            with h5py.File(geometry / f"frame.{frame:04d}.{kind}.hdf5",
                           "w") as f:
                f.create_dataset("dataset", data=arr, chunks=arr.shape,
                                 compression="gzip", compression_opts=9)


def _pil_array(path):
    with Image.open(path) as img:
        return np.asarray(img)


def tool_digests(tmp):
    """{set: digests} of the tool's trees from the committed fixtures."""
    splits, mapping = chip_smoke.nyuv2_tables(str(tmp))
    out = {}
    tool.prepare_nyuv2(str(DATA / "nyuv2" / "nyu_depth_v2_labeled.mat"),
                       splits, mapping, str(tmp / "nyuv2"))
    tool.prepare_hypersim(str(DATA / "hypersim"), str(tmp / "hypersim"))
    for name in ("nyuv2", "hypersim"):
        out[name] = chip_smoke.tree_digests(str(tmp / name), _pil_array)
    return out


def write_fixtures(out: Path = DATA) -> None:
    import shutil
    import tempfile

    shutil.rmtree(out, ignore_errors=True)
    (out / "nyuv2").mkdir(parents=True)
    (out / "hypersim").mkdir()
    write_nyuv2(str(out / "nyuv2" / "nyu_depth_v2_labeled.mat"))
    write_hypersim(out / "hypersim")
    with tempfile.TemporaryDirectory() as tmp:
        digests = tool_digests(Path(tmp))
    (out / "expected.json").write_text(json.dumps(digests, indent=1) + "\n")


def test_fixtures_are_small_and_matlab_shaped():
    assert sum(p.stat().st_size for p in DATA.rglob("*")
               if p.is_file()) < 150_000
    mat = DATA / "nyuv2" / "nyu_depth_v2_labeled.mat"
    with open(mat, "rb") as fh:
        head = fh.read(520)
    assert head.startswith(b"MATLAB 7.3 MAT-file") and head[512:] == \
        b"\x89HDF\r\n\x1a\n"
    with h5py.File(mat, "r") as f:
        assert f["images"].shape == (3, 3, NYU_W, NYU_H)
        assert f["images"].chunks == (1, 3, NYU_W, NYU_H)
        assert f["depths"].compression == "gzip"
        assert f["labels"].attrs["MATLAB_class"] == b"uint16"
        assert f["sceneTypes"].dtype == h5py.ref_dtype
    tonemap = next((DATA / "hypersim").rglob("frame.0000.tonemap.jpg"))
    with Image.open(tonemap) as img:
        assert img.info.get("progressive") and img.size == (HYP_W, HYP_H)
    depth = next((DATA / "hypersim").rglob("frame.0000.depth_meters.hdf5"))
    with h5py.File(depth, "r") as f:
        assert f["dataset"].dtype == np.float16


def test_expected_digests_are_the_tools(tmp_path):
    with open(DATA / "expected.json") as fh:
        expected = json.load(fh)
    got = tool_digests(tmp_path)
    assert got == expected
    assert len(expected["nyuv2"]) == 3 * 7 + 2  # + scene_names, meta.json
    assert len(expected["hypersim"]) == 2 * 6 + 1


def test_port_without_h5py_or_pil_gives_the_expected_digests(tmp_path):
    """`chip_smoke.prepare_hdf5_sets`, as the card's machine runs it:
    both sets prepared by the port with h5py and PIL blocked, their
    digests checked against expected.json (it raises otherwise); the
    blocked modules come back afterwards."""
    report = chip_smoke.prepare_hdf5_sets(str(tmp_path))
    assert (report["nyuv2_files"], report["hypersim_files"]) == (23, 13)
    assert len(report["hdf5_frame_ms"]) == 3
    assert sys.modules["h5py"] is h5py and sys.modules["PIL"] is not None


if __name__ == "__main__":
    os.chdir(ROOT)
    write_fixtures()
