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
  ../hdf5_latest/  the same arrays written as a newer h5py writes them
      (libver 'latest': superblock 3, version-2 object headers, dense
      links in fractal heaps, chunk indexes of layout message version 4,
      lzf; `write_nyuv2(latest=True)`, `HYP_LATEST`), which prepare to
      the same digests.

Write the fixtures anew with `PYTHONPATH=. python
tests/test_torch_port_prepare_hdf5.py`.
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
LATEST = ROOT / "tests" / "data" / "hdf5_latest"
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


def write_nyuv2(path, latest=False):
    """The NYUv2-layout .mat: MATLAB arrays (H, W, C, N) stored reversed,
    (N, C, W, H) as h5py reads them. `latest`: the same arrays as a
    newer h5py writes them (libver 'latest': superblock 3, version-2
    headers, chunk indexes of layout message version 4; tracked creation
    order), plus NYUv2's `names` cell (6 of its class names), which the
    preparers do not read: the root and `#refs#` then hold more links
    than a compact group's 8 and keep them dense, in a fractal heap, as
    the real file's do."""
    rng = np.random.RandomState(0)
    n = len(NYU_SCENES)
    args = (NYU_H, NYU_W)
    images = _blocks(rng, n, 160, (3,), 0, 256, np.uint8, *args)
    depths = _blocks(rng, n, 160, (), 0.5, 9.9, np.float32, *args)
    raw = depths.copy()
    raw[:, :160, :320] = 0.0  # missing raw depth
    labels = _blocks(rng, n, 160, (), 0, 895, np.uint16, *args)
    instances = _blocks(rng, n, 160, (), 0, 4, np.uint8, *args)
    kw = dict(libver="latest", track_order=True) if latest else {}
    cells = [("sceneTypes", NYU_SCENES),
             ("scenes", [f"{s}_{i + 1:04d}" for i, s in enumerate(
                 NYU_SCENES)])]
    if latest:
        cells.append(("names", ("wall", "floor", "cabinet", "bed", "chair",
                                "sofa")))
    with h5py.File(path, "w", userblock_size=512, **kw) as f:
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
        for cell, words in cells:
            refs = f.create_dataset(cell, (1, len(words)),
                                    dtype=h5py.ref_dtype)
            refs.attrs["MATLAB_class"] = np.bytes_("cell")
            for i, word in enumerate(words):
                ds = f.create_dataset(f"#refs#/{cell}_{i}", data=np.array(
                    [[ord(c)] for c in word], np.uint16))
                ds.attrs["MATLAB_class"] = np.bytes_("char")
                refs[0, i] = ds.ref
    with open(path, "r+b") as fh:  # MATLAB's header in the user block
        fh.write(MATLAB_HEADER + bytes(8) + b"\x00\x02IM")


# the newer-format Hypersim tree: each geometry file's layout (libver
# 'latest'); between them lzf, a fixed array, an extensible array and a
# v2 B-tree chunk index
HYP_LATEST = {
    "depth_meters": dict(chunks=(64, 64), compression="lzf"),
    "normal_cam": dict(chunks=(64, 64, 3), maxshape=(None, None, 3),
                       compression="gzip"),
    "semantic": dict(chunks=(32, 256), maxshape=(None, HYP_W),
                     compression="gzip"),
    "semantic_instance": dict(chunks=(48, 64), compression="gzip",
                              shuffle=True),
}


def write_hypersim(root, latest=False):
    """The Hypersim raw tree; `latest`: the same arrays (and the same
    tonemap JPEGs), each geometry file in the newer format with its
    layout of `HYP_LATEST`."""
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
            path = geometry / f"frame.{frame:04d}.{kind}.hdf5"
            if latest:
                with h5py.File(path, "w", libver="latest") as f:
                    f.create_dataset("dataset", data=arr,
                                     **HYP_LATEST[kind])
                continue
            with h5py.File(path, "w") as f:
                f.create_dataset("dataset", data=arr, chunks=arr.shape,
                                 compression="gzip", compression_opts=9)


def _pil_array(path):
    with Image.open(path) as img:
        return np.asarray(img)


def tool_digests(tmp, data=DATA):
    """{set: digests} of the tool's trees from the committed fixtures
    (`data`: DATA, or LATEST for the newer-format copies)."""
    splits, mapping = chip_smoke.nyuv2_tables(str(tmp))
    out = {}
    tool.prepare_nyuv2(str(data / "nyuv2" / "nyu_depth_v2_labeled.mat"),
                       splits, mapping, str(tmp / "nyuv2"))
    tool.prepare_hypersim(str(data / "hypersim"), str(tmp / "hypersim"))
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
    write_latest_fixtures()


def write_latest_fixtures(out: Path = LATEST) -> None:
    """The newer-format copies: the same arrays, so the same prepared
    trees (expected.json)."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    (out / "nyuv2").mkdir(parents=True)
    (out / "hypersim").mkdir()
    write_nyuv2(str(out / "nyuv2" / "nyu_depth_v2_labeled.mat"), latest=True)
    write_hypersim(out / "hypersim", latest=True)


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
    # the newer-format copies prepare to the same trees
    assert (report["nyuv2_latest_files"],
            report["hypersim_latest_files"]) == (23, 13)
    assert len(report["hdf5_latest_frame_ms"]) == 3
    assert sys.modules["h5py"] is h5py and sys.modules["PIL"] is not None


def test_latest_fixtures_are_small_and_of_the_newer_format():
    """tests/data/hdf5_latest/: superblock 3 after MATLAB's user block,
    dense root and `#refs#` links, a fixed array per NYUv2 array; the
    Hypersim files' layouts of `HYP_LATEST` (lzf, a v2 B-tree, an
    extensible and a fixed array)."""
    from emsanet_tpu_torch.datasets import hdf5

    assert sum(p.stat().st_size for p in LATEST.rglob("*")
               if p.is_file()) < 150_000
    mat = LATEST / "nyuv2" / "nyu_depth_v2_labeled.mat"
    with open(mat, "rb") as fh:
        head = fh.read(521)
    assert head.startswith(b"MATLAB 7.3 MAT-file") and head[520] == 3
    with hdf5.File(str(mat)) as f:
        for group in (f.root, f["#refs#"]):
            kinds = {k for k, _, _ in group._msgs}
            assert 0x2 in kinds and 0x6 not in kinds  # dense links
        assert f["images"]._kind == 3 and f["depths"]._kind == 3
    geometry = next((LATEST / "hypersim").rglob("*_geometry_hdf5"))
    want = {"depth_meters": (3, [32000]), "normal_cam": (5, [1]),
            "semantic": (4, [1]), "semantic_instance": (3, [2, 1])}
    for kind, (index, filters) in want.items():
        with hdf5.File(str(geometry / f"frame.0001.{kind}.hdf5")) as f:
            ds = f["dataset"]
            assert (ds._kind, [fid for fid, _ in ds._filters]) == (index,
                                                                   filters)


def test_latest_expected_digests_are_the_tools(tmp_path):
    """The tool (h5py, PIL) prepares the newer-format copies to the
    digests of expected.json: they hold the same arrays."""
    with open(DATA / "expected.json") as fh:
        expected = json.load(fh)
    assert tool_digests(tmp_path, LATEST) == expected


if __name__ == "__main__":
    os.chdir(ROOT)
    write_fixtures()
