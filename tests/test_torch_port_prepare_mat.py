"""The port's NYUv2 and SUNRGB-D preparers (`emsanet_tpu_torch/
prepare_dataset.py`) against the tool's (`tools/prepare_dataset.py`), on
small raw fixtures written here: a v7.3 (HDF5) NYUv2 labeled .mat with
splits.mat and a 894->40 class mapping (scipy), and a SUNRGB-D toolbox
tree of two sensors with seg.mat, JPEG images, shifted depth PNGs,
intrinsics, extrinsics, 3D box annotations and allsplit.mat. Both
instance versions of SUNRGB-D; the helpers `_points_in_polygon`,
`_read_sunrgbd_camera`, `_load_annotation3d` and
`_extract_box_instances` equal the tool's. The prepared trees must
decode to equal arrays (`tests/torch_prepare_cases.py`).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image
from scipy import io as sio
from torch_prepare_cases import assert_same_tree, port, prepare_both, tool

h5py = pytest.importorskip("h5py")

N, H, W = 5, 16, 20
SCENES = ("kitchen", "bedroom", "kitchen", "office", "bedroom")


def _nyuv2_raw(root):
    rng = np.random.RandomState(0)
    mat = os.path.join(root, "nyu_depth_v2_labeled.mat")
    with h5py.File(mat, "w") as f:
        # MATLAB's column-major arrays read back transposed: (N, C, W, H)
        f["images"] = rng.randint(0, 256, (N, 3, W, H)).astype(np.uint8)
        f["depths"] = rng.uniform(0.5, 6.0, (N, W, H)).astype(np.float32)
        raw = rng.uniform(0.0, 8.0, (N, W, H)).astype(np.float32)
        raw[:, :3] = 0.0
        f["rawDepths"] = raw
        labels = rng.randint(0, 6, (N, W, H))
        labels[:, :, :4] = 894
        f["labels"] = labels.astype(np.uint16)
        inst = np.zeros((N, W, H), np.uint8)
        inst[:, 2:9, 3:8] = 1
        inst[:, 10:16, 6:12] = 2
        f["instances"] = inst
        refs = f.create_dataset("sceneTypes", (1, N), dtype=h5py.ref_dtype)
        for i, name in enumerate(SCENES):
            ds = f.create_dataset(f"#refs#/s{i}", data=np.array(
                [[ord(c)] for c in name], np.uint16))
            refs[0, i] = ds.ref
    splits = os.path.join(root, "splits.mat")
    sio.savemat(splits, {"trainNdxs": np.array([[1], [2], [4]]),
                         "testNdxs": np.array([[3], [5]])})
    mapping = os.path.join(root, "classMapping40.mat")
    sio.savemat(mapping, {"mapClass": (np.arange(894) % 41)[None]})
    return mat, splits, mapping


@pytest.mark.parametrize("with_tables", [True, False],
                         ids=["splits_and_mapping", "defaults"])
def test_prepare_nyuv2_equals_the_tool(tmp_path, with_tables):
    raw = tmp_path / "raw"
    raw.mkdir()
    mat, splits, mapping = _nyuv2_raw(str(raw))
    if not with_tables:
        splits = mapping = None
    got, want = str(tmp_path / "port"), str(tmp_path / "tool")
    port.prepare_nyuv2(mat, splits, mapping, got)
    tool.prepare_nyuv2(mat, splits, mapping, want)
    n = assert_same_tree(got, want)
    assert n == N * 7 + 1 + with_tables  # + scene_names.json, meta.json


def _sunrgbd_scene(root, rel, seed, scene, box):
    rng = np.random.RandomState(seed)
    d = os.path.join(root, rel)
    for sub in ("image", "depth_bfx", "extrinsics", "annotation3Dfinal"):
        os.makedirs(os.path.join(d, sub))
    Image.fromarray(rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)).save(
        os.path.join(d, "image", "img.jpg"), quality=90)
    depth_mm = rng.randint(800, 3000, (24, 32)).astype(np.uint16)
    depth_mm[0, :5] = 0
    shifted = ((depth_mm << 3) | (depth_mm >> 13)).astype(np.uint16)
    Image.fromarray(shifted).save(os.path.join(d, "depth_bfx", "d.png"))
    seglabel = np.ones((24, 32), np.int32)  # wall
    seglabel[8:20, 4:16] = 2  # chair
    seglabel[4:10, 18:30] = 3  # table
    seglabel[20:, 20:] = 4  # an unknown name -> void
    names = np.empty((1, 4), object)
    for i, name in enumerate(("wall", "chair", "table", "widget")):
        names[0, i] = name
    sio.savemat(os.path.join(d, "seg.mat"),
                {"seglabel": seglabel, "names": names})
    with open(os.path.join(d, "scene.txt"), "w") as fh:
        fh.write(scene)
    with open(os.path.join(d, "intrinsics.txt"), "w") as fh:
        fh.write("30 0 16\n0 30 12\n0 0 1\n")
    with open(os.path.join(d, "extrinsics", "20140101.txt"), "w") as fh:
        fh.write("1 0 0 0\n0 0.98 -0.2 0\n0 0.2 0.98 0\n")
    if box:
        objects = [{"name": "chair", "polygon": [
            {"X": [-5, 5, 5, -5], "Z": [0, 0, 6, 6], "Ymin": -4,
             "Ymax": 4}]}, None, {"name": "table", "polygon": []}]
        with open(os.path.join(d, "annotation3Dfinal", "index.json"),
                  "w") as fh:
            json.dump({"objects": objects}, fh)


def _sunrgbd_raw(root):
    rels = ("kv1/NYUdata/NYU0001", "kv2/kinect2data/K0002",
            "realsense/lg/R0003", "xtion/xtion_align_data/X0004")
    for i, rel in enumerate(rels):
        _sunrgbd_scene(root, rel, i, SCENES[i], box=i != 2)
    os.makedirs(os.path.join(root, "traintestSUNRGBD"))
    prefix = "/n/fs/sun3d/data/SUNRGBD/"

    def cells(items):
        out = np.empty((1, len(items)), object)
        for i, p in enumerate(items):
            out[0, i] = prefix + p + "/"
        return out

    sio.savemat(os.path.join(root, "traintestSUNRGBD", "allsplit.mat"),
                {"alltrain": cells(rels[:2]), "alltest": cells(rels[2:])})


@pytest.mark.parametrize("version", ["emsanet", "segments"])
def test_prepare_sunrgbd_equals_the_tool(tmp_path, version):
    raw = tmp_path / "SUNRGBD"  # allsplit.mat's paths end in SUNRGBD/...
    raw.mkdir()
    _sunrgbd_raw(str(raw))
    n = prepare_both(tmp_path, "sunrgbd", str(raw),
                     instances_version=version)
    assert n == 4 * 6 + 2 + 1  # + two cameras.json, meta.json
    assert len(os.listdir(tmp_path / "port" / "test" / "rgb")) == 2
    if version == "emsanet":  # the boxes gave instances with a yaw
        with open(tmp_path / "port" / "train" / "orientations"
                  / "00000.json") as fh:
            assert json.load(fh)


def test_sunrgbd_helpers_equal_the_tool(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    _sunrgbd_raw(str(raw))
    d = str(raw / "kv1" / "NYUdata" / "NYU0001")
    for fn in ("_read_sunrgbd_camera", "_load_annotation3d"):
        got, want = getattr(port, fn)(d), getattr(tool, fn)(d)
        assert repr(got) == repr(want), fn
    rng = np.random.RandomState(2)
    px, py = rng.uniform(-2, 2, (2, 40, 30))
    poly = ([-1.0, 1.5, 0.5, -1.2], [-1.0, -0.5, 1.4, 0.8])
    assert np.array_equal(port._points_in_polygon(px, py, *poly),
                          tool._points_in_polygon(px, py, *poly))
    k, rtilt = port._read_sunrgbd_camera(d)
    depth = rng.uniform(0.5, 3.0, (24, 32))
    semantic = np.zeros((24, 32), np.uint8)
    semantic[5:20, 5:20] = 5
    args = (depth, k, rtilt, port._load_annotation3d(d), semantic,
            {"chair": 5, "wall": 1}, {})
    got, want = port._extract_box_instances(*args), \
        tool._extract_box_instances(*args)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[1]
