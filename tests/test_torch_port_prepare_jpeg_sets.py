"""The port's COCO, Hypersim, ScanNet and SceneNetRGBD preparers
(`emsanet_tpu_torch/prepare_dataset.py`) against the tool's
(`tools/prepare_dataset.py`), on the raw fixtures of the tool's own
tests: JPEG inputs through the port's decoder (Hypersim's tonemapped
previews, ScanNet's .sens colour frames, resized to the depth size by
PIL's BILINEAR, labels by its NEAREST), the .sens and protobuf readers,
HDF5 through h5py. The prepared trees must decode to equal arrays
(`tests/torch_prepare_cases.py`).
"""

import numpy as np
from test_prepare_coco import _make_raw as make_coco
from test_prepare_hypersim import _make_raw as make_hypersim
from test_prepare_scannet import _make_raw as make_scannet
from test_prepare_scenenet import _make_raw as make_scenenet
from torch_prepare_cases import port, prepare_both, tool


def _raw(tmp_path, make):
    raw = tmp_path / "raw"
    raw.mkdir()
    make(str(raw))
    return str(raw)


def test_prepare_coco_equals_the_tool(tmp_path):
    _raw(tmp_path, make_coco)
    assert prepare_both(tmp_path, "coco", str(tmp_path / "raw"),
                        splits=("train",)) > 3


def test_prepare_hypersim_equals_the_tool(tmp_path):
    _raw(tmp_path, make_hypersim)
    assert prepare_both(tmp_path, "hypersim", str(tmp_path / "raw")) > 5


def test_prepare_hypersim_subsample_equals_the_tool(tmp_path):
    _raw(tmp_path, make_hypersim)
    assert prepare_both(tmp_path, "hypersim", str(tmp_path / "raw"),
                        subsample=2) > 3


def test_prepare_scannet_equals_the_tool(tmp_path):
    _raw(tmp_path, make_scannet)
    assert prepare_both(tmp_path, "scannet", str(tmp_path / "raw"),
                        splits=("train",), subsample=2) > 5


def test_sens_and_label_map_readers_equal_the_tool(tmp_path):
    _raw(tmp_path, make_scannet)
    sens = str(tmp_path / "raw" / "scans" / "scene0000_00"
               / "scene0000_00.sens")
    for (gi, gc, gk, gd), (wi, wc, wk, wd) in zip(port._parse_sens(sens),
                                                  tool._parse_sens(sens)):
        assert (gi, gc, gk) == (wi, wc, wk) and np.array_equal(gd, wd)
    tsv = str(tmp_path / "raw" / "scannetv2-labels.combined.tsv")
    assert port._scannet_label_map(tsv) == tool._scannet_label_map(tsv)


def test_prepare_scenenetrgbd_equals_the_tool(tmp_path):
    _raw(tmp_path, make_scenenet)
    assert prepare_both(tmp_path, "scenenetrgbd", str(tmp_path / "raw"),
                        splits=("train",)) > 5
    pb = str(tmp_path / "raw" / "scenenet_rgbd_train_0.pb")
    assert port._parse_scenenet_pb(pb) == tool._parse_scenenet_pb(pb)
