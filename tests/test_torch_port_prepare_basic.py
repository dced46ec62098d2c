"""The port's dataset preparation (`python -m
emsanet_tpu_torch.prepare_dataset`) against `tools/prepare_dataset.py`,
on the CPU: the helpers (depth statistics, meta.json, normals from
depth and their encoding), the synthetic and Cityscapes preparers (PNG
inputs) and the command line, whose subcommands and flags are the
tool's, and the NYUv2 and Hypersim preparers with h5py and PIL missing.
Raw fixtures come from the tool's own tests (`tests/test_prepare_*.py`)
and `tests/data/hdf5/`; the trees are compared by
`tests/torch_prepare_cases.py`.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import pytest
from test_prepare_cityscapes import _make_raw as make_cityscapes
from torch_prepare_cases import ROOT, assert_same_tree, port, prepare_both, \
    tool

import chip_smoke


def test_normals_from_depth_and_encoding_equal_the_tool():
    rng = np.random.RandomState(0)
    depth = rng.uniform(0.5, 4.0, (30, 41)).astype(np.float32)
    depth[3:6, 10:14] = 0.0  # missing depth
    for smooth in (0, 3, 5):
        got = port.normals_from_depth(depth, smooth=smooth)
        want = tool.normals_from_depth(depth, smooth=smooth)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(port.encode_normals_png(got),
                              tool.encode_normals_png(want))


def test_depth_stats_and_meta_equal_the_tool(tmp_path):
    rng = np.random.RandomState(1)
    for root in ("port", "tool"):
        d = tmp_path / root / "train" / "depth"
        d.mkdir(parents=True)
    for i in range(5):
        depth = rng.randint(0, 9000, (17, 23)).astype(np.uint16)
        depth[i] = 0
        for root in ("port", "tool"):
            port.write_png(str(tmp_path / root / "train" / "depth"
                               / f"{i}.png"), depth)
    got = port.compute_depth_stats(str(tmp_path / "port" / "train/depth"),
                                   max_files=3)
    want = tool.compute_depth_stats(str(tmp_path / "tool" / "train/depth"),
                                    max_files=3)
    assert got == want
    entries = (("bed", True, True), ("wall", False, False))
    port.write_meta(str(tmp_path / "port"), entries, ("kitchen",))
    tool.write_meta(str(tmp_path / "tool"), entries, ("kitchen",))
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "tool"))


def test_prepare_synthetic_equals_the_tool(tmp_path):
    got, want = str(tmp_path / "port"), str(tmp_path / "tool")
    port.prepare_synthetic(got, 3, 2, 40, 56)
    tool.prepare_synthetic(want, 3, 2, 40, 56)
    assert assert_same_tree(got, want) == 5 * 6 + 1


def test_prepare_cityscapes_equals_the_tool(tmp_path):
    raw = tmp_path / "raw"
    make_cityscapes(str(raw))
    assert prepare_both(tmp_path, "cityscapes", str(raw)) == 3 * 4 + 1


def _subcommands(main, monkeypatch):
    """{subcommand: its option strings} of `main`'s parser, read where
    `main` parses (which then stops)."""
    seen = {}

    def spy(parser, *args, **kwargs):
        (sub,) = [a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction)]
        for name, p in sub.choices.items():
            seen[name] = sorted(s for a in p._actions
                                for s in a.option_strings)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    with pytest.raises(SystemExit):
        main([])
    monkeypatch.undo()
    return seen


def test_cli_has_the_tools_subcommands_and_flags(monkeypatch):
    got = _subcommands(port.main, monkeypatch)
    assert len(got) == 8
    assert got == _subcommands(tool.main, monkeypatch)


def test_cli_module_prepares_a_synthetic_set(tmp_path):
    out = tmp_path / "syn"
    subprocess.run([sys.executable, "-m", "emsanet_tpu_torch.prepare_dataset",
                    "synthetic", "--out", str(out), "--n-train", "2",
                    "--n-test", "1", "--height", "24", "--width", "32"],
                   cwd=ROOT, check=True, capture_output=True)
    want = tmp_path / "tool"
    tool.prepare_synthetic(str(want), 2, 1, 24, 32)
    assert_same_tree(str(out), str(want))
    with open(out / "meta.json") as fh:
        assert json.load(fh)["scene_labels"][0] == "void"


def test_port_module_imports_no_image_library():
    code = ("import sys\n"
            "import emsanet_tpu_torch.prepare_dataset\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'cv2', 'jax', 'h5py', 'emsanet_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("name", ["nyuv2", "hypersim"])
def test_h5py_preparers_name_h5py_where_it_is_missing(name, tmp_path,
                                                      monkeypatch):
    """The two HDF5 preparers run where h5py (and PIL) is missing: on the
    committed fixture sets (`tests/data/hdf5/`) the port's tree equals
    the tool's."""
    data = ROOT / "tests" / "data" / "hdf5"
    if name == "nyuv2":
        splits, mapping = chip_smoke.nyuv2_tables(str(tmp_path))
        args = (str(data / "nyuv2" / "nyu_depth_v2_labeled.mat"), splits,
                mapping)
    else:
        args = (str(data / "hypersim"),)
    want = str(tmp_path / "tool")
    getattr(tool, f"prepare_{name}")(*args, want)
    got = str(tmp_path / "port")
    with monkeypatch.context() as blocked:
        for module in ("h5py", "PIL", "PIL.Image"):
            blocked.setitem(sys.modules, module, None)
        getattr(port, f"prepare_{name}")(*args, got)
    assert assert_same_tree(got, want) == {"nyuv2": 23,
                                           "hypersim": 13}[name]
