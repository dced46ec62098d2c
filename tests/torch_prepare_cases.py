"""Shared by tests/test_torch_port_prepare_*.py: run a preparer of the
port (`emsanet_tpu_torch/prepare_dataset.py`) and of the repository's
tool (`tools/prepare_dataset.py`) on one raw fixture, and compare the
two prepared trees: the same files; PNG and JPEG files decoded (PIL)
to equal arrays, dtype and shape included; JSON files equal as JSON;
every other file equal byte for byte.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools import prepare_dataset as tool  # noqa: E402

from emsanet_tpu_torch import prepare_dataset as port  # noqa: E402


def _files(root: str):
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root)
                for n in names]
    return sorted(out)


def assert_same_tree(got: str, want: str) -> int:
    """Compare the two prepared trees; returns the number of files."""
    files = _files(want)
    assert files and _files(got) == files
    for rel in files:
        g, w = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith((".png", ".jpg", ".jpeg")):
            with Image.open(g) as a, Image.open(w) as b:
                ga, wa = np.asarray(a), np.asarray(b)
            assert ga.dtype == wa.dtype and ga.shape == wa.shape, rel
            assert np.array_equal(ga, wa), rel
        elif rel.endswith(".json"):
            with open(g) as a, open(w) as b:
                assert json.load(a) == json.load(b), rel
        else:
            assert Path(g).read_bytes() == Path(w).read_bytes(), rel
    return len(files)


def prepare_both(tmp_path, name: str, raw, *args, **kwargs) -> int:
    """`prepare_<name>(raw, out, *args, **kwargs)` by the port and by
    the tool into tmp_path/{port,tool}; compare; returns the file
    count."""
    got, want = str(tmp_path / "port"), str(tmp_path / "tool")
    getattr(port, f"prepare_{name}")(raw, got, *args, **kwargs)
    getattr(tool, f"prepare_{name}")(raw, want, *args, **kwargs)
    return assert_same_tree(got, want)
