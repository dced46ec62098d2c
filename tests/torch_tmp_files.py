"""Removal of the large files that the port's tests write.

A checkpoint of the tests' R18 model is 256-400 MB (the model's and the
optimizer's tensors; `tests/test_torch_port_trainer.py::
test_checkpoint_file_holds_only_its_tensors`), an exported program
~200 MB. pytest keeps the base temporary folders of its last runs, so a
test that leaves its files behind fills the disk over a few runs; each
test that writes such files removes them once it has checked them.
"""

from __future__ import annotations

import os

LARGE_SUFFIXES = (".pt", ".pth", ".pt2", ".msgpack", ".tmp")


def remove_large_files(root) -> None:
    """Delete every checkpoint, exported program and half-written
    temporary file under `root` (a path or a str); keep the rest."""
    for dirpath, _, names in os.walk(str(root)):
        for name in names:
            if name.endswith(LARGE_SUFFIXES):
                os.unlink(os.path.join(dirpath, name))
