"""The JAX package's native host library, for the port's parity tests.

`emsanet_tpu/native.py` builds `native/libemsanet_native.so` on first
use, in place: every process compiles into the same object file, links
onto the same library and deletes that object file when it is done, and
a failed build or load is remembered for the rest of the process
(`_TRIED`). The library is not committed, so on a fresh checkout the
workers of `pytest -n 6` race to build it, and a worker that loses the
race takes the NumPy fallback for the whole run. The port's parity
tests hold the port's host library against that library, bit for bit,
and need the library itself.

`jax_native_lib` gives it to them: under an exclusive `flock` on
`build/jax_native.lock` it checks the library (present, newer than its
source, loadable), builds it where it is not with the two commands of
`emsanet_tpu/native.py::_build` (per-process temporary names in
`native/`, then an atomic `os.replace`), clears the module's remembered
failure and loads it through the module's own `get_lib`. It returns the
library or raises; it never skips and never falls back. The six port
test files that compare against the JAX package's library call it when
pytest imports them, so every worker holds the library before its first
test.

What it cannot repair happens earlier: every worker first loads the
library while it imports `tests/test_native.py`, through the module's
own racing build. A link there can read another process's object file
just after that process's assembler truncated it, and `ld` takes an
empty input for an empty linker script: the library then loads and
exports nothing. `get_lib` raises AttributeError, and `dlopen` keeps
that library for its path for the rest of the process, so that worker
fails to collect `tests/test_native.py` and the helper raises there too.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOCK = ROOT / "build" / "jax_native.lock"
SOURCE_NAME = "emsanet_native.cpp"
# emsanet_tpu/native.py::_build: compile with fast-math, link without it
COMPILE = ["g++", "-O3", "-march=native", "-ffast-math", "-fPIC", "-c"]
LINK = ["g++", "-shared"]
ATTEMPTS = 3


def _fault(so_path: Path) -> str:
    """Why `so_path` is not a current library that loads; '' if it is."""
    source = so_path.parent / SOURCE_NAME
    if not so_path.is_file():
        return f"{so_path} is missing"
    if source.is_file() and source.stat().st_mtime > so_path.stat().st_mtime:
        return f"{so_path} is older than {source}"
    try:
        ctypes.CDLL(str(so_path))
    except OSError as e:
        return f"{so_path} does not load: {e}"
    return ""


def build(so_path: Path) -> None:
    """Compile and link `so_path` from the source beside it, as
    `emsanet_tpu/native.py::_build` does, into per-process temporary
    files that replace the library at once."""
    source = so_path.parent / SOURCE_NAME
    tmp = so_path.with_name(f".{so_path.name}.{os.getpid()}.tmp")
    obj = tmp.with_suffix(".o")
    try:
        for cmd in (COMPILE + ["-o", str(obj), str(source)],
                    LINK + ["-o", str(tmp), str(obj)]):
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the JAX package's native library failed "
                    f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        for p in (obj, tmp):
            if p.exists():
                p.unlink()


def jax_native_lib(module=None, lock_path=LOCK):
    """The JAX package's loaded native library (`module.get_lib()`),
    built first where it is missing, stale or broken; raises with the
    compiler's or the loader's message where it cannot be had.

    `module` defaults to `emsanet_tpu.native`, whose `_SO_PATH` names the
    library; a test points it and `lock_path` at a copy."""
    if module is None:
        from emsanet_tpu import native as module
    if module._LIB is not None:
        return module._LIB
    so_path = Path(module._SO_PATH)
    lock_path = Path(lock_path)
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lock_path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)  # released when `fh` closes
        # a process outside the lock (the module's own loader, which links
        # in place) can spoil the file between the check and the load:
        # check, build and load again
        for _ in range(ATTEMPTS):
            if module._LIB is None and _fault(so_path):
                build(so_path)
            module._TRIED = False
            lib = module.get_lib()
            if lib is not None:
                return lib
        raise RuntimeError(
            "the JAX package's native library cannot be loaded: "
            + (_fault(so_path) or "get_lib() returned None"))
