"""`tests/torch_jax_native.py::jax_native_lib`, which the port's parity
tests call to get the JAX package's native library, on a copy of that
library's checkout: `emsanet_tpu/native.py` (unchanged) and
`native/emsanet_native.cpp`, in the same two-level layout under
`tmp_path`, so nothing is built in the repository.

The race is the one `pytest -n 6` runs on a fresh checkout: six
processes start at once and load the library, which is not built yet.
All six must get a library, of the same path and with the same symbols,
and exactly one build (one compile, one link) may run. The other tests
cover the states a checkout can hold the library in (missing, older than
its source, unloadable, current), a failed build, a library the module
already holds, and the module's switch to NumPy: the helper returns the
library or raises, and never returns None.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch_jax_native

ROOT = Path(__file__).resolve().parent.parent
N = 6
SYMBOLS = ("instance_targets", "resize_nearest_i32", "resize_bilinear_f32",
           "resize_bilinear_u8", "normalize_rgb_u8", "normalize_depth_f32",
           "hsv_jitter_u8")
BUILD = ["g++ -O3", "g++ -shared"]  # the logged commands of one build

CHILD = """
import importlib.util, json, os, subprocess, sys, time
root, tests, i, mode = sys.argv[1:5]
sys.path.insert(0, tests)
import torch_jax_native
spec = importlib.util.spec_from_file_location(
    "copy_native", os.path.join(root, "emsanet_tpu", "native.py"))
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
run = subprocess.run
def logged(cmd, **kw):
    with open(os.path.join(root, "builds.log"), "a") as fh:
        fh.write(" ".join(cmd[:2]) + "\\n")
    return run(cmd, **kw)
torch_jax_native.subprocess.run = logged
open(os.path.join(root, f"ready-{i}"), "w").close()
while not os.path.exists(os.path.join(root, "go")):
    time.sleep(0.001)
if mode == "bare":  # the module's own loader, as in tests/test_native.py
    try:
        print("library" if module.get_lib() is not None else "None")
    except Exception as e:
        print(type(e).__name__)
    sys.exit()
lib = torch_jax_native.jax_native_lib(
    module, lock_path=os.path.join(root, "build", "jax_native.lock"))
print(json.dumps({"path": lib._name,
                  "symbols": [s for s in %r if hasattr(lib, s)]}))
""" % (SYMBOLS,)


def _checkout(root: Path) -> Path:
    """The copy under `root`; returns its library's path."""
    (root / "emsanet_tpu").mkdir()
    (root / "native").mkdir()
    shutil.copy(ROOT / "emsanet_tpu" / "native.py",
                root / "emsanet_tpu" / "native.py")
    shutil.copy(ROOT / "native" / "emsanet_native.cpp",
                root / "native" / "emsanet_native.cpp")
    return root / "native" / "libemsanet_native.so"


def _module(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, root / "emsanet_tpu" / "native.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def builds(monkeypatch):
    """The build commands the helper runs, as 'g++ <first flag>'."""
    log = []
    run = subprocess.run

    def logged(cmd, **kw):
        log.append(" ".join(cmd[:2]))
        return run(cmd, **kw)

    monkeypatch.setattr(torch_jax_native.subprocess, "run", logged)
    return log


def _race(root: Path, mode: str):
    """Six processes that load the copy under `root` at once, through the
    helper ('helper') or the module's own `get_lib` ('bare'); their
    (returncode, stdout, stderr)."""
    script = root / "child.py"
    script.write_text(CHILD)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(root), str(ROOT / "tests"), str(i),
         mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(N)]
    try:
        deadline = time.monotonic() + 20
        while len(list(root.glob("ready-*"))) < N:
            assert all(p.poll() is None for p in procs), [
                p.communicate() for p in procs if p.poll() is not None]
            assert time.monotonic() < deadline, "the processes did not start"
            time.sleep(0.01)
        (root / "go").touch()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def test_six_cold_loads_get_one_library_from_one_build(tmp_path):
    so_path = _checkout(tmp_path)
    outs = _race(tmp_path, "helper")
    for returncode, _, err in outs:
        assert returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    assert all(g["path"] == str(so_path) for g in got)
    assert all(g["symbols"] == list(SYMBOLS) for g in got)
    assert (tmp_path / "builds.log").read_text().splitlines() == BUILD
    # nothing of the build is left beside the library
    assert sorted(p.name for p in so_path.parent.iterdir()) == [
        "emsanet_native.cpp", "libemsanet_native.so"]


@pytest.mark.parametrize("state", ["missing", "stale", "broken", "current"])
def test_the_library_is_built_only_where_it_must_be(tmp_path, builds, state):
    """Missing (after a lost race the module remembers its failure), older
    than its source, unloadable (a half-written file the module failed to
    load): one build; current: none. Each time the module's own `get_lib`
    holds the library afterwards."""
    so_path = _checkout(tmp_path)
    module = _module(tmp_path, f"copy_native_{state}")
    source = so_path.parent / "emsanet_native.cpp"
    if state in ("stale", "current"):
        torch_jax_native.build(so_path)
        builds.clear()
        if state == "stale":
            t = source.stat().st_mtime - 10
            os.utime(so_path, (t, t))
    if state == "broken":
        so_path.write_bytes(b"\x7fELF half")
        assert module.get_lib() is None
    if state == "missing":
        module._TRIED = True
    lib = torch_jax_native.jax_native_lib(
        module, lock_path=tmp_path / "build" / "jax_native.lock")
    assert builds == ([] if state == "current" else BUILD)
    assert lib is module._LIB and module.get_lib() is lib
    assert lib._name == str(so_path)
    assert all(hasattr(lib, s) for s in SYMBOLS)
    assert so_path.stat().st_mtime >= source.stat().st_mtime


def test_a_failed_build_raises_with_the_compilers_message(tmp_path):
    so_path = _checkout(tmp_path)
    source = so_path.parent / "emsanet_native.cpp"
    source.write_text(source.read_text() + "\n#error a broken source\n")
    module = _module(tmp_path, "copy_native_failed")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ -O3.*a broken source"):
        torch_jax_native.jax_native_lib(
            module, lock_path=tmp_path / "build" / "jax_native.lock")
    assert module._LIB is None
    assert sorted(p.name for p in so_path.parent.iterdir()) == [
        "emsanet_native.cpp"]


def test_a_loaded_library_is_returned_as_it_is(tmp_path, builds):
    so_path = _checkout(tmp_path)
    module = _module(tmp_path, "copy_native_loaded")
    module._LIB = held = object()
    lock = tmp_path / "build" / "jax_native.lock"
    assert torch_jax_native.jax_native_lib(module, lock_path=lock) is held
    assert builds == [] and not lock.exists() and not so_path.exists()


def test_the_numpy_switch_raises(tmp_path, monkeypatch):
    """With `EMSANET_TPU_NO_NATIVE` set the module's `get_lib` gives None:
    the helper raises instead of handing the tests the NumPy path."""
    _checkout(tmp_path)
    module = _module(tmp_path, "copy_native_switched_off")
    monkeypatch.setenv("EMSANET_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="get_lib\\(\\) returned None"):
        torch_jax_native.jax_native_lib(
            module, lock_path=tmp_path / "build" / "jax_native.lock")


def bare_races(trials: int) -> dict:
    """{"trials": [{outcome: count} for each race], "total": {...}}:
    `trials` races of six processes that load a fresh copy through the
    module's own `get_lib`, as the workers of a cold tier-1 run do when
    they import `tests/test_native.py`. An outcome is "library", "None"
    or the exception's name."""
    import collections
    import tempfile

    runs, total = [], collections.Counter()
    for _ in range(trials):
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            _checkout(root)
            count = collections.Counter(
                out.strip().splitlines()[-1] if out.strip() else f"exit {rc}"
                for rc, out, _ in _race(root, "bare"))
        runs.append(dict(count))
        total.update(count)
    return {"trials": runs, "total": dict(total)}


if __name__ == "__main__":
    # python tests/test_torch_jax_native_race.py --bare 20
    if sys.argv[1:2] == ["--bare"]:
        print(json.dumps(bare_races(int(sys.argv[2]))))
