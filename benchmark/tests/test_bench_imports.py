"""Nothing the benchmark runs imports JAX, flax or the JAX package, and
the plain reference imports nothing of the program; top-level module
names compared whole (`emsanet_tpu_torch` is not `emsanet_tpu`)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "emsanet_tpu"}
PROBE = """
import json, sys, importlib.util, pathlib
sys.path[:0] = [{bench!r}, {root!r}]
for name in {modules!r}:
    __import__(name)
for path in sorted(pathlib.Path({bench!r}, "metrics").glob("*.py")) * {readers}:
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _loaded(modules, readers=True):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(BENCH), root=str(ROOT),
                                            modules=modules,
                                            readers=int(readers))],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(BENCH))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_loads_jax():
    loaded = _loaded([
        "harness", "harness.label", "harness.check_label", "harness.control",
        "harness.trace", "harness.flops", "harness.layers", "harness.peaks",
        "harness.manifest", "harness.weights", "harness.kernel_spec",
        "reference.emsanet", "reference.postprocess", "calibrate",
        # what the label runner imports of the program
        "emsanet_tpu_torch.bench", "emsanet_tpu_torch.config",
        "emsanet_tpu_torch.models.emsanet",
        "emsanet_tpu_torch.datasets.metadata",
        "emsanet_tpu_torch.postprocessing"])
    assert "emsanet_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(["reference.emsanet", "reference.postprocess"],
                     readers=False)
    assert not loaded & (FORBIDDEN | {"emsanet_tpu_torch", "harness"})


def test_reference_sources_import_only_torch_and_the_stdlib():
    allowed = {"__future__", "math", "typing", "torch"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".", 1)[0] in allowed, (path.name, name)


def test_forbidden_modules_compares_whole_names():
    import harness

    saved = dict(sys.modules)
    try:
        sys.modules["emsanet_tpu_torch_fake"] = sys
        assert "emsanet_tpu" not in harness.forbidden_modules()
        sys.modules["emsanet_tpu.sub"] = sys
        assert harness.forbidden_modules() == ["emsanet_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
