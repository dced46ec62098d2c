"""The port imports neither JAX nor the JAX package, nor an image
library.

Parses every module of `emsanet_tpu_torch/` and `chip_smoke.py` with
`ast` and fails on any `import` or `from ... import` of `jax`, `flax`,
`optax` or `emsanet_tpu` (`emsanet_tpu_torch` is the port itself), or of
`PIL`, `cv2`, `matplotlib` or `msgpack` (the card's machine has none of
them: the port reads and writes PNG files itself, `datasets/png.py`,
resizes and draws with numpy, `imaging.py`, and decodes the JAX
package's checkpoints itself, `training/jax_checkpoint.py`).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "emsanet_tpu", "PIL", "cv2",
             "matplotlib", "msgpack")
FILES = sorted((ROOT / "emsanet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_port():
    assert len(FILES) > 30
    tree = ast.parse("import jax.numpy as jnp\nfrom emsanet_tpu.ops import x\n"
                     "from emsanet_tpu_torch import y\nimport flax, os\n"
                     "from PIL import Image\nimport cv2\n"
                     "import matplotlib.pyplot as plt\nimport msgpack\n")
    assert [n for _, n in _imports(tree) if _forbidden(n)] == [
        "jax.numpy", "emsanet_tpu.ops", "flax", "PIL", "cv2",
        "matplotlib.pyplot", "msgpack"]
