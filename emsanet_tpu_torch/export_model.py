"""Model export: the inference program as a `torch.export` file.

    python -m emsanet_tpu_torch.export_model --out model.pt2 \\
        --weights-filepath ckpt.pt --export-batch-size 1 \\
        [--with-postprocessing] [--verify] <the trainer's model flags>

Counterpart of the repository's `tools/export_model.py` (`jax.export` to
StableHLO, the JAX package's replacement for the reference's ONNX ->
TensorRT export): `torch.export.export` traces the eval forward
(`model({'rgb', 'depth'})`, inputs (N, H, W, 3) and (N, H, W, 1) f32,
standardized) and, with `--with-postprocessing`, `postprocess`, and
`torch.export.save` writes the program with its weights. The model is
the inference scripts' (`inference_samples.eval_model`): the reference's
initialization from `--seed`, `--weights-filepath` loaded where given (a
port `.pt` or a JAX package checkpoint). `--verify` loads the file back
with `torch.export.load` and holds its outputs against the live model's
on random inputs at the JAX script's bar (`atol=1e-5`; integer and bool
maps equal).

The hand-written kernels are inside the program: their wrappers are the
`torch.library` custom ops `emsanet::*` (`ops/_native.kernel_op`), whose
CUDA implementations launch the kernels and whose CPU implementations
are the plain versions. A program exported on the card runs the kernels
when loaded; loading needs this package imported (it registers the
ops). The parameters' derived layouts (a chain's stacked and folded
parameters, the trunk's), which the eager frame keeps between calls
(`ops/param_cache.py`), are constants of the program, made from the
weights exported: like the JAX script's program, it carries its
weights, and a later change to them does not reach those layouts. The
trunk's per-phase timer stamps (`decoder_trunk_phase_ns`) stay outside.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.config import ModelConfig
from emsanet_tpu_torch.datasets.registry import get_dataset_config
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.ops import _native
from emsanet_tpu_torch.postprocessing import postprocess

VERIFY_ATOL = 1e-5  # tools/export_model.py:86-99


class Frame(torch.nn.Module):
    """The exported function: the eval forward of `model` and, with
    `with_postprocessing`, `postprocess` (the JAX script's `forward`)."""

    def __init__(self, model: torch.nn.Module, cfg: ModelConfig,
                 is_thing: Sequence[bool], with_postprocessing: bool):
        super().__init__()
        self.model = model.eval()
        self.cfg = cfg
        self.with_postprocessing = with_postprocessing
        self.register_buffer(
            "is_thing", torch.tensor(list(is_thing), dtype=torch.bool,
                                     device=next(model.parameters()).device))

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor):
        out = self.model({"rgb": rgb, "depth": depth})
        if self.with_postprocessing:
            out = postprocess(out, self.is_thing, self.cfg)
        return out


def example_inputs(n: int, h: int, w: int, device, seed: Optional[int] = None):
    """(rgb (N, H, W, 3), depth (N, H, W, 1)) f32: zeros, or standard
    normal draws from `seed` (made with numpy, as the JAX script)."""
    if seed is None:
        return (torch.zeros((n, h, w, 3), device=device),
                torch.zeros((n, h, w, 1), device=device))
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(n, h, w, 3).astype(np.float32))
            .to(device),
            torch.from_numpy(rng.randn(n, h, w, 1).astype(np.float32))
            .to(device))


def export_frame(frame: Frame, n: int, h: int, w: int):
    """`torch.export.export` of the frame at batch n (the parameters
    frozen: the program is for inference). One eager call first builds
    the parameters' derived layouts (`ops/param_cache.py`), which the
    program then holds as constants."""
    for p in frame.parameters():
        p.requires_grad_(False)
    device = next(frame.parameters()).device
    inputs = example_inputs(n, h, w, device)
    with torch.no_grad():
        frame(*inputs)
    return torch.export.export(frame, inputs)


def custom_ops(program) -> Dict[str, int]:
    """The `emsanet::*` ops in an exported program's graphs (the
    top-level graph and those of its higher-order ops, such as a
    `set_grad_enabled` region), with their calls."""
    found: Dict[str, int] = {}
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            name = str(getattr(node.target, "_schema", "")).split("(")[0]
            if name.startswith(_native.OP_NAMESPACE + "::"):
                key = name.split("::", 1)[1]
                found[key] = found.get(key, 0) + 1
    return found


def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def compare_outputs(got: Any, want: Any,
                    atol: float = VERIFY_ATOL) -> Dict[str, Any]:
    """Leaf by leaf: integer and bool tensors equal, float tensors within
    `atol`; returns the worst float difference and the leaves that
    failed (or differ in shape, dtype or structure)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    bad = sorted(set(g) ^ set(w))
    worst = 0.0
    for k in sorted(set(g) & set(w)):
        a, b = g[k], w[k]
        if not torch.is_tensor(b):
            if a != b:
                bad.append(k)
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(k)
        elif a.is_floating_point():
            if a.numel():
                d = (a.double() - b.double()).abs()
                d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
                worst = max(worst, float(d.max()))
                if not float(d.max()) <= atol:
                    bad.append(k)
        elif not torch.equal(a, b):
            bad.append(k)
    return {"failed": bad, "float_max_abs": worst, "leaves": len(w)}


def build_parser():
    parser = trainer.build_parser()
    g = parser.add_argument_group("export")
    g.add_argument("--out", required=True, help="output program path")
    g.add_argument("--export-batch-size", type=int, default=1)
    g.add_argument("--with-postprocessing", action="store_true")
    g.add_argument("--verify", action="store_true",
                   help="load the file back and compare it with the live "
                   "model")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    from emsanet_tpu_torch.inference_samples import eval_model

    ns = build_parser().parse_args(argv)
    cfg = trainer.config_from_args(ns)
    device = resolve_device(ns.device)
    ds_config = get_dataset_config(cfg.data)
    model, _ = eval_model(cfg, ds_config, device)
    frame = Frame(model, cfg.model, ds_config.classes_is_thing,
                  ns.with_postprocessing)
    n = ns.export_batch_size
    h, w = cfg.model.input_height, cfg.model.input_width
    t0 = time.perf_counter()
    program = export_frame(frame, n, h, w)
    torch.export.save(program, ns.out)
    seconds = time.perf_counter() - t0
    print(f"exported {os.path.getsize(ns.out) / 1e6:.1f} MB -> {ns.out} "
          f"in {seconds:.1f} s (device {device.type}; ops "
          f"{custom_ops(program)})")
    if ns.verify:
        inputs = example_inputs(n, h, w, device, seed=0)
        with torch.no_grad():
            got = torch.export.load(ns.out).module()(*inputs)
            want = frame(*inputs)
        res = compare_outputs(got, want)
        if res["failed"]:
            raise AssertionError(f"verify: the loaded program differs from "
                                 f"the live model at {res['failed']}")
        print(f"verify: the loaded program matches the live model "
              f"({res['leaves']} outputs, float max abs "
              f"{res['float_max_abs']:.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
