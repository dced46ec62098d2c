"""Seeded weights and inputs, made on the device in a few large draws.

Weights follow the rules of `emsanet_tpu_torch/weights.py::random_init_`
(frozen here from commit 795107519fd8) where they are sound: He-normal
convs and dense layers, the learned upsamplings' bilinear-mimic kernel,
BatchNorm scale U(0.5, 1.5) and shift N(0, 0.1^2), and the last norm of
every NonBottleneck1D residual branch at scale U(0.1, 0.3). Biases of
convs and dense layers are drawn N(0, 0.02^2) (there: 0), so that every
bias the program adds is exercised. All values come from one normal and
one uniform draw of a generator on the device. The BatchNorms' running
statistics are then set from a calibration batch (`calibrate`), so that
the activations keep their scale through the depth as in a trained
network; with random running statistics (there: mean N(0, 0.1^2),
variance U(0.5, 1.5)) their scale drifts with the seed, and the heads'
maps are saturated on some seeds and cancel to rounding noise on others.
Last, the values are cast to the type they are served in.

The inputs are `emsanet_tpu_torch/bench.py::random_raw_inputs`'s
(frozen from the same commit): uint8 RGB uniform in [0, 255] and uint16
depth in mm uniform in [0, 9999], NYUv2's sensor range; drawn on the
device and kept in pinned host memory, from where each request uploads
them.
"""

from __future__ import annotations

import hashlib
import re
import time
from typing import Dict, Tuple

import torch

BILINEAR_MIMIC = ((0.0625, 0.125, 0.0625),
                  (0.125, 0.25, 0.125),
                  (0.0625, 0.125, 0.0625))
BIAS_STD = 0.02
CALIBRATION_FRAMES = 4
_BRANCH_END = re.compile(r"\.block\d+\.(Norm_1\.BatchNorm_0|BatchNorm_0)$")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights, inputs...)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _value(name: str, shape, normal, uniform, device) -> torch.Tensor:
    module, _, leaf = name.rpartition(".")
    if leaf == "running_mean":  # set by `calibrate`
        return torch.zeros_like(normal)
    if leaf == "running_var":
        return torch.ones_like(uniform)
    if module.endswith(".depthwise"):
        k = torch.tensor(BILINEAR_MIMIC, device=device)
        return k.expand(shape[0], 1, 3, 3).reshape(-1)
    if len(shape) >= 2:  # conv or dense weight
        fan_in = 1
        for d in shape[1:]:
            fan_in *= d
        return normal * (2.0 / fan_in) ** 0.5
    if module.endswith("BatchNorm_0"):
        if leaf == "bias":
            return normal * 0.1
        return (uniform * 0.2 + 0.1 if _BRANCH_END.search(module)
                else uniform + 0.5)
    return normal * BIAS_STD  # conv or dense bias


def make_weights(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 seed: int, device, dtype: torch.dtype, config: Dict,
                 height: int, width: int
                 ) -> Tuple[Dict[str, torch.Tensor], float]:
    """(name -> tensor of `shapes` (the program's state dict layout), on
    `device`, floats in `dtype`, BatchNorm statistics calibrated on
    `height` x `width` frames; the seconds the calibration took, which
    is the reference's work)."""
    sizes = {k: int(torch.Size(s).numel()) for k, (s, _) in shapes.items()}
    total = sum(sizes.values())
    g = generator(seed, "weights", device)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, src_dtype) in shapes.items():
        n = sizes[name]
        if not src_dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=src_dtype, device=device)
        else:
            v = _value(name, shape, normal[at:at + n], uniform[at:at + n],
                       device)
            out[name] = v.reshape(shape)
        at += n
    del normal, uniform
    reference_s = calibrate(out, seed, config, height, width, device)
    return ({k: v.to(dtype) if v.is_floating_point() else v
             for k, v in out.items()}, reference_s)


def calibrate(params: Dict[str, torch.Tensor], seed: int, config: Dict,
              height: int, width: int, device) -> float:
    """Every BatchNorm's running statistics from the plain reference's
    float32 forward (TF32 off, deterministic convs) over
    CALIBRATION_FRAMES frames of the seed, in place; returns its
    seconds, the device's queue drained before and after."""
    from reference.emsanet import Reference

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    start = time.perf_counter()
    raw = make_raw_inputs(CALIBRATION_FRAMES, height, width, seed,
                          "calibration", device)
    ds = config["dataset"]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            Reference(params, config["reference"],
                      (ds["depth_mean"], ds["depth_std"]),
                      calibrate_bn=True).forward(raw["rgb"], raw["depth"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    if cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - start


def make_raw_inputs(n: int, h: int, w: int, seed: int, slot, device
                    ) -> Dict[str, torch.Tensor]:
    """Pool slot `slot`: uint8 RGB (n, h, w, 3), uint16 depth (n, h, w,
    1) in [0, 9999], on `device`."""
    g = generator(seed, f"inputs:{slot}", device)
    rgb = torch.randint(0, 256, (n, h, w, 3), generator=g, device=device,
                        dtype=torch.uint8)
    # int16 holds [0, 9999]; its bits are the uint16 values
    depth = torch.randint(0, 10000, (n, h, w, 1), generator=g,
                          device=device, dtype=torch.int16)
    return {"rgb": rgb, "depth": depth.view(torch.uint16)}
