"""Weights: flax -> PyTorch conversion and seeded initializations.

`flax_to_state_dict` carries a flax `{"params", "batch_stats"}` tree (as
numpy arrays) over to the port's `state_dict`. The port's modules are
named after the flax tree, so the map is the identity on paths
('/' -> '.') plus these leaf rules:

  conv `kernel` (kh, kw, in/groups, out) -> `weight` (out, in/groups, kh, kw)
  (depthwise kernels (3, 3, 1, C) become (C, 1, 3, 3) by the same rule)
  dense `kernel` (in, out)            -> `weight` (out, in)
  BatchNorm `scale` / `bias`          -> `weight` / `bias`
  BatchNorm `mean` / `var` (stats)    -> `running_mean` / `running_var`
  conv / dense `bias`                 -> `bias`

The zero-init-residual blocks' bare `BatchNorm_0` (vs `Norm_1/
BatchNorm_0`) needs no rule: the port's block has the same child name.
`load_flax_variables` fails loudly on any key that is missing, unused or
of the wrong shape.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from emsanet_tpu_torch.models.encoder import SEFusion
from emsanet_tpu_torch.models.layers import BatchNorm, NonBottleneck1D
from emsanet_tpu_torch.models.upsampling import (
    BILINEAR_MIMIC_KERNEL,
    Upsampling,
)

_PARAM_LEAVES = {"scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables (numpy leaves) -> port state_dict (torch tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, rules in (("params", _PARAM_LEAVES),
                              ("batch_stats", _STAT_LEAVES)):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.array(leaf, dtype=np.float32)  # a writable copy
            name = path[-1]
            if collection == "params" and name == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
                else:
                    raise ValueError(f"unexpected kernel rank at {path}")
                torch_name = "weight"
            elif name in rules:
                torch_name = rules[name]
            else:
                raise KeyError(f"no conversion rule for {collection}/"
                               f"{'/'.join(path)}")
            key = ".".join(path[:-1] + (torch_name,))
            if key in out:
                raise KeyError(f"two flax leaves map to '{key}'")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_variables(model: nn.Module,
                        variables: Mapping[str, Any]) -> nn.Module:
    """Load converted flax variables into `model`; raise on any mismatch."""
    converted = flax_to_state_dict(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(converted))
    unused = sorted(set(converted) - set(own))
    bad_shape = sorted(k for k in set(own) & set(converted)
                       if tuple(own[k].shape) != tuple(converted[k].shape))
    if missing or unused or bad_shape:
        raise ValueError(
            "flax -> torch weight map failed:\n"
            f"  missing in the flax tree: {missing}\n"
            f"  unused flax leaves: {unused}\n"
            f"  shape mismatches: "
            f"{[(k, tuple(own[k].shape), tuple(converted[k].shape)) for k in bad_shape]}"
        )
    model.load_state_dict(converted, strict=True)
    return model


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights (no trained checkpoint is in the repository).

    Convs and dense layers: He-normal (fan-in); biases 0; learned
    upsamplings: the bilinear-mimic kernel. BatchNorms get random affine
    parameters and running statistics (scale U(0.5, 1.5), shift and mean
    N(0, 0.1^2), var U(0.5, 1.5)), so that every conv of the
    zero-init-residual blocks still reaches the output; the last norm of
    each NonBottleneck1D residual branch gets scale U(0.1, 0.3) instead,
    which keeps the activations of the deep residual stacks of order 1.
    The task heads' convs are drawn at 0.1x the He scale, so that the
    random heatmap and logits are not saturated and postprocessing finds
    centers and instances.
    """
    g = torch.Generator().manual_seed(seed)
    branch_ends = {id(m.second_norm()) for m in model.modules()
                   if isinstance(m, NonBottleneck1D)}
    heads = {id(m) for name, m in model.named_modules()
             if name.rsplit(".", 1)[-1].startswith(("head_conv",
                                                     "head_task_conv"))}
    for module in model.modules():
        if isinstance(module, Upsampling) and hasattr(module, "depthwise"):
            w = module.depthwise.weight
            w.copy_(torch.from_numpy(np.broadcast_to(
                BILINEAR_MIMIC_KERNEL, tuple(w.shape)).copy()))
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            if isinstance(module, nn.Conv2d) and module.groups > 1:
                continue  # depthwise upsampling, set above
            w = module.weight
            fan_in = w[0].numel()
            std = (2.0 / fan_in) ** 0.5 * (0.1 if id(module) in heads else 1.0)
            w.copy_(torch.randn(w.shape, generator=g) * std)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            c = module.weight.shape[0]
            if id(module) in branch_ends:
                module.weight.copy_(torch.rand(c, generator=g) * 0.2 + 0.1)
            else:
                module.weight.copy_(torch.rand(c, generator=g) + 0.5)
            module.bias.copy_(torch.randn(c, generator=g) * 0.1)
            module.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
            module.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return model


# std of a standard normal truncated to [-2, 2]: flax's variance_scaling
# divides its truncated draws by it, so the result has the asked-for std
_TRUNC2_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], by the inverse CDF (as
    `torch.nn.init.trunc_normal_` draws it)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + (1.0 - 2.0 * lo) * u
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z.clamp_(-2.0, 2.0).float()


@torch.no_grad()
def reference_init_(model: nn.Module, seed: int) -> nn.Module:
    """The reference's initialization (flax's `init_model`,
    `emsanet_tpu/models/emsanet.py:357`), drawn from `seed`.

    Convs and dense layers: `lecun_normal`, a normal truncated at +-2 std
    and scaled to std 1 / sqrt(fan_in), fan_in = kh * kw * c_in / groups;
    He-normal (untruncated, std sqrt(2 / fan_in)) for the SE layers of
    the encoder fusion where `cfg.he_init` names "encoder-fusion"
    (`emsanet_tpu/models/layers.py:29-30`, `:125`). Biases 0. BatchNorm
    scale 1, bias 0, running mean 0, running var 1, except scale 0 on
    the last norm of the zero-init-residual NBt1D blocks (the decoders',
    `layers.py:179-185`; `no_zero_init_decoder_residuals` builds none).
    Learned upsamplings: the bilinear-mimic kernel. The draws come from a
    `torch.Generator(seed)`, so the bits differ from JAX's; their
    distributions are the same.
    """
    g = torch.Generator().manual_seed(seed)
    cfg = getattr(model, "cfg", None)
    he = set()
    if cfg is not None and "encoder-fusion" in cfg.he_init:
        he = {id(m) for f in model.modules() if isinstance(f, SEFusion)
              for m in f.modules() if isinstance(m, nn.Linear)}
    zero_scale = {id(m.BatchNorm_0) for m in model.modules()
                  if isinstance(m, NonBottleneck1D) and m.zero_init_residual}
    for module in model.modules():
        if isinstance(module, Upsampling) and hasattr(module, "depthwise"):
            w = module.depthwise.weight
            w.copy_(torch.from_numpy(np.broadcast_to(
                BILINEAR_MIMIC_KERNEL, tuple(w.shape)).copy()))
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            if isinstance(module, nn.Conv2d) and module.groups > 1:
                continue  # depthwise upsampling, set above
            w = module.weight
            fan_in = w[0].numel()
            if id(module) in he:
                w.copy_(torch.randn(w.shape, generator=g)
                        * math.sqrt(2.0 / fan_in))
            else:
                w.copy_(_truncated_normal(w.shape, g)
                        / _TRUNC2_STD / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(0.0 if id(module) in zero_scale else 1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    return model
