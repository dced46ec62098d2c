"""Weights: flax -> PyTorch conversion and seeded initializations.

`flax_to_state_dict` carries a flax `{"params", "batch_stats"}` tree (as
numpy arrays) over to the port's `state_dict`. The port's modules are
named after the flax tree, so the map is the identity on paths
('/' -> '.') plus these leaf rules:

  conv `kernel` (kh, kw, in/groups, out) -> `weight` (out, in/groups, kh, kw)
  (depthwise kernels (3, 3, 1, C) become (C, 1, 3, 3) by the same rule)
  dense `kernel` (in, out)            -> `weight` (out, in)
  BatchNorm / LayerNorm / GroupNorm `scale` / `bias` -> `weight` / `bias`
  BatchNorm `mean` / `var` (stats)    -> `running_mean` / `running_var`
  conv / dense `bias`                 -> `bias`

The zero-init-residual blocks' bare `BatchNorm_0` (vs `Norm_1/
BatchNorm_0`) needs no rule: the port's block has the same child name.
`load_flax_variables` fails loudly on any key that is missing, unused or
of the wrong shape.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from emsanet_tpu_torch.models.encoder import SEFusion
from emsanet_tpu_torch.models.layers import (
    BatchNorm,
    Bottleneck,
    GroupNorm,
    LayerNorm,
    NonBottleneck1D,
)
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
    centers and instances. LayerNorms and GroupNorms get the BatchNorms'
    random affine parameters; the bottleneck blocks' last norms count as
    branch ends, as the NonBottleneck1D ones do.
    """
    g = torch.Generator().manual_seed(seed)
    branch_ends = {id(m.second_norm()) for m in model.modules()
                   if isinstance(m, NonBottleneck1D)} | {
        id(m.Norm_0.inner) for m in model.modules()
        if isinstance(m, Bottleneck)}
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
        elif isinstance(module, (LayerNorm, GroupNorm)):
            c = module.weight.shape[0]
            if id(module) in branch_ends:
                module.weight.copy_(torch.rand(c, generator=g) * 0.2 + 0.1)
            else:
                module.weight.copy_(torch.rand(c, generator=g) + 0.5)
            module.bias.copy_(torch.randn(c, generator=g) * 0.1)
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
    (`emsanet_tpu/models/layers.py:29-30`, `:125`; the only part whose
    init the JAX model switches: the backbones' SE gates, the MLP
    decoders and every other layer keep lecun_normal). Biases 0. Norms
    (batch, layer, group) scale 1, bias 0; BatchNorm running mean 0,
    running var 1; scale 0 on the last norm of the zero-init-residual
    NBt1D blocks, which only batchnorm builds (the decoders',
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
        elif isinstance(module, (LayerNorm, GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# Loading weights across configurations (the reference's transfer rules,
# `emsanet_tpu/weights.py::merge_loaded_params`) and ImageNet-pretrained
# backbones (`load_backbone_pretrained`), on the port's state dicts: a
# name's '.'-separated parts are the flax path's, so the rules read the
# same parts.


def _is_semantic_head(parts) -> bool:
    return "semantic_decoder" in parts and any("head_conv" in p
                                               for p in parts)


def _is_scene_head(parts) -> bool:
    return "scene_decoder" in parts and "head" in parts


def _output_axis(src_shape, tgt_shape):
    """The one axis where two shapes differ (the class / channel axis)."""
    if len(src_shape) != len(tgt_shape):
        return None
    diff = [i for i, (a, b) in enumerate(zip(src_shape, tgt_shape))
            if a != b]
    return diff[0] if len(diff) == 1 else None


def merge_loaded_params(loaded: Mapping[str, torch.Tensor],
                        target: Mapping[str, torch.Tensor],
                        verbose: bool = True) -> Dict[str, torch.Tensor]:
    """`target` (a state dict) with the tensors of `loaded` taken over by
    the reference's rules: equal shapes are copied; names `target` lacks
    are dropped; a scene head of another class count keeps its init; a
    semantic head of 37 <-> 40 classes takes the shared first classes,
    one of 40 -> 20 or 549 -> 200 (ScanNet benchmarks) the benchmark
    classes' channels; an instance head with more channels (the
    orientation task) is truncated; any other mismatch keeps the init."""
    from emsanet_tpu_torch.datasets import scannet as scannet_meta

    say = print if verbose else (lambda *a, **k: None)
    out = dict(target)
    for key, value in loaded.items():
        if key not in target:
            say(f"[weights] dropping extra key {key}")
            continue
        tgt = target[key]
        if tuple(value.shape) == tuple(tgt.shape):
            out[key] = value
            continue
        parts = tuple(key.split("."))
        if _is_scene_head(parts):
            say(f"[weights] skipping scene head {key}: "
                f"{tuple(value.shape)} vs {tuple(tgt.shape)}")
            continue
        axis = _output_axis(value.shape, tgt.shape)
        if _is_semantic_head(parts) and axis is not None:
            n_src, n_tgt = value.shape[axis], tgt.shape[axis]
            if (n_src, n_tgt) in ((40, 20), (549, 200)):
                mapping = (
                    scannet_meta.SEMANTIC_CLASSES_40_MAPPING_TO_BENCHMARK
                    if n_src == 40 else
                    scannet_meta.SEMANTIC_CLASSES_549_MAPPING_TO_BENCHMARK200)
                keep = torch.tensor([c - 1 for c in range(1, n_src + 1)
                                     if mapping[c] != 0])
                out[key] = value.index_select(axis, keep)
                say(f"[weights] scannet benchmark reduction for {key}: "
                    f"{tuple(value.shape)} -> {tuple(out[key].shape)}")
                continue
            n_copy = min(n_src, n_tgt)
            new = tgt.clone()
            new.narrow(axis, 0, n_copy).copy_(value.narrow(axis, 0, n_copy))
            say(f"[weights] reusing {n_copy}/{n_tgt} classes in {key}")
            out[key] = new
            continue
        if "instance_decoder" in parts and axis is not None and (
                value.shape[axis] > tgt.shape[axis]):
            say(f"[weights] truncating {key} {tuple(value.shape)} -> "
                f"{tuple(tgt.shape)}")
            out[key] = value.narrow(axis, 0, tgt.shape[axis])
            continue
        say(f"[weights] shape mismatch for {key}: {tuple(value.shape)} vs "
            f"{tuple(tgt.shape)}; keeping random init")
    return out


def load_weights_file(path: str, model: nn.Module,
                      verbose: bool = True) -> nn.Module:
    """The model weights of a checkpoint into `model`, through
    `merge_loaded_params` (`--weights-filepath`): a port checkpoint
    (`training/checkpoint.py`, also what `import_torch_checkpoint.py`
    writes), or, by its magic bytes, a JAX package checkpoint
    (`training/jax_checkpoint.py`: its params and batch stats)."""
    from emsanet_tpu_torch.training import jax_checkpoint

    if jax_checkpoint.is_jax_checkpoint(path):
        loaded = flax_to_state_dict(jax_checkpoint.read_variables(path))
    else:
        loaded = torch.load(path, map_location="cpu",
                            weights_only=True)["model"]
    target = model.state_dict()
    merged = merge_loaded_params(loaded, target, verbose=verbose)
    model.load_state_dict(merged, strict=True)
    return model


def convert_torch_state_dict(state_dict: Mapping[str, torch.Tensor],
                             name_map: Mapping[str, str]
                             ) -> Tuple[Dict[str, torch.Tensor], list]:
    """An upstream torch state dict under the port's names:
    ({port key: tensor}, the torch keys the map does not know, without
    `num_batches_tracked`). `name_map`: `torch_compat.name_map.
    emsanet_torch_name_map`. Tensors cross unchanged (both OIHW), as
    float32 copies."""
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        port_key = name_map.get(key)
        if port_key is None:
            unmatched.append(key)
            continue
        out[port_key] = value.detach().to("cpu", torch.float32).clone()
    return out, unmatched


def resnet_torch_name_map(prefix: str, stage_blocks, bottleneck: bool =
                          False) -> Dict[str, str]:
    """torchvision ResNet state-dict names -> the port's backbone names
    below `encoder.` (`<prefix>_stem`, `<prefix>_stage<i>.block<b>`)."""
    m: Dict[str, str] = {}

    def bn(torch_prefix, port_prefix):
        for t_leaf, p_leaf in (("weight", "weight"), ("bias", "bias"),
                               ("running_mean", "running_mean"),
                               ("running_var", "running_var")):
            m[f"{torch_prefix}.{t_leaf}"] = f"{port_prefix}.{p_leaf}"

    m["conv1.weight"] = f"{prefix}_stem.Conv_0.weight"
    bn("bn1", f"{prefix}_stem.Norm_0.BatchNorm_0")
    for li, n_blocks in enumerate(stage_blocks):
        for b in range(n_blocks):
            t = f"layer{li + 1}.{b}"
            f = f"{prefix}_stage{li}.block{b}"
            convs = (("conv1", "ConvNormAct_0.Conv_0", "ConvNormAct_0.Norm_0"),
                     ("conv2", "ConvNormAct_1.Conv_0", "ConvNormAct_1.Norm_0"),
                     ("conv3", "Conv_0", "Norm_0")) if bottleneck else (
                ("conv1", "ConvNormAct_0.Conv_0", "ConvNormAct_0.Norm_0"),
                ("conv2", "Conv_0", "Norm_0"))
            for i, (conv, port_conv, port_norm) in enumerate(convs, 1):
                m[f"{t}.{conv}.weight"] = f"{f}.{port_conv}.weight"
                bn(f"{t}.bn{i}", f"{f}.{port_norm}.BatchNorm_0")
            m[f"{t}.downsample.0.weight"] = f"{f}.Conv_1.weight"
            bn(f"{t}.downsample.1", f"{f}.Norm_1.BatchNorm_0")
    return m


@torch.no_grad()
def load_backbone_pretrained(model: nn.Module, filepath: str, modality: str,
                             backbone_name: str,
                             verbose: bool = True) -> nn.Module:
    """One encoder backbone from a torchvision ResNet file (a state dict,
    or a dict holding one under 'state_dict'). Tensors of equal shape are
    copied; the depth stem (1 input channel) takes conv1 summed over its
    RGB channels; others are reported and skipped (an NBt1D backbone
    takes only the stem, the downsampling blocks' convs and the norms
    whose names it shares; a bottleneck backbone takes torchvision's
    bottleneck names)."""
    from emsanet_tpu_torch.models.backbone import get_backbone_spec

    raw = torch.load(filepath, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    say = print if verbose else (lambda *a, **k: None)
    own = model.state_dict()
    spec = get_backbone_spec(backbone_name)
    name_map = resnet_torch_name_map(modality, spec.stage_blocks,
                                     spec.bottleneck)
    n_loaded = 0
    for torch_name, port_name in name_map.items():
        full = f"encoder.{port_name}"
        if torch_name not in raw or full not in own:
            continue
        value, tgt = raw[torch_name], own[full]
        if value.shape != tgt.shape:
            if (value.ndim == 4 and full.endswith(".weight")
                    and value.shape[1] == 3 and tgt.shape[1] == 1
                    and value.shape[2:] == tgt.shape[2:]):
                value = value.sum(dim=1, keepdim=True)  # depth stem
            if value.shape != tgt.shape:
                say(f"[weights] skip {full}: {tuple(value.shape)} vs "
                    f"{tuple(tgt.shape)}")
                continue
        tgt.copy_(value.to(tgt.dtype))
        n_loaded += 1
    say(f"[weights] backbone '{modality}': loaded {n_loaded} tensors from "
        f"{filepath}")
    return model
