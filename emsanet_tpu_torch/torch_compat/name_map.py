"""Upstream torch key -> the port's `state_dict` key, for the flagship
graph (dense decoders, NBt1D backbones).

Counterpart of `emsanet_tpu/torch_compat/name_map.py::
emsanet_torch_name_map`, composed with the naming of
`weights.flax_to_state_dict`: the reference maps a torch key to a flax
path, and the port names its modules after the flax tree, so the port's
key is that path's modules joined with '.' followed by the torch key's
own leaf ('weight', 'bias', 'running_mean', 'running_var'; flax's
'kernel' and 'scale' become 'weight', 'mean' and 'var' the running
statistics). Both sides keep convs as OIHW and linears as (out, in), so
a tensor crosses unchanged. The torch keys follow the reference family's
conventions ('encoder.*', 'decoders.<task>_decoder.*', the instance
head's 'head.shared_conv', 'head.task_convs.{t}', 'head.upsampling');
the interior names are those of `emsanet_tpu/torch_compat/mirror.py`,
and a checkpoint whose names differ is re-keyed at import
(`import_torch_checkpoint.py --rename-json`).
"""

from __future__ import annotations

from typing import Dict, Sequence

NameMap = Dict[str, str]


def _leaf(m: NameMap, t: str, port: str, leaf: str) -> None:
    m[f"{t}.{leaf}"] = f"{port}.{leaf}"


def _bn(m: NameMap, t: str, port: str) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        _leaf(m, t, port, leaf)


def _conv(m: NameMap, t: str, port: str, bias: bool = True) -> None:
    _leaf(m, t, port, "weight")
    if bias:
        _leaf(m, t, port, "bias")


def _nbt1d(m: NameMap, t: str, p: str, shortcut: bool,
           zero_init: bool) -> None:
    """NonBottleneck1D: conv3x1_1, conv1x3_1, bn1, conv3x1_2, conv1x3_2,
    bn2 [, downsample]. The port (flax) names: Conv_0..Conv_3, Norm_0;
    the second norm Norm_1, or a bare BatchNorm_0 in the zero-init
    residual variant; the shortcut Conv_4 + Norm_2 (Norm_1 there)."""
    _conv(m, f"{t}.conv3x1_1", f"{p}.Conv_0")
    _conv(m, f"{t}.conv1x3_1", f"{p}.Conv_1")
    _bn(m, f"{t}.bn1", f"{p}.Norm_0.BatchNorm_0")
    _conv(m, f"{t}.conv3x1_2", f"{p}.Conv_2")
    _conv(m, f"{t}.conv1x3_2", f"{p}.Conv_3")
    if zero_init:
        _bn(m, f"{t}.bn2", f"{p}.BatchNorm_0")
        norm_i = 1
    else:
        _bn(m, f"{t}.bn2", f"{p}.Norm_1.BatchNorm_0")
        norm_i = 2
    if shortcut:
        _conv(m, f"{t}.downsample.0", f"{p}.Conv_4", bias=False)
        _bn(m, f"{t}.downsample.1", f"{p}.Norm_{norm_i}.BatchNorm_0")


def _conv_norm_act(m: NameMap, t: str, p: str) -> None:
    _conv(m, f"{t}.conv", f"{p}.Conv_0", bias=False)
    _bn(m, f"{t}.norm", f"{p}.Norm_0.BatchNorm_0")


def _se(m: NameMap, t: str, p: str) -> None:
    _conv(m, f"{t}.fc1", f"{p}.Dense_0")
    _conv(m, f"{t}.fc2", f"{p}.Dense_1")


def _backbone(m: NameMap, t: str, p: str,
              stage_blocks: Sequence[int]) -> None:
    _conv(m, f"{t}.stem.conv", f"{p}_stem.Conv_0", bias=False)
    _bn(m, f"{t}.stem.bn", f"{p}_stem.Norm_0.BatchNorm_0")
    for si, n_blocks in enumerate(stage_blocks):
        for b in range(n_blocks):
            # stage 0 keeps 1/4 and the stem's channels: no shortcut;
            # stages 1-3: the first block is strided
            _nbt1d(m, f"{t}.layer{si + 1}.{b}", f"{p}_stage{si}.block{b}",
                   shortcut=si > 0 and b == 0, zero_init=False)


def _decoder_module(m: NameMap, t: str, p: str) -> None:
    _conv_norm_act(m, f"{t}.conv3x3", f"{p}.conv_in")
    for b in range(3):
        _nbt1d(m, f"{t}.blocks.{b}", f"{p}.block{b}", shortcut=False,
               zero_init=True)
    _conv(m, f"{t}.side_output", f"{p}.side_output")
    _conv(m, f"{t}.upsample.conv", f"{p}.upsample.depthwise", bias=False)
    _conv(m, f"{t}.skip_fusion.conv", f"{p}.skip_fusion.proj", bias=False)
    _bn(m, f"{t}.skip_fusion.norm", f"{p}.skip_fusion.Norm_0.BatchNorm_0")


def emsanet_torch_name_map(
    stage_blocks: Sequence[int] = (3, 4, 6, 3),
    tasks: Sequence[str] = ("semantic", "instance", "orientation", "scene"),
    n_ppm_branches: int = 2,
) -> NameMap:
    """{upstream torch key: the port's state_dict key} of the training
    model (`EMSANet(cfg, ds, train=True)`, side outputs included; the
    eval model lacks those, and `weights.merge_loaded_params` drops
    them)."""
    m: NameMap = {}
    _backbone(m, "encoder.rgb", "encoder.rgb", stage_blocks)
    _backbone(m, "encoder.depth", "encoder.depth", stage_blocks)
    for i in range(5):  # after the stem and each of the 4 stages
        _se(m, f"encoder.fusions.{i}.se_main", f"encoder.fusion{i}.se_main")
        _se(m, f"encoder.fusions.{i}.se_other",
            f"encoder.fusion{i}.se_other")
    for bi in range(n_ppm_branches):
        _conv_norm_act(m, f"context_module.branches.{bi}",
                       f"context_module.branch{bi}")
    _conv_norm_act(m, "context_module.fuse", "context_module.fuse")
    for task in ("semantic", "instance"):
        if task not in tasks:
            continue
        t, p = f"decoders.{task}_decoder", f"{task}_decoder"
        for i in range(3):
            _decoder_module(m, f"{t}.decoder_modules.{i}", f"{p}.module{i}")
        if task == "semantic":
            _conv(m, f"{t}.head.conv", f"{p}.head_conv")
        else:
            _conv_norm_act(m, f"{t}.head.shared_conv",
                           f"{p}.head_shared_conv")
            for ti in range(3 if "orientation" in tasks else 2):
                _conv(m, f"{t}.head.task_convs.{ti}",
                      f"{p}.head_task_conv{ti}")
        for ui in range(2):
            _conv(m, f"{t}.head.upsampling.{ui}",
                  f"{p}.head_upsampling.up{ui}.depthwise", bias=False)
    if "scene" in tasks:
        _conv(m, "decoders.scene_decoder.head", "scene_decoder.head")
    return m
