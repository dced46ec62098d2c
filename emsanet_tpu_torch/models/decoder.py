"""EMSANet dense decoder and scene head (counterpart:
`emsanet_tpu/models/decoder.py`).

Dense decoder = 3 modules with channels (512, 256, 128) targeting
downscales (16, 8, 4). Each module: 3x3 conv + BN + ReLU -> N
NonBottleneck1D blocks (the chain kernel) -> x2 upsample -> 1x1-conv
projection of the fused RGB skip + add. Then the task head at 1/4 and
two x2 prediction upsamplings to full resolution.

Where the polyphase gate engages at the final x2 stage (its input has
at least 60*80 pixels), `head_decode_fusion` decides how far the heads
defer it (`emsanet_tpu/models/decoder.py:354-386`):
- the semantic head returns `logits_polyphase` ((N, H/2, W/2, 4C),
  channel c*4 + (p*2+q)) in 'interleave', and `decode_input` in every
  'decode*' mode;
- the instance head returns full-res maps, except in 'decode-planes'
  and 'decode-both', where it returns `decode_input`.
`decode_input` is `{"x": (N, H/2, W/2, C) NHWC head output, "kernel":
(C, 1, 3, 3) depthwise weight}`; postprocessing runs the stage in a
kernel. Below the gate every head returns full-res outputs. Outputs are
NHWC, like the JAX package.

In train mode (`emsanet_tpu/models/decoder.py`, train=True): the blocks
take their dropout, every module of a decoder built with side outputs
emits one (a 1x1 conv before its x2 upsample, at downscales 32, 16, 8;
encoded like the head), and with `fused_train_head` the semantic head
defers its final x2 stage at every size: `decode_input` then carries the
weight itself, not detached, for the fused head loss.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from emsanet_tpu_torch.models.layers import (
    ConvNormAct,
    Linear,
    Norm,
    NonBottleneck1D,
    apply_blocks_fused,
    conv,
)
from emsanet_tpu_torch.models.upsampling import Upsampling


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class EncoderDecoderFusion(nn.Module):
    """'add-rgb' / 'add-depth': 1x1 projection (+ BN) of the skip + add."""

    def __init__(self, mode: str, skip_channels: int, features: int):
        super().__init__()
        self.mode = mode
        self.project = mode != "none" and skip_channels != features
        if self.project:
            self.proj = conv(skip_channels, features, (1, 1))
            self.Norm_0 = Norm(features)

    def forward(self, x: torch.Tensor, skips: Dict[str, torch.Tensor]):
        if self.mode == "none":
            return x
        modality = self.mode.split("-", 1)[1]
        if modality == "rgbd":
            skip = skips["rgb"] + skips["depth"]
        else:
            skip = skips[modality]
        if self.project:
            skip = self.Norm_0(self.proj(skip))
        return x + skip


class DecoderModule(nn.Module):
    """Channel reduce + NBt1D blocks + x2 upsample + skip add."""

    def __init__(self, cin: int, features: int, n_blocks: int,
                 fusion: str, skip_channels: Optional[int], upsampling: str,
                 zero_init_residual: bool, block_dropout_p: float = 0.0,
                 side_output_channels: Optional[int] = None,
                 fused_training: bool = False):
        super().__init__()
        self.conv_in = ConvNormAct(cin, features, (3, 3))
        self.n_blocks = n_blocks
        self.fused_training = fused_training
        for i in range(n_blocks):
            setattr(self, f"block{i}", NonBottleneck1D(
                features, features, zero_init_residual=zero_init_residual,
                dropout_p=block_dropout_p))
        if side_output_channels:
            self.side_output = conv(features, side_output_channels, (1, 1),
                                    bias=True)
        self.upsample = Upsampling(upsampling, features)
        self.skip_fusion = (
            EncoderDecoderFusion(fusion, skip_channels, features)
            if skip_channels is not None else None
        )

    def forward(self, x, skips):
        """(x, side output or None; side outputs only in train mode)."""
        x = self.conv_in(x)
        blocks = [getattr(self, f"block{i}") for i in range(self.n_blocks)]
        x = apply_blocks_fused(blocks, x, self.fused_training)
        side = None
        if self.training and hasattr(self, "side_output"):
            side = self.side_output(x)
        x = self.upsample(x)
        if self.skip_fusion is not None and skips is not None:
            x = self.skip_fusion(x, skips)
        return x, side


class PredictionUpsampling(nn.Module):
    """Two x2 stages of the prediction upsampling (x4 to full res)."""

    def __init__(self, method: str, channels: int, defer_final: bool,
                 defer_final_conv: bool = False,
                 defer_final_conv_train: bool = False):
        super().__init__()
        self.up0 = Upsampling(method, channels)
        self.up1 = Upsampling(method, channels, defer_interleave=defer_final,
                              defer_conv=defer_final_conv,
                              defer_conv_train=defer_final_conv_train)

    def forward(self, x):
        return self.up1(self.up0(x))


class DenseDecoder(nn.Module):
    """Dense decoder of the semantic or instance task."""

    def __init__(self, task: str, cin: int, n_channels: Sequence[int],
                 downsamplings: Sequence[int], n_blocks: int, fusion: str,
                 skip_channels: Dict[int, int], upsampling: str,
                 prediction_upsampling: str, zero_init_residual: bool,
                 n_classes: int = 40, with_orientation: bool = False,
                 sigmoid_for_center: bool = True,
                 tanh_for_offset: bool = True,
                 n_channels_per_task: int = 32,
                 head_decode_fusion: str = "interleave",
                 block_dropout_p: float = 0.0, side_outputs: bool = False,
                 fused_training: bool = False,
                 fused_train_head: bool = False):
        super().__init__()
        self.task = task
        self.with_orientation = with_orientation
        self.sigmoid_for_center = sigmoid_for_center
        self.tanh_for_offset = tanh_for_offset
        self.n_modules = len(n_channels)
        if task == "instance":
            n_sub = 3 if with_orientation else 2
            self.out_channels = (1, 2, 2)[:n_sub]
            n_head = sum(self.out_channels)
        elif task == "semantic":
            n_head = n_classes
        else:
            raise ValueError(f"Unknown dense decoder task '{task}'")
        self.n_head = n_head
        c = cin
        for i, (f, ds) in enumerate(zip(n_channels, downsamplings)):
            setattr(self, f"module{i}", DecoderModule(
                c, f, n_blocks, fusion, skip_channels.get(ds), upsampling,
                zero_init_residual, block_dropout_p,
                n_head if side_outputs else None, fused_training))
            c = f
        self.downsamplings = tuple(downsamplings)
        if task == "instance":
            self.head_shared_conv = ConvNormAct(c, n_channels_per_task * n_sub)
            for t, oc in enumerate(self.out_channels):
                setattr(self, f"head_task_conv{t}",
                        conv(n_channels_per_task, oc, (3, 3), bias=True))
            self.n_channels_per_task = n_channels_per_task
        else:
            self.head_conv = conv(c, n_classes, (3, 3), bias=True)
        # only the semantic head's consumer (argmax / score) commutes with
        # the interleave; instance postprocessing needs full-res maps
        defer_conv = (
            head_decode_fusion.startswith("decode") if task == "semantic"
            else head_decode_fusion in ("decode-planes", "decode-both"))
        self.head_upsampling = PredictionUpsampling(
            prediction_upsampling, n_head, defer_final=(task == "semantic"),
            defer_final_conv=defer_conv,
            defer_final_conv_train=(task == "semantic" and fused_train_head))

    def forward(self, context_out: torch.Tensor,
                skips: Dict[int, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
        x = context_out
        sides = []
        for i, ds in enumerate(self.downsamplings):
            x, side = getattr(self, f"module{i}")(x, skips.get(ds))
            if side is not None:
                sides.append(self._encode(_nhwc(side)))
        if self.task == "instance":
            h = self.head_shared_conv(x)
            cpt = self.n_channels_per_task
            pred = torch.cat([
                getattr(self, f"head_task_conv{t}")(h[:, t * cpt:(t + 1) * cpt])
                for t in range(len(self.out_channels))
            ], dim=1)
        else:
            pred = self.head_conv(x)
        pred = self.head_upsampling(pred)
        if isinstance(pred, tuple):
            x_half, weight = pred
            # channels_last: the NHWC view is contiguous, and then this
            # is no copy
            return {"side_outputs": tuple(sides), "decode_input": {
                "x": _nhwc(x_half).contiguous(),
                "kernel": weight if self.training else weight.detach()}}
        out: Dict[str, Any] = {"side_outputs": tuple(sides)}
        deferred = pred.shape[1] == 4 * self.n_head
        if self.task == "semantic":
            out["logits_polyphase" if deferred else "logits"] = _nhwc(pred)
            return out
        pred = _nhwc(pred)
        center = pred[..., 0:1]
        offset = pred[..., 1:3]
        out["center"] = torch.sigmoid(center) if self.sigmoid_for_center \
            else center
        out["offset"] = torch.tanh(offset) if self.tanh_for_offset else offset
        if self.with_orientation:
            out["orientation"] = pred[..., 3:5]
        return out

    def _encode(self, pred: torch.Tensor) -> torch.Tensor:
        """The head's output encodings of an NHWC side output: sigmoid
        center and tanh offset for the instance task, none else."""
        if self.task != "instance":
            return pred
        center = pred[..., 0:1]
        offset = pred[..., 1:3]
        parts = [torch.sigmoid(center) if self.sigmoid_for_center else center,
                 torch.tanh(offset) if self.tanh_for_offset else offset]
        if self.with_orientation:
            parts.append(pred[..., 3:5])
        return torch.cat(parts, dim=-1)


class SceneClassificationHead(nn.Module):
    """Scene classifier on the first (global) context branch."""

    def __init__(self, cin: int, n_classes: int):
        super().__init__()
        self.head = Linear(cin, n_classes)

    def forward(self, context_branch: torch.Tensor) -> torch.Tensor:
        return self.head(context_branch.flatten(1))

