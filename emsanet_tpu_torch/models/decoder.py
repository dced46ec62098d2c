"""EMSANet dense decoder, SegFormer-style MLP decoder and scene head
(counterpart: `emsanet_tpu/models/decoder.py`).

Dense decoder = 3 modules with channels (512, 256, 128) targeting
downscales (16, 8, 4). Each module: 3x3 conv + norm + act -> N residual
blocks (NBt1D by default: the chain kernel where its gate allows) -> x2
upsample -> skip fusion ('add-rgb' / 'add-depth': the modality's skip,
'add-rgbd': the rgbd encoder's skip or the sum of both, each projected
by a 1x1 conv + norm where its width differs; 'none': no skip). Then the
task head at 1/4 and two x2 prediction upsamplings to full resolution.
Tasks: semantic (class logits), instance (center, offset and
orientation) and normal (3 channels, L2-normalized as pred /
max(|pred|, 1e-7), also on the side outputs).

With `fused_inference`, where the polyphase gate engages at the final x2
stage (its input has at least 60*80 pixels), `head_decode_fusion`
decides how far the heads defer it (`emsanet_tpu/models/decoder.py:354-386`):
- the semantic head returns `logits_polyphase` ((N, H/2, W/2, 4C),
  channel c*4 + (p*2+q)) in 'interleave', and `decode_input` in every
  'decode*' mode;
- the instance head returns full-res maps, except in 'decode-planes'
  and 'decode-both', where it returns `decode_input`;
- the normal head never defers.
`decode_input` is `{"x": (N, H/2, W/2, C) NHWC head output, "kernel":
(C, 1, 3, 3) depthwise weight}`; postprocessing runs the stage in a
kernel. Without `fused_inference` and below the gate every head returns
full-res outputs. Outputs are NHWC, like the JAX package.

In train mode (`emsanet_tpu/models/decoder.py`, train=True): the blocks
take their dropout, every module of a decoder built with side outputs
emits one (a 1x1 conv before its x2 upsample, at downscales 32, 16, 8;
encoded like the head), and with `fused_train_head` the semantic head
defers its final x2 stage at every size: `decode_input` then carries the
weight itself, not detached, for the fused head loss.

The MLP decoder ('segformermlp', `decoder.py:429-545`) embeds every skip
and the context output by 1x1 convs (256 channels), resizes them
bilinearly to the 1/4 map, concatenates them, fuses them by a 1x1
conv + norm + act, applies dropout and the task head (1x1 for semantic
and normal, the dense decoder's 3x3 pair for instance), and upsamples
x4. It has no side outputs and never takes the decoder trunk.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from emsanet_tpu_torch.models import layers
from emsanet_tpu_torch.models.layers import (
    BLOCK_CLASSES,
    ConvNormAct,
    Linear,
    Norm,
    apply_blocks_fused,
    conv,
)
from emsanet_tpu_torch.models.upsampling import Upsampling, resize_bilinear
from emsanet_tpu_torch.ops import nbt1d_train as train_ops


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pick_skip(skips: Dict[str, torch.Tensor], modality: str
              ) -> torch.Tensor:
    """The skip a fusion of `modality` takes (`decoder.py:61-70`): 'rgbd'
    the rgbd encoder's or the sum of both modalities'; else the
    modality's, or the only one a single-modality encoder has."""
    if modality == "rgbd":
        skip = skips.get("rgbd")
        return skip if skip is not None else skips["rgb"] + skips["depth"]
    skip = skips.get(modality)
    return skip if skip is not None else next(iter(skips.values()))


class EncoderDecoderFusion(nn.Module):
    """'add-rgb' / 'add-depth' / 'add-rgbd': 1x1 projection (+ norm) of
    the skip where its width differs, then add; 'none': nothing."""

    def __init__(self, mode: str, skip_channels: int, features: int,
                 normalization: str = "batchnorm"):
        super().__init__()
        self.mode = mode
        self.project = mode != "none" and skip_channels != features
        if self.project:
            self.proj = conv(skip_channels, features, (1, 1))
            self.Norm_0 = Norm(features, normalization)

    def forward(self, x: torch.Tensor, skips: Dict[str, torch.Tensor]):
        if self.mode == "none":
            return x
        skip = pick_skip(skips, self.mode.split("-", 1)[1])
        if self.project:
            skip = self.Norm_0(self.proj(skip))
        return x + skip


class DecoderModule(nn.Module):
    """Channel reduce + residual blocks + x2 upsample + skip fusion."""

    def __init__(self, cin: int, features: int, n_blocks: int,
                 fusion: str, skip_channels: Optional[int], upsampling: str,
                 zero_init_residual: bool, block_dropout_p: float = 0.0,
                 side_output_channels: Optional[int] = None,
                 fused_training: bool = False, block: str = "nonbottleneck1d",
                 normalization: str = "batchnorm", activation: str = "relu",
                 fused_inference: bool = False, train_polyphase: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv_in = ConvNormAct(cin, features, (3, 3),
                                   normalization=normalization,
                                   activation=activation)
        self.n_blocks = n_blocks
        self.fused_training = fused_training
        self.fused_inference = fused_inference
        cls = BLOCK_CLASSES[block]
        c = features
        for i in range(n_blocks):
            setattr(self, f"block{i}", cls(
                c, features, zero_init_residual=zero_init_residual,
                dropout_p=block_dropout_p, normalization=normalization,
                activation=activation))
            c = features * cls.expansion
        self.n_channels_out = c
        if side_output_channels:
            self.side_output = conv(c, side_output_channels, (1, 1),
                                    bias=True)
        self.upsample = Upsampling(upsampling, c, fused=fused_inference,
                                   train_polyphase=train_polyphase)
        self.skip_fusion = (
            EncoderDecoderFusion(fusion, skip_channels, c, normalization)
            if skip_channels is not None else None
        )

    def forward(self, x, skips):
        """(x, side output or None; side outputs only in train mode)."""
        if layers.remat_active(self):
            return layers.remat_call(self._forward, x, skips)
        return self._forward(x, skips)

    def _forward(self, x, skips):
        x = self.conv_in(x)
        blocks = [getattr(self, f"block{i}") for i in range(self.n_blocks)]
        x = apply_blocks_fused(blocks, x, self.fused_training,
                               self.fused_inference)
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
                 defer_final_conv_train: bool = False, fused: bool = False,
                 train_polyphase: bool = False):
        super().__init__()
        self.up0 = Upsampling(method, channels, fused=fused,
                              train_polyphase=train_polyphase)
        self.up1 = Upsampling(method, channels, defer_interleave=defer_final,
                              defer_conv=defer_final_conv,
                              defer_conv_train=defer_final_conv_train,
                              fused=fused, train_polyphase=train_polyphase)

    def forward(self, x):
        return self.up1(self.up0(x))


def _head_channels(task: str, n_classes: int, with_orientation: bool) -> int:
    if task == "semantic":
        return n_classes
    if task == "instance":
        return 5 if with_orientation else 3  # center, offset (+ orientation)
    if task == "normal":
        return 3
    raise ValueError(f"Unknown dense decoder task '{task}'")


class _TaskHead:
    """The task heads' shared parts: the instance head's convs and the
    output encodings (sigmoid center, tanh offset; L2 norm of normals)."""

    def _build_instance_head(self, c: int, n_channels_per_task: int,
                             normalization: str, activation: str,
                             kernel=(3, 3)) -> None:
        n_sub = 3 if self.with_orientation else 2
        self.out_channels = (1, 2, 2)[:n_sub]
        self.n_channels_per_task = n_channels_per_task
        self.head_shared_conv = ConvNormAct(
            c, n_channels_per_task * n_sub, normalization=normalization,
            activation=activation)
        for t, oc in enumerate(self.out_channels):
            setattr(self, f"head_task_conv{t}",
                    conv(n_channels_per_task, oc, kernel, bias=True))

    def _instance_head(self, x: torch.Tensor) -> torch.Tensor:
        h = self.head_shared_conv(x)
        cpt = self.n_channels_per_task
        return torch.cat([
            getattr(self, f"head_task_conv{t}")(h[:, t * cpt:(t + 1) * cpt])
            for t in range(len(self.out_channels))
        ], dim=1)

    def _encode(self, pred: torch.Tensor) -> torch.Tensor:
        """The head's output encodings of an NHWC prediction or side
        output: sigmoid center and tanh offset for the instance task, the
        L2 norm for the normal task, none else."""
        if self.task == "normal":
            norm = torch.linalg.vector_norm(pred, dim=-1, keepdim=True)
            return pred / torch.clamp_min(norm, 1e-7)
        if self.task != "instance":
            return pred
        center = pred[..., 0:1]
        offset = pred[..., 1:3]
        parts = [torch.sigmoid(center) if self.sigmoid_for_center else center,
                 torch.tanh(offset) if self.tanh_for_offset else offset]
        if self.with_orientation:
            parts.append(pred[..., 3:5])
        return torch.cat(parts, dim=-1)

    def _outputs(self, pred: torch.Tensor, sides) -> Dict[str, Any]:
        """The output dict of a full-res NHWC prediction."""
        out: Dict[str, Any] = {"side_outputs": tuple(sides)}
        if self.task == "semantic":
            out["logits"] = pred
            return out
        pred = self._encode(pred)
        if self.task == "normal":
            out["normal"] = pred
            return out
        out["center"] = pred[..., 0:1]
        out["offset"] = pred[..., 1:3]
        if self.with_orientation:
            out["orientation"] = pred[..., 3:5]
        return out


class DenseDecoder(_TaskHead, nn.Module):
    """Dense decoder of the semantic, instance or normal task."""

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
                 fused_train_head: bool = False,
                 block: str = "nonbottleneck1d",
                 normalization: str = "batchnorm", activation: str = "relu",
                 fused_inference: bool = False,
                 train_polyphase: bool = False, remat: bool = False):
        super().__init__()
        self.task = task
        self.with_orientation = with_orientation
        self.sigmoid_for_center = sigmoid_for_center
        self.tanh_for_offset = tanh_for_offset
        self.n_modules = len(n_channels)
        n_head = _head_channels(task, n_classes, with_orientation)
        self.n_head = n_head
        c = cin
        for i, (f, ds) in enumerate(zip(n_channels, downsamplings)):
            module = DecoderModule(
                c, f, n_blocks, fusion, skip_channels.get(ds), upsampling,
                zero_init_residual, block_dropout_p,
                n_head if side_outputs else None, fused_training, block,
                normalization, activation, fused_inference, train_polyphase,
                remat)
            setattr(self, f"module{i}", module)
            c = module.n_channels_out
        self.downsamplings = tuple(downsamplings)
        if task == "instance":
            self._build_instance_head(c, n_channels_per_task, normalization,
                                      activation)
        else:
            self.head_conv = conv(c, n_head, (3, 3), bias=True)
        # only the semantic head's consumer (argmax / score) commutes with
        # the interleave; instance postprocessing needs full-res maps
        defer_conv = fused_inference and (
            head_decode_fusion.startswith("decode") if task == "semantic"
            else task == "instance"
            and head_decode_fusion in ("decode-planes", "decode-both"))
        self.head_upsampling = PredictionUpsampling(
            prediction_upsampling, n_head,
            defer_final=(task == "semantic" and fused_inference),
            defer_final_conv=defer_conv,
            defer_final_conv_train=(task == "semantic" and fused_train_head),
            fused=fused_inference, train_polyphase=train_polyphase)

    def forward(self, context_out: torch.Tensor,
                skips: Dict[int, Dict[str, torch.Tensor]],
                trunk_features: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        """`trunk_features` (inference only): this decoder's trunk output
        (N, H, W, C) NHWC, computed by the decoder megakernel
        (`ops/decoder_trunk.py`, wired in models/emsanet.py); the module
        stack is skipped and only the head runs."""
        sides = []
        if trunk_features is not None:
            # channels_last: the NCHW view of the NHWC map is no copy
            x = trunk_features.permute(0, 3, 1, 2)
        else:
            x = context_out
            for i, ds in enumerate(self.downsamplings):
                x, side = getattr(self, f"module{i}")(x, skips.get(ds))
                if side is not None:
                    sides.append(self._encode(_nhwc(side)))
        if self.task == "instance":
            pred = self._instance_head(x)
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
        if self.task == "semantic" and pred.shape[1] == 4 * self.n_head:
            return {"side_outputs": tuple(sides),
                    "logits_polyphase": _nhwc(pred)}
        return self._outputs(_nhwc(pred), sides)


class MLPDecoder(_TaskHead, nn.Module):
    """SegFormer-style all-MLP decoder ('segformermlp') of one task."""

    EMBED_DIM = 256

    def __init__(self, task: str, c_context: int,
                 skip_channels: Dict[int, int], prediction_upsampling: str,
                 normalization: str = "batchnorm", activation: str = "relu",
                 dropout_p: float = 0.1, n_classes: int = 40,
                 with_orientation: bool = False,
                 sigmoid_for_center: bool = True,
                 tanh_for_offset: bool = True,
                 n_channels_per_task: int = 32,
                 fused_inference: bool = False):
        super().__init__()
        self.task = task
        self.with_orientation = with_orientation
        self.sigmoid_for_center = sigmoid_for_center
        self.tanh_for_offset = tanh_for_offset
        self.dropout_p = dropout_p
        e = self.EMBED_DIM
        self.skip_downscales = tuple(sorted(skip_channels))
        widths = [skip_channels[d] for d in self.skip_downscales] + [
            c_context]
        for i, c in enumerate(widths):
            setattr(self, f"embed{i}", conv(c, e, (1, 1), bias=True))
        self.n_levels = len(widths)
        self.fuse = ConvNormAct(e * len(widths), e, (1, 1),
                                normalization=normalization,
                                activation=activation)
        n_head = _head_channels(task, n_classes, with_orientation)
        if task == "instance":
            self._build_instance_head(e, n_channels_per_task, normalization,
                                      activation)
        else:
            self.head_conv = conv(e, n_head, (1, 1), bias=True)
        self.head_upsampling = PredictionUpsampling(
            prediction_upsampling, n_head, defer_final=False,
            fused=fused_inference)

    def forward(self, context_out: torch.Tensor,
                skips: Dict[int, Dict[str, torch.Tensor]],
                trunk_features: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        del trunk_features  # the dense decoders' trunk only
        feats = [pick_skip(skips[d], "rgb") for d in self.skip_downscales]
        levels = []
        for i, feat in enumerate(feats + [context_out]):
            emb = getattr(self, f"embed{i}")(feat)
            if levels and emb.shape[2:] != levels[0].shape[2:]:
                emb = resize_bilinear(emb, *levels[0].shape[2:])
            levels.append(emb)
        x = self.fuse(torch.cat(levels, dim=1))
        if self.training and self.dropout_p > 0.0:
            x = train_ops.dropout(x, self.dropout_p,
                                  layers._DROPOUT_GENERATOR.get())
        if self.task == "instance":
            pred = self._instance_head(x)
        else:
            pred = self.head_conv(x)
        return self._outputs(_nhwc(self.head_upsampling(pred)), ())


class SceneClassificationHead(nn.Module):
    """Scene classifier on the first (global) context branch."""

    def __init__(self, cin: int, n_classes: int):
        super().__init__()
        self.head = Linear(cin, n_classes)

    def forward(self, context_branch: torch.Tensor) -> torch.Tensor:
        return self.head(context_branch.flatten(1))

