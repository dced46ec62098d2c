"""EMSANet model assembly (counterpart: `emsanet_tpu/models/emsanet.py`).

Forward: encoder (dual with SE fusion, one modality, or RGBD: rgb and
depth concatenated on the channels) -> PPM context module on the RGB
branch, or else on the only one -> the semantic, instance and normal
decoders (dense or MLP) and the scene head. The input batch holds NHWC
'rgb' (N, H, W, 3) and / or 'depth' (N, H, W, 1) normalized floats; the
output dict matches the flax model's key for key, with NHWC tensors.

`EMSANet(cfg, ds, train=True)` is the training model: its dense decoders
carry the side-output heads of multiscale supervision, and in train mode
(`.train()`) its forward runs with gradients, batch statistics and
dropout, as the flax model's `train=True` (`emsanet_tpu/models/
emsanet.py:178-262`). `build_train_model` makes it with float32
parameters, which its layers cast to `cfg.compute_dtype` at use.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from emsanet_tpu_torch.config import (
    DENSE_TASKS,
    ModelConfig,
    validate_for_port,
)
from emsanet_tpu_torch.datasets.metadata import DatasetConfig
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.models.context import (
    context_reduction_channels,
    get_context_module,
)
from emsanet_tpu_torch.models.decoder import (
    DenseDecoder,
    MLPDecoder,
    SceneClassificationHead,
)
from emsanet_tpu_torch.models.encoder import FusedEncoder
from emsanet_tpu_torch.ops import decoder_trunk as trunk_ops
from emsanet_tpu_torch.ops import param_cache

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class EMSANet(nn.Module):
    """Multi-task RGB-D scene analysis network."""

    def __init__(self, cfg: ModelConfig, dataset_config: DatasetConfig,
                 train: bool = False):
        super().__init__()
        cfg = validate_for_port(cfg)
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.encoder = FusedEncoder(cfg)
        c_enc = self.encoder.n_channels_out
        self.context_module = get_context_module(
            cfg.context_module, c_enc, cfg.upsampling_context_module,
            cfg.activation)
        skip_channels = self.encoder.skips_n_channels
        zero_init = not cfg.no_zero_init_decoder_residuals
        for task in DENSE_TASKS:
            if task not in cfg.tasks:
                continue
            extra: Dict[str, Any] = {}
            if task == "semantic":
                extra["n_classes"] = (
                    dataset_config.n_semantic_classes_without_void)
            elif task == "instance":
                extra.update(
                    with_orientation="orientation" in cfg.tasks,
                    sigmoid_for_center=cfg.instance_sigmoid_for_center,
                    tanh_for_offset=cfg.instance_tanh_for_offset,
                )
            common = dict(normalization=cfg.decoder_normalization,
                          activation=cfg.activation,
                          fused_inference=cfg.fused_inference, **extra)
            if getattr(cfg, f"{task}_decoder") != "emsanet":
                decoder = MLPDecoder(
                    task, c_enc, skip_channels, cfg.upsampling_prediction,
                    dropout_p=getattr(cfg, f"{task}_decoder_dropout_p"),
                    **common)
            else:
                decoder = DenseDecoder(
                    task, c_enc,
                    n_channels=getattr(cfg, f"{task}_decoder_n_channels"),
                    downsamplings=getattr(cfg,
                                          f"{task}_decoder_downsamplings"),
                    n_blocks=getattr(cfg, f"{task}_decoder_n_blocks"),
                    fusion=getattr(cfg, f"{task}_encoder_decoder_fusion"),
                    skip_channels=skip_channels,
                    upsampling=getattr(cfg, f"{task}_decoder_upsampling"),
                    prediction_upsampling=cfg.upsampling_prediction,
                    zero_init_residual=zero_init,
                    head_decode_fusion=cfg.head_decode_fusion,
                    block_dropout_p=getattr(
                        cfg, f"{task}_decoder_block_dropout_p"),
                    side_outputs=train and bool(
                        cfg.task_side_output_downscales(task)),
                    fused_training=cfg.fused_training,
                    fused_train_head=(task == "semantic"
                                      and cfg.fused_training
                                      and cfg.fused_train_head),
                    block=getattr(cfg, f"{task}_decoder_block"),
                    train_polyphase=cfg.train_polyphase_upsampling,
                    remat=cfg.remat,
                    **common,
                )
            setattr(self, f"{task}_decoder", decoder)
        if "scene" in cfg.tasks:
            self.scene_decoder = SceneClassificationHead(
                context_reduction_channels(cfg.context_module, c_enc),
                dataset_config.n_scene_classes_without_void,
            )

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        if self.training:
            return self._forward(batch)
        with torch.no_grad():
            return self._forward(batch)

    def encoder_inputs(self, batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The encoder's inputs in the compute dtype: 'rgbd' as rgb and
        depth concatenated on the channels (`emsanet.py:194-204`), else
        the modalities the encoder takes."""
        dt = self.compute_dtype
        if self.encoder.modalities == ("rgbd",):
            return {"rgbd": torch.cat([batch["rgb"].to(dt),
                                       batch["depth"].to(dt)], dim=-1)}
        return {m: batch[m].to(dt) for m in self.encoder.modalities}

    def _forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        feats, skips = self.encoder(self.encoder_inputs(batch))
        con_out, con_context = self.context_module(
            feats["rgb"] if "rgb" in feats else next(iter(feats.values())))
        # the decoder megakernel: one call computes every dense decoder's
        # module stack; each decoder then runs only its head
        trunk: Dict[str, torch.Tensor] = {}
        if (not self.training and self.cfg.fused_inference
                and self.cfg.decoder_megakernel != "off"):
            trunk = self._trunk_megakernel(con_out, skips)
        outputs: Dict[str, Any] = {}
        for task in DENSE_TASKS:
            if task in self.cfg.tasks:
                outputs[task] = getattr(self, f"{task}_decoder")(
                    con_out, skips, trunk.get(task))
        if "scene" in self.cfg.tasks:
            outputs["scene"] = {"logits": self.scene_decoder(con_context[0])}
        return outputs

    def _trunk_megakernel(
        self, con_out: torch.Tensor,
        skips: Dict[int, Dict[str, torch.Tensor]],
    ) -> Dict[str, torch.Tensor]:
        """Every eligible dense decoder's trunk in ONE call
        (`ops/decoder_trunk.py`), as the reference's
        `EMSANet._trunk_megakernel` (`emsanet_tpu/models/emsanet.py:264`).

        Returns {} (the decoders run their own modules) unless the dense
        decoders share the flagship trunk topology and the shapes pass
        `trunk_supported`. 'auto' engages only on the card at batch <=
        MAX_BATCH; 'on' at any batch, on the CPU through the plain
        version."""
        cfg = self.cfg
        tasks = [t for t in DENSE_TASKS if t in cfg.tasks
                 and getattr(cfg, f"{t}_decoder") == "emsanet"]
        if not tasks:
            return {}

        def sig(t):
            return tuple(getattr(cfg, f"{t}_{field}") for field in (
                "decoder_n_channels", "decoder_downsamplings",
                "decoder_block", "decoder_n_blocks",
                "encoder_decoder_fusion", "decoder_upsampling"))

        if any(sig(t) != sig(tasks[0]) for t in tasks[1:]):
            return {}
        n_channels, downsamplings, block, n_blocks, fusion, upsampling = (
            sig(tasks[0]))
        if (block != "nonbottleneck1d"
                or upsampling != "learned-3x3-zeropad"
                or cfg.decoder_normalization != "batchnorm"
                or cfg.activation != "relu"
                or not fusion.startswith("add-")):
            return {}
        modality = fusion.split("-", 1)[1]
        if modality not in ("rgb", "depth"):
            return {}
        skip_list = []
        for ds in downsamplings:
            sd = skips.get(ds)
            if sd is None or modality not in sd:
                return {}
            skip_list.append(sd[modality])
        # the kernel always applies the 1x1 skip projection (the decoder
        # skips it when the channels already match)
        if any(s.shape[1] == c for s, c in zip(skip_list, n_channels)):
            return {}
        n, c0, h0, w0 = con_out.shape
        if cfg.decoder_megakernel == "auto" and not con_out.is_cuda:
            return {}
        if not trunk_ops.trunk_supported(
            n, h0, w0, n_channels, c0, [s.shape[1] for s in skip_list],
            n_blocks,
            max_batch=n if cfg.decoder_megakernel == "on" else None,
        ):
            return {}
        decoders = [getattr(self, f"{t}_decoder") for t in tasks]
        out = trunk_ops.decoder_trunk(
            _nhwc(con_out), [_nhwc(s) for s in skip_list],
            _cached_trunk_params(decoders, con_out.dtype))
        return {t: out[i] for i, t in enumerate(tasks)}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC; no copy for a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def _cached_trunk_params(decoders, dtype: torch.dtype):
    """`stack_trunk_params`, kept on the first decoder between calls
    (`param_cache`: rebuilt when a tensor moves or is written in place).

    Stacking and folding is ~40 small ops per decoder module; on every
    frame their launches would cost more than the kernel saves.
    """
    mods = [getattr(dec, f"module{i}") for dec in decoders
            for i in range(dec.n_modules)]
    tensors = [t for m in mods for t in (*m.parameters(), *m.buffers())]
    return param_cache.cached(
        decoders[0], ("trunk", dtype), tensors,
        lambda: trunk_ops.stack_trunk_params(decoders, dtype))


def build_model(
    cfg: ModelConfig,
    dataset_config: DatasetConfig,
    device: Optional[str] = None,
    seed: Optional[int] = 0,
) -> EMSANet:
    """The port's model on `device` (default 'cuda', which must exist),
    in eval mode and in `cfg.compute_dtype`, with random weights drawn
    from `seed` (`weights.random_init_`); pass seed=None to keep the
    module defaults, e.g. before loading converted weights."""
    from emsanet_tpu_torch.weights import random_init_

    dev = resolve_device(device)
    model = EMSANet(cfg, dataset_config)
    if seed is not None:
        random_init_(model, seed)
    # channels_last: conv weights in the layout of the NHWC activations
    model = model.to(device=dev, dtype=_DTYPES[cfg.compute_dtype],
                     memory_format=torch.channels_last)
    return model.eval()


def build_train_model(
    cfg: ModelConfig,
    dataset_config: DatasetConfig,
    device: Optional[str] = None,
    seed: Optional[int] = 0,
) -> EMSANet:
    """The training model on `device` (default 'cuda', which must exist),
    in train mode, with float32 parameters (cast to `cfg.compute_dtype`
    at use), initialized as the reference initializes its model, drawn
    from `seed` (`weights.reference_init_`; seed=None keeps the module
    defaults)."""
    from emsanet_tpu_torch.weights import reference_init_

    dev = resolve_device(device)
    model = EMSANet(cfg, dataset_config, train=True)
    if seed is not None:
        reference_init_(model, seed)
    model = model.to(device=dev, memory_format=torch.channels_last)
    return model.train()
