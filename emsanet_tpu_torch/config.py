"""Model configuration of the PyTorch/CUDA port.

A copy of the `ModelConfig` fields that the inference frame reads
(counterpart: `emsanet_tpu/config.py::ModelConfig`). Field names and defaults are
the same, except `fused_inference` (True: the only inference path
ported) and `decoder_megakernel` ('off': the decoder megakernel is not
ported yet).
`best_head_decode_fusion` is the reference's mode choice per batch size.

`validate_for_port` refuses, with a "not ported yet" error, every
setting this package does not run yet. It never falls back to another
path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

KNOWN_TASKS = ("semantic", "instance", "orientation", "scene", "normal")
HEAD_DECODE_FUSIONS = ("interleave", "decode", "decode-both", "decode-planes")


@dataclass
class ModelConfig:
    """Model topology. Defaults = EMSANet-R34-NBt1D."""

    tasks: Tuple[str, ...] = ("semantic",)
    input_modalities: Tuple[str, ...] = ("rgb", "depth")
    enable_panoptic: bool = False
    input_height: int = 480
    input_width: int = 640
    activation: str = "relu"
    dropout_p: float = 0.1

    rgb_encoder_backbone: str = "resnet34"
    rgb_encoder_backbone_block: str = "nonbottleneck1d"
    depth_encoder_backbone: str = "resnet34"
    depth_encoder_backbone_block: str = "nonbottleneck1d"
    encoder_normalization: str = "batchnorm"
    encoder_fusion: str = "se-add-uni-rgb"
    encoder_decoder_skip_downsamplings: Tuple[int, ...] = (4, 8, 16)
    he_init: Tuple[str, ...] = ("encoder-fusion",)

    context_module: str = "ppm"
    upsampling_context_module: str = "bilinear"

    upsampling_prediction: str = "learned-3x3-zeropad"
    decoder_normalization: str = "batchnorm"

    semantic_decoder: str = "emsanet"
    semantic_decoder_block: str = "nonbottleneck1d"
    semantic_decoder_n_blocks: int = 3
    semantic_decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    semantic_decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    semantic_decoder_upsampling: str = "learned-3x3-zeropad"
    semantic_encoder_decoder_fusion: str = "add-rgb"

    instance_decoder: str = "emsanet"
    instance_decoder_block: str = "nonbottleneck1d"
    instance_decoder_n_blocks: int = 3
    instance_decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    instance_decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    instance_decoder_upsampling: str = "learned-3x3-zeropad"
    instance_encoder_decoder_fusion: str = "add-rgb"
    instance_center_heatmap_threshold: float = 0.1
    instance_center_heatmap_nms_kernel_size: int = 17
    instance_center_heatmap_apply_foreground_mask: bool = False
    instance_center_heatmap_top_k: int = 64
    instance_center_encoding: str = "sigmoid"
    instance_offset_encoding: str = "tanh"
    instance_offset_distance_threshold: Optional[int] = None

    normal_decoder: str = "emsanet"
    no_zero_init_decoder_residuals: bool = False

    compute_dtype: str = "float32"
    fused_inference: bool = True
    head_decode_fusion: str = "decode"
    decoder_megakernel: str = "off"

    @property
    def instance_normalized_offset(self) -> bool:
        return self.instance_offset_encoding in ("tanh", "relative")

    @property
    def instance_tanh_for_offset(self) -> bool:
        return self.instance_offset_encoding == "tanh"

    @property
    def instance_sigmoid_for_center(self) -> bool:
        return self.instance_center_encoding == "sigmoid"


class NotPortedError(NotImplementedError):
    """A setting the port does not run yet (a refusal, not a fallback)."""


def _refuse(what: str) -> None:
    raise NotPortedError(f"not ported yet: {what}")


def validate_for_port(cfg: ModelConfig, train: bool = False) -> ModelConfig:
    """Check `cfg` against what this package runs; raise otherwise."""
    for task in cfg.tasks:
        if task not in KNOWN_TASKS:
            raise ValueError(f"Unknown task '{task}', known: {KNOWN_TASKS}")
    if "orientation" in cfg.tasks and "instance" not in cfg.tasks:
        raise ValueError("Task 'orientation' requires task 'instance'.")
    if cfg.enable_panoptic and not (
        "semantic" in cfg.tasks and "instance" in cfg.tasks
    ):
        raise ValueError(
            "Panoptic segmentation requires both 'semantic' and "
            "'instance' tasks."
        )
    if train:
        _refuse("training")
    if "normal" in cfg.tasks:
        _refuse("the normal decoder")
    for task in ("semantic", "instance"):
        if task in cfg.tasks and getattr(cfg, f"{task}_decoder") != "emsanet":
            _refuse(f"{task}_decoder='{getattr(cfg, f'{task}_decoder')}' "
                    "(segformermlp)")
    if tuple(cfg.input_modalities) != ("rgb", "depth"):
        _refuse(f"input_modalities={tuple(cfg.input_modalities)} (only "
                "the dual rgb+depth encoder is ported)")
    if cfg.head_decode_fusion not in HEAD_DECODE_FUSIONS:
        raise ValueError(
            f"head_decode_fusion must be one of {HEAD_DECODE_FUSIONS}, got "
            f"'{cfg.head_decode_fusion}'"
        )
    if cfg.decoder_megakernel == "on":
        _refuse("decoder_megakernel='on'")
    if cfg.decoder_megakernel not in ("off", "auto"):
        raise ValueError(
            f"decoder_megakernel must be 'off', 'on' or 'auto', got "
            f"'{cfg.decoder_megakernel}'"
        )
    if not cfg.fused_inference:
        _refuse("fused_inference=False")
    if cfg.activation != "relu":
        _refuse(f"activation='{cfg.activation}'")
    if "batchnorm" != cfg.encoder_normalization or (
        "batchnorm" != cfg.decoder_normalization
    ):
        _refuse("normalizations other than batchnorm")
    for mod in ("rgb", "depth"):
        backbone = getattr(cfg, f"{mod}_encoder_backbone")
        block = getattr(cfg, f"{mod}_encoder_backbone_block")
        if backbone not in ("resnet18", "resnet34"):
            _refuse(f"{mod}_encoder_backbone='{backbone}'")
        if block not in ("nonbottleneck1d", "basicblock"):
            _refuse(f"{mod}_encoder_backbone_block='{block}'")
    for task in ("semantic", "instance"):
        if getattr(cfg, f"{task}_decoder_block") != "nonbottleneck1d":
            _refuse(f"{task}_decoder_block other than nonbottleneck1d")
    if cfg.encoder_fusion not in ("se-add-uni-rgb", "se-add-uni-depth",
                                  "add-uni-rgb", "add-uni-depth", "none"):
        raise ValueError(f"Unknown encoder_fusion '{cfg.encoder_fusion}'")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"'{cfg.compute_dtype}'")
    return cfg


def best_head_decode_fusion(batch_size: int,
                            with_postprocessing: bool = True) -> str:
    """The reference's `head_decode_fusion` for a batch size
    (`emsanet_tpu/config.py::best_head_decode_fusion`, copied as it
    stands): 'decode-planes' below batch 16, 'decode' from 16 up, and
    'interleave' without postprocessing (the heads then stay in the
    forward, for forward-only protocol runs).

    The thresholds were measured on a TPU by the reference, not on the
    port's card; PERF.md records what the H100 shows per mode.
    """
    if not with_postprocessing:
        return "interleave"
    if batch_size >= 16:
        return "decode"
    return "decode-planes"


def flagship_config(**overrides) -> ModelConfig:
    """EMSANet-R34-NBt1D, tasks semantic+instance+orientation+scene,
    panoptic on, in the configuration this package runs."""
    cfg = ModelConfig(
        tasks=("semantic", "instance", "orientation", "scene"),
        enable_panoptic=True,
    )
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise ValueError(f"Unknown ModelConfig field '{key}'")
        setattr(cfg, key, value)
    return validate_for_port(cfg)
