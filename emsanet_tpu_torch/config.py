"""Configuration of the PyTorch/CUDA port.

A copy of the `ModelConfig`, `DataConfig` and `TrainConfig` fields that
the inference frame and the training step read (counterpart:
`emsanet_tpu/config.py`). Field names and defaults are the same, except
`fused_inference` (True: the only inference path ported).
`decoder_megakernel` ('auto', 'on' or 'off') decides, as in the
reference, whether every dense decoder's trunk runs as one call
(`ops/decoder_trunk.py`): 'auto' where the context output lies on the
card and the batch is at most `decoder_trunk.MAX_BATCH` (the reference:
on a TPU), 'on' at any batch and on the CPU too (through the plain
version, as the reference's interpret mode), 'off' never. Training
ignores it, as the reference does.
`EMSANetConfig.validate` applies the reference's post-parse rules that
training needs (task weighting, learning-rate scaling by batch size / 8,
forced raw depth). `best_head_decode_fusion` is the reference's mode
choice per batch size.

`validate_for_port` and `validate_train_for_port` refuse, with a "not
ported yet" error, every setting this package does not run yet. They
never fall back to another path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
    semantic_decoder_block_dropout_p: float = 0.2
    semantic_decoder_n_blocks: int = 3
    semantic_decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    semantic_decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    semantic_decoder_upsampling: str = "learned-3x3-zeropad"
    semantic_encoder_decoder_fusion: str = "add-rgb"

    instance_decoder: str = "emsanet"
    instance_decoder_block: str = "nonbottleneck1d"
    instance_decoder_block_dropout_p: float = 0.2
    instance_decoder_n_blocks: int = 3
    instance_decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    instance_decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    instance_decoder_upsampling: str = "learned-3x3-zeropad"
    instance_encoder_decoder_fusion: str = "add-rgb"
    instance_center_sigma: int = 8
    instance_center_heatmap_threshold: float = 0.1
    instance_center_heatmap_nms_kernel_size: int = 17
    instance_center_heatmap_apply_foreground_mask: bool = False
    instance_center_heatmap_top_k: int = 64
    instance_center_encoding: str = "sigmoid"
    instance_offset_encoding: str = "tanh"
    instance_offset_distance_threshold: Optional[int] = None

    normal_decoder: str = "emsanet"
    no_zero_init_decoder_residuals: bool = False
    semantic_no_multiscale_supervision: bool = False
    instance_no_multiscale_supervision: bool = False

    compute_dtype: str = "float32"
    fused_inference: bool = True
    # training: stride-1 NBt1D tails through the pair kernels
    # (ops/nbt1d_train.py) and, with fused_train_head, the semantic head's
    # final x2 stage + CE through the head-loss kernels
    # (ops/semantic_train_head.py)
    fused_training: bool = False
    fused_train_head: bool = True
    train_polyphase_upsampling: bool = False
    head_decode_fusion: str = "decode"
    decoder_megakernel: str = "auto"

    @property
    def instance_normalized_offset(self) -> bool:
        return self.instance_offset_encoding in ("tanh", "relative")

    @property
    def instance_tanh_for_offset(self) -> bool:
        return self.instance_offset_encoding == "tanh"

    @property
    def instance_sigmoid_for_center(self) -> bool:
        return self.instance_center_encoding == "sigmoid"

    def task_side_output_downscales(self, task: str) -> Tuple[int, ...]:
        """Downscales of a task decoder's side outputs: each module emits
        one at the scale it receives, (16, 8, 4) -> (32, 16, 8); none
        without multiscale supervision."""
        if task not in ("semantic", "instance") or task not in self.tasks:
            return ()
        if getattr(self, f"{task}_no_multiscale_supervision"):
            return ()
        return tuple(2 * d for d in
                     getattr(self, f"{task}_decoder_downsamplings"))

    @property
    def side_output_downscales(self) -> Tuple[int, ...]:
        """Union over the tasks: the `_down_{s}` targets to generate."""
        scales = set()
        for task in ("semantic", "instance"):
            scales.update(self.task_side_output_downscales(task))
        return tuple(sorted(scales, reverse=True))


@dataclass
class DataConfig:
    """Dataset and augmentation fields the training step reads."""

    dataset: str = "nyuv2"
    split: str = "train"
    raw_depth: bool = False
    aug_scale_min: float = 1.0
    aug_scale_max: float = 1.4
    disable_color_flip_aug: bool = False
    batch_size: int = 8
    n_workers: int = 8
    class_weighting: str = "median-frequency"
    class_weighting_c: float = 1.02
    synthetic_n_samples: int = 16


@dataclass
class TrainConfig:
    """Optimization fields of the training step."""

    n_epochs: int = 500
    optimizer: str = "sgd"
    learning_rate: float = 0.01  # scaled by batch_size / 8 in validate()
    learning_rate_scheduler: str = "onecycle"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    tasks_weighting: Optional[Tuple[float, ...]] = None
    instance_weighting: Tuple[float, float] = (2.0, 1.0)
    instance_center_loss: str = "mse"
    orientation_kappa: float = 1.0
    semantic_loss_label_smoothing: float = 0.0
    scene_loss_label_smoothing: float = 0.0
    seed: int = 0
    n_devices: Optional[int] = None
    mixed_precision: bool = False


@dataclass
class EMSANetConfig:
    """Model, data and training configuration, with the reference's
    post-parse rules applied once by `validate`."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    _validated: bool = field(default=False, repr=False, compare=False)

    def validate(self) -> "EMSANetConfig":
        if self._validated:  # the learning-rate scaling applies once
            return self
        self._validated = True
        m, d, t = self.model, self.data, self.train
        if t.tasks_weighting is None:
            t.tasks_weighting = tuple(1.0 for _ in m.tasks)
        if len(t.tasks_weighting) != len(m.tasks):
            raise ValueError(
                f"tasks_weighting has {len(t.tasks_weighting)} entries but "
                f"{len(m.tasks)} tasks are enabled.")
        t.learning_rate = t.learning_rate * d.batch_size / 8
        if d.dataset.split(":")[0].split("[")[0] in ("cityscapes",
                                                     "hypersim", "scannet"):
            d.raw_depth = True
        if t.mixed_precision and m.compute_dtype == "float32":
            m.compute_dtype = "bfloat16"  # parameters stay float32
        return self


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
    if train and cfg.train_polyphase_upsampling:
        _refuse("train_polyphase_upsampling=True")
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
    if cfg.decoder_megakernel not in ("off", "on", "auto"):
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


KNOWN_OPTIMIZERS = ("sgd", "adam", "adamw", "radam")


def validate_train_for_port(cfg: EMSANetConfig) -> EMSANetConfig:
    """`cfg.validate()`, then refuse what the port's training does not
    run yet."""
    cfg.validate()
    validate_for_port(cfg.model, train=True)
    d, t = cfg.data, cfg.train
    if (t.n_devices or 1) > 1:
        _refuse(f"n_devices={t.n_devices} (data parallel training)")
    if d.dataset != "synthetic":
        _refuse(f"dataset '{d.dataset}' (only 'synthetic' has a loader)")
    if t.optimizer not in KNOWN_OPTIMIZERS:
        raise ValueError(f"Unknown optimizer: '{t.optimizer}'")
    if t.learning_rate_scheduler != "onecycle":
        raise ValueError(f"Unknown learning rate scheduler: "
                         f"'{t.learning_rate_scheduler}'")
    if t.instance_center_loss not in ("mse", "bce"):
        raise ValueError(f"Unknown instance center loss: "
                         f"'{t.instance_center_loss}'")
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
