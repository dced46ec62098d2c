"""Configuration of the PyTorch/CUDA port.

A copy of the `ModelConfig`, `DataConfig` and `TrainConfig` fields that
the inference frame and the training step read (counterpart:
`emsanet_tpu/config.py`). Field names and defaults are the same.
`fused_inference` (default False, as there) sends inference through the
kernels: the stems, the stride-1 NBt1D chains, the polyphase x2
upsamplings and, with `head_decode_fusion`, the heads' decode kernels;
without it the model runs its modules one by one (the JAX package's
default forward) and postprocessing takes the full-resolution maps.
`decoder_megakernel` ('auto', 'on' or 'off') decides, as in the
reference, whether every dense decoder's trunk runs as one call
(`ops/decoder_trunk.py`): 'auto' where the context output lies on the
card and the batch is at most `decoder_trunk.MAX_BATCH` (the reference:
on a TPU), 'on' at any batch and on the CPU too (through the plain
version, as the reference's interpret mode), 'off' never. Training
ignores it, as the reference does.
`EMSANetConfig.validate` applies the reference's post-parse rules that
training needs (task weighting, learning-rate scaling by batch size / 8,
the shared pretrained-backbone path, the scene-label polarity, forced
raw depth, the validation split of NYUv2 and SUNRGB-D, the validation
input size and batch size defaults). `best_head_decode_fusion` is the reference's mode
choice per batch size.

`validate_for_port` checks every value against the JAX package's
registries and applies its model rules (one modality forces
`encoder_fusion='none'`, a decoder other than 'emsanet' trains without
multiscale supervision). `validate_train_for_port` refuses batch sizes
that do not divide over `n_devices` ranks, with `main.py`'s message.
Neither falls back to another path.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

KNOWN_TASKS = ("semantic", "instance", "orientation", "scene", "normal")
KNOWN_MODALITIES = ("rgb", "depth", "rgbd")
# '-d16' may follow each name (backbone.get_backbone_spec)
KNOWN_BACKBONES = ("resnet18", "resnet34", "resnet50", "resnet101",
                   "resnet18se", "resnet34se")
KNOWN_BLOCKS = ("basicblock", "bottleneck", "nonbottleneck1d")
KNOWN_CONTEXT_MODULES = ("ppm", "appm", "ppm-1-2-4-8", "appm-1-2-4-8", "none")
KNOWN_ENCODER_FUSIONS = ("se-add-uni-rgb", "se-add-uni-depth", "add-uni-rgb",
                         "add-uni-depth", "none")
KNOWN_ENCODER_DECODER_FUSIONS = ("add-rgb", "add-depth", "add-rgbd", "none")
KNOWN_UPSAMPLINGS = ("learned-3x3-zeropad", "learned-3x3", "bilinear",
                     "nearest")
KNOWN_DECODERS = ("emsanet", "segformermlp")
KNOWN_ACTIVATIONS = ("relu", "swish", "silu")
KNOWN_NORMALIZATIONS = ("batchnorm", "layernorm", "groupnorm")
DENSE_TASKS = ("semantic", "instance", "normal")
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
    rgbd_encoder_backbone: str = "resnet34"
    rgbd_encoder_backbone_block: str = "nonbottleneck1d"
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
    semantic_decoder_dropout_p: float = 0.1  # segformermlp only
    semantic_decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    semantic_decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    semantic_decoder_upsampling: str = "learned-3x3-zeropad"
    semantic_encoder_decoder_fusion: str = "add-rgb"

    instance_decoder: str = "emsanet"
    instance_decoder_block: str = "nonbottleneck1d"
    instance_decoder_block_dropout_p: float = 0.2
    instance_decoder_n_blocks: int = 3
    instance_decoder_dropout_p: float = 0.1
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
    normal_decoder_block: str = "nonbottleneck1d"
    normal_decoder_block_dropout_p: float = 0.2
    normal_decoder_n_blocks: int = 3
    normal_decoder_dropout_p: float = 0.1
    normal_decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    normal_decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    normal_decoder_upsampling: str = "learned-3x3-zeropad"
    normal_encoder_decoder_fusion: str = "add-rgb"
    no_zero_init_decoder_residuals: bool = False
    semantic_no_multiscale_supervision: bool = False
    instance_no_multiscale_supervision: bool = False
    normal_no_multiscale_supervision: bool = False

    # ImageNet-pretrained encoder backbones (torchvision ResNet files);
    # the shared path fills each modality's that is not given
    encoder_backbone_pretrained_weights_filepath: Optional[str] = None
    rgb_encoder_backbone_pretrained_weights_filepath: Optional[str] = None
    depth_encoder_backbone_pretrained_weights_filepath: Optional[str] = None
    rgbd_encoder_backbone_pretrained_weights_filepath: Optional[str] = None

    compute_dtype: str = "float32"
    # training: recompute each encoder stage and each decoder module in
    # the backward pass (`torch.utils.checkpoint`), keeping only their
    # inputs; the BatchNorms' running statistics update once
    remat: bool = False
    fused_inference: bool = False
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

    def task_multiscale_supervision(self, task: str) -> bool:
        """Whether a dense task's decoder trains with side outputs: an
        'emsanet' decoder without its `*_no_multiscale_supervision`."""
        return (task in DENSE_TASKS and task in self.tasks
                and getattr(self, f"{task}_decoder") == "emsanet"
                and not getattr(self, f"{task}_no_multiscale_supervision"))

    def task_side_output_downscales(self, task: str) -> Tuple[int, ...]:
        """Downscales of a task decoder's side outputs: each module emits
        one at the scale it receives, (16, 8, 4) -> (32, 16, 8); none
        without multiscale supervision."""
        if not self.task_multiscale_supervision(task):
            return ()
        return tuple(2 * d for d in
                     getattr(self, f"{task}_decoder_downsamplings"))

    @property
    def side_output_downscales(self) -> Tuple[int, ...]:
        """Union over the tasks: the `_down_{s}` targets to generate."""
        scales = set()
        for task in DENSE_TASKS:
            scales.update(self.task_side_output_downscales(task))
        return tuple(sorted(scales, reverse=True))


@dataclass
class DataConfig:
    """Dataset, loader and augmentation fields."""

    dataset: str = "nyuv2"  # 'a[cam1,cam2]:b' joins datasets
    dataset_path: Optional[str] = None  # one path, or one per dataset
    split: str = "train"
    validation_split: str = "valid"  # nyuv2 / sunrgbd: 'test'
    raw_depth: bool = False
    aug_scale_min: float = 1.0
    aug_scale_max: float = 1.4
    disable_color_flip_aug: bool = False
    batch_size: int = 8
    validation_batch_size: Optional[int] = None  # 3 * batch_size
    n_workers: int = 8
    # 'thread', or 'process' (workers from a forkserver, away from CUDA)
    worker_mode: str = "thread"
    # one fraction, or one per concatenated dataset
    subset_train: Union[float, Tuple[float, ...]] = 1.0
    subset_deterministic: bool = False
    cache_dataset: bool = False
    scannet_semantic_n_classes: int = 40
    scannet_subsample: int = 50
    validation_scannet_subsample: int = 100
    hypersim_subsample: int = 1
    # recorded only (as in the JAX package): a prepared dataset carries
    # its depth statistics in meta.json; the first warns
    hypersim_use_old_depth_stats: bool = False
    sunrgbd_depth_do_not_force_mm: bool = False
    sunrgbd_instances_version: str = "panopticndt"
    # the indoor-domestic scene labels are the default;
    # `use_original_scene_labels` keeps each dataset's own
    use_original_scene_labels: bool = False
    scene_use_indoor_domestic_labels: bool = True
    validation_scannet_benchmark_mode: bool = False
    validation_full_resolution: bool = False
    validation_input_height: Optional[int] = None  # the input height
    validation_input_width: Optional[int] = None
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
    normal_loss: str = "l1"  # the masked L1 (losses.l1_normal), the only one
    semantic_loss_label_smoothing: float = 0.0
    scene_loss_label_smoothing: float = 0.0
    # validation and checkpoints (`main.py`'s loop)
    validation_skip: float = 0.0
    validation_force_interval: int = 20
    checkpointing_metrics: Tuple[str, ...] = ()
    checkpointing_best_only: bool = False
    checkpointing_skip: float = 0.0
    resume_ckpt_interval: int = 20
    resume_ckpt_filepath: Optional[str] = None
    weights_filepath: Optional[str] = None
    overfit_n_batches: int = -1
    validation_on_train: bool = False
    skip_sanity_check: bool = False
    validation_only: bool = False
    visualize_validation: bool = False
    visualization_output_path: Optional[str] = None
    results_basepath: str = "./results"
    seed: int = 0
    n_devices: Optional[int] = None
    mixed_precision: bool = False
    # the run's bookkeeping, recorded into args.json
    hostname: str = ""
    notes: str = ""
    disable_progress_bars: bool = False
    debug: bool = False


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
        if m.encoder_backbone_pretrained_weights_filepath:
            for mod in ("rgb", "depth", "rgbd"):
                key = f"{mod}_encoder_backbone_pretrained_weights_filepath"
                if getattr(m, key) is None:
                    setattr(m, key,
                            m.encoder_backbone_pretrained_weights_filepath)
        if d.use_original_scene_labels:
            d.scene_use_indoor_domestic_labels = False
        if d.hypersim_use_old_depth_stats:
            warnings.warn(
                "hypersim_use_old_depth_stats: v030 depth stats are not "
                "vendorable offline; the prepared meta.json stats are used "
                "instead (weights trained before Apr 2022 may need manual "
                "depth-stat overrides).")
        t.learning_rate = t.learning_rate * d.batch_size / 8
        main_dataset = d.dataset.split(":")[0].split("[")[0]
        if main_dataset in ("cityscapes", "hypersim", "scannet"):
            d.raw_depth = True
        if main_dataset in ("nyuv2", "sunrgbd") and (
                d.validation_split == "valid"):
            d.validation_split = "test"
        if d.validation_input_height is None:
            d.validation_input_height = m.input_height
        if d.validation_input_width is None:
            d.validation_input_width = m.input_width
        if t.mixed_precision and m.compute_dtype == "float32":
            m.compute_dtype = "bfloat16"  # parameters stay float32
        if d.validation_batch_size is None:
            d.validation_batch_size = 3 * d.batch_size
        return self


class NotPortedError(NotImplementedError):
    """A setting the port does not run yet (a refusal, not a fallback)."""


def _check(value, known, what: str) -> None:
    if value not in known:
        raise ValueError(f"Unknown {what} '{value}', known: {known}")


def validate_for_port(cfg: ModelConfig) -> ModelConfig:
    """Check `cfg` against the JAX package's registries and apply its model
    rules (`emsanet_tpu/config.py:439-485`) in place; raise on a value
    it does not know. The port trains every setting it builds."""
    from emsanet_tpu_torch.models.backbone import get_backbone_spec

    for task in cfg.tasks:
        _check(task, KNOWN_TASKS, "task")
    if not cfg.input_modalities:
        raise ValueError("input_modalities must name at least one modality")
    for mod in cfg.input_modalities:
        _check(mod, KNOWN_MODALITIES, "input modality")
    if "orientation" in cfg.tasks and "instance" not in cfg.tasks:
        raise ValueError("Task 'orientation' requires task 'instance'.")
    if cfg.enable_panoptic and not (
        "semantic" in cfg.tasks and "instance" in cfg.tasks
    ):
        raise ValueError(
            "Panoptic segmentation requires both 'semantic' and "
            "'instance' tasks."
        )
    # one modality: nothing to fuse (the reference's args.py:1317-1321)
    if len(cfg.input_modalities) == 1 and cfg.encoder_fusion != "none":
        cfg.encoder_fusion = "none"
    _check(cfg.head_decode_fusion, HEAD_DECODE_FUSIONS, "head_decode_fusion")
    _check(cfg.decoder_megakernel, ("off", "on", "auto"),
           "decoder_megakernel")
    _check(cfg.activation, KNOWN_ACTIVATIONS, "activation")
    _check(cfg.encoder_normalization, KNOWN_NORMALIZATIONS, "normalization")
    _check(cfg.decoder_normalization, KNOWN_NORMALIZATIONS, "normalization")
    for mod in KNOWN_MODALITIES:
        get_backbone_spec(getattr(cfg, f"{mod}_encoder_backbone"))
        _check(getattr(cfg, f"{mod}_encoder_backbone_block"), KNOWN_BLOCKS,
               "block")
    _check(cfg.encoder_fusion, KNOWN_ENCODER_FUSIONS, "encoder_fusion")
    _check(cfg.context_module, KNOWN_CONTEXT_MODULES, "context module")
    _check(cfg.upsampling_context_module, ("nearest", "bilinear"),
           "context upsampling")
    _check(cfg.upsampling_prediction, KNOWN_UPSAMPLINGS, "upsampling")
    for task in DENSE_TASKS:
        _check(getattr(cfg, f"{task}_decoder"), KNOWN_DECODERS, "decoder")
        _check(getattr(cfg, f"{task}_decoder_block"), KNOWN_BLOCKS, "block")
        _check(getattr(cfg, f"{task}_decoder_upsampling"), KNOWN_UPSAMPLINGS,
               "upsampling")
        _check(getattr(cfg, f"{task}_encoder_decoder_fusion"),
               KNOWN_ENCODER_DECODER_FUSIONS, "encoder-decoder fusion")
        # no side outputs to supervise (the reference's args.py:1382-1398)
        if getattr(cfg, f"{task}_decoder") != "emsanet":
            setattr(cfg, f"{task}_no_multiscale_supervision", True)
    _check(cfg.compute_dtype, ("float32", "bfloat16"), "compute_dtype")
    return cfg


KNOWN_OPTIMIZERS = ("sgd", "adam", "adamw", "radam")


def validate_train_for_port(cfg: EMSANetConfig) -> EMSANetConfig:
    """`cfg.validate()`, then refuse what the port's training does not
    run yet."""
    cfg.validate()
    validate_for_port(cfg.model)
    d, t = cfg.data, cfg.train
    if (t.n_devices or 1) > 1:  # fail before any set-up (main.py:175-186)
        from emsanet_tpu_torch.parallel.mesh import check_batch_sizes

        check_batch_sizes(d.batch_size, d.validation_batch_size, t.n_devices)
    if t.optimizer not in KNOWN_OPTIMIZERS:
        raise ValueError(f"Unknown optimizer: '{t.optimizer}'")
    if t.learning_rate_scheduler != "onecycle":
        raise ValueError(f"Unknown learning rate scheduler: "
                         f"'{t.learning_rate_scheduler}'")
    if t.instance_center_loss not in ("mse", "bce"):
        raise ValueError(f"Unknown instance center loss: "
                         f"'{t.instance_center_loss}'")
    if t.normal_loss != "l1":
        raise ValueError(f"Unknown normal loss: '{t.normal_loss}'")
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
    panoptic on, as the deployed frame runs it (`bench.py`'s default:
    `fused_inference=True`), with `overrides` set and the config
    validated."""
    cfg = ModelConfig(
        tasks=("semantic", "instance", "orientation", "scene"),
        enable_panoptic=True, fused_inference=True,
    )
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise ValueError(f"Unknown ModelConfig field '{key}'")
        setattr(cfg, key, value)
    return validate_for_port(cfg)
