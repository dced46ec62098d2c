"""Train and validate the port's EMSANet on one GPU.

    python -m emsanet_tpu_torch.train --dataset nyuv2 \\
        --dataset-path datasets/nyuv2 --n-epochs 500 \\
        --tasks semantic instance orientation scene --enable-panoptic \\
        --mixed-precision --fused-training --results-basepath /tmp/runs

Counterpart of the repository's `main.py` (:78-425). A run directory
`<results-basepath>/<dataset>/run_<timestamp>/` gets `args.json`,
`argsv.txt`, `checkpoints/`, `examples/`, `artifacts/` (each helper's
artifacts per validation, as `.npy`), `metrics.csv` (one row per
epoch), `error.log` and an error checkpoint when an epoch raises, and a
`finished` marker at the end. Before training, one step runs on a copy
of the model and the optimizer (the sanity check; `--skip-sanity-check`
skips it). Each epoch sets the OneCycle learning rate, trains (a dropout generator per step,
seeded from (seed + 1, epoch * 100003 + step)), validates where
`main.py`'s rule says so (from `--validation-skip` x epochs on, every
`--validation-force-interval` epochs, and at the last), keeps a
checkpoint per improved `--checkpointing-metrics` entry, a resume
checkpoint every `--resume-ckpt-interval` epochs and at the end, and
prints one JSON line of its logs. Validation runs the eval step (the
forward in eval mode and the postprocessing on the device, the heads as
`--head-decode-fusion` says; 'auto' picks the reference's mode for the
validation batch) and the task helpers' metrics on the host.
`--validation-only` validates once and stops; `--resume-ckpt-filepath`
continues a run from its checkpoint, `--weights-filepath` starts from a
checkpoint's model weights. `--validation-on-train` with
`--overfit-n-batches` validates on the overfit subset of the train data.

Data: `--dataset` names one dataset or several joined by ':', each with
an optional camera list ('sunrgbd[kv1,kv2]:nyuv2'), `--dataset-path` the
prepared directories (one, or one per dataset); 'synthetic' needs none.
The label tables come from the first dataset's `meta.json` where it has
one. SUNRGB-D first among other datasets maps its classes 38-40 to void
(`main.py`'s `sunrgbd_combined`). The semantic class weights are computed
from the train data. Validation runs every camera's loader into one set
of task helpers; `--validation-full-resolution` validates each sample at
its own size, padded to a multiple of 32. `--*-encoder-backbone-
pretrained-weights-filepath` initializes an encoder backbone from a
torchvision ResNet file, and `--weights-filepath` loads a port
checkpoint or a JAX package checkpoint through the transfer rules of
`weights.merge_loaded_params` (other class counts, tasks).

`--visualize-validation` draws the first validation batch's predictions
and ground truth into `examples/epoch_XXXX/` (or
`--visualization-output-path`), as `main.py` does.

Flags take `emsanet_tpu/utils/cli.py`'s names, every one of them
(modalities, backbones and blocks, activation, normalizations, context,
every decoder's type, blocks, widths, fusion and upsampling, the
instance head, the deprecated aliases, the run's bookkeeping);
`--fused-inference` sends validation through the kernels, as there.
`--config FILE` makes a JSON file's values (configs/*.json) the
defaults that explicit flags override; `resume <run_dir> [flags]`
replays the run's `argsv.txt` with its `checkpoints/ckpt_resume.pt`.
`--remat` recomputes each encoder stage and decoder module in the
backward pass (`torch.utils.checkpoint`; the BatchNorms' running
statistics update once). `--hostname` and `--notes` go into args.json;
`--debug` and `--disable-progress-bars` are recorded and change
nothing (the trainer prints one line per epoch). `--wandb-mode online|
offline` logs to wandb as `main.py` does (`start_wandb`: imported only
then; if it is missing or fails to start, one line says so and the run
goes on). It runs on the card unless `--device cpu` is given, and
raises without one.

Data parallel (`main.py:166-223`, `parallel/mesh.py`): `--n-devices N`
spawns N ranks, one card each over NCCL (`--device cpu`: N CPU ranks
over gloo, at most 8, as the JAX package's virtual CPU devices), joined
through a file store; more ranks than cards raise, as `create_mesh` does.
`--distributed` joins a group that torchrun started (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), one card per rank. Both batch
sizes must be multiples of the ranks (`main.py`'s check and message).
Each rank loads its rows of every global batch, trains on them with the
gradients, BatchNorm running statistics and losses averaged over the
ranks (`training/step.py`), and validates them; rank 0 gathers the
predictions and the ground truth and alone runs the task helpers, so
its logs equal one process's over the same batches. Only rank 0 writes
the run directory, the CSV, the checkpoints (then a barrier) and the
visualizations, and prints; every rank loads the weights, the resume
checkpoint, and then takes rank 0's parameters and buffers.
Without `--n-devices` one process trains (the JAX package's default is
every local device).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import json
import os
import socket
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emsanet_tpu_torch.config import (
    DENSE_TASKS,
    KNOWN_ACTIVATIONS,
    KNOWN_BLOCKS,
    KNOWN_CONTEXT_MODULES,
    KNOWN_DECODERS,
    KNOWN_ENCODER_DECODER_FUSIONS,
    KNOWN_ENCODER_FUSIONS,
    KNOWN_MODALITIES,
    KNOWN_NORMALIZATIONS,
    KNOWN_TASKS,
    KNOWN_UPSAMPLINGS,
    DataConfig,
    EMSANetConfig,
    ModelConfig,
    TrainConfig,
    best_head_decode_fusion,
    validate_train_for_port,
)
from emsanet_tpu_torch.data import DataHelper, get_datahelper
from emsanet_tpu_torch.datasets.metadata import DatasetConfig
from emsanet_tpu_torch.datasets.registry import (
    get_dataset_config,
    parse_datasets,
)
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.models.emsanet import build_train_model
from emsanet_tpu_torch.parallel import mesh as mesh_ops
from emsanet_tpu_torch.parallel.mesh import Mesh
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
from emsanet_tpu_torch.task_helper import PREDICTION_KEYS, get_task_helpers
from emsanet_tpu_torch.training.checkpoint import (
    CheckpointHelper,
    load_checkpoint,
    save_checkpoint,
)
from emsanet_tpu_torch.training.csv_logger import CSVLogger
from emsanet_tpu_torch.training.lr_schedule import get_lr_fn
from emsanet_tpu_torch.training.optim import get_optimizer, set_learning_rate
from emsanet_tpu_torch.training.step import (
    extract_device_batch,
    make_eval_step,
    make_train_step,
)
from emsanet_tpu_torch.visualization import (
    ColorGenerators,
    visualize_batches,
    visualize_predictions,
)
from emsanet_tpu_torch.weights import (
    load_backbone_pretrained,
    load_weights_file,
)

EVAL_KEYS = ("rgb", "depth", "instance_foreground")  # the eval step's input
KNOWN_LR_SCHEDULERS = ("onecycle",)


def _subset_train(value: str):
    """'0.2', or one fraction per concatenated dataset: '0.2:1.0'."""
    parts = tuple(float(v) for v in value.split(":"))
    return parts[0] if len(parts) == 1 else parts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default=None,
                   help="JSON config file (configs/*.json); explicit flags "
                   "override its values")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results-basepath", default="./results")
    p.add_argument("--debug", action="store_true",
                   help="recorded into args.json; changes nothing else")
    p.add_argument("--hostname", default=socket.gethostname(),
                   help="recorded into args.json")
    p.add_argument("--notes", default="", help="recorded into args.json")
    p.add_argument("--disable-progress-bars", action="store_true",
                   help="recorded into args.json (the trainer prints one "
                   "line per epoch, and no progress bars)")
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--validation-only", action="store_true")
    p.add_argument("--visualize-validation", action="store_true")
    p.add_argument("--visualization-output-path", default=None,
                   help="where --visualize-validation writes (default: "
                   "the run directory's examples/)")
    p.add_argument("--wandb-mode", default="disabled",
                   choices=("online", "offline", "disabled"))
    p.add_argument("--wandb-project", default="EMSANet-TPU")
    p.add_argument("--wandb-name", default=None,
                   help="[DEPRECATED] use --wandb-project")
    _add_model_flags(p)
    p.add_argument("--mixed-precision", action="store_true")
    p.add_argument("--fused-training", action="store_true")
    p.add_argument("--fused-inference", action="store_true",
                   help="validation through the inference kernels (stems, "
                   "chains, polyphase upsampling, the heads' decode "
                   "kernels, the decoder trunk)")
    p.add_argument("--head-decode-fusion", default=None,
                   choices=("decode", "decode-both", "decode-planes",
                            "interleave", "auto"))
    p.add_argument("--n-epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--validation-batch-size", type=int, default=None)
    p.add_argument("--optimizer", default="sgd",
                   choices=("sgd", "adam", "adamw", "radam"))
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--learning-rate-scheduler", default="onecycle",
                   choices=KNOWN_LR_SCHEDULERS)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--tasks-weighting", nargs="+", type=float, default=None)
    p.add_argument("--instance-weighting", nargs=2, type=float,
                   default=(2.0, 1.0))
    p.add_argument("--instance-center-loss", default="mse",
                   choices=("mse", "bce"))
    p.add_argument("--orientation-kappa", type=float, default=1.0)
    p.add_argument("--normal-loss", default="l1", choices=("l1",))
    p.add_argument("--semantic-loss-label-smoothing", type=float,
                   default=0.0)
    p.add_argument("--scene-loss-label-smoothing", type=float, default=0.0)
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="[DEPRECATED] sets both per-task smoothings")
    weightings = ("median-frequency", "logarithmic", "linear", "none")
    p.add_argument("--semantic-class-weighting", default="median-frequency",
                   choices=weightings)
    p.add_argument("--semantic-class-weighting-logarithmic-c", type=float,
                   default=1.02)
    p.add_argument("--class-weighting", default=None, choices=weightings,
                   help="alias of --semantic-class-weighting; wins if given")
    p.add_argument("--class-weighting-c", type=float, default=None,
                   help="[DEPRECATED] --semantic-class-weighting-"
                   "logarithmic-c; wins if given")
    p.add_argument("--dataset", default="nyuv2")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--raw-depth", action="store_true")
    p.add_argument("--use-original-scene-labels", action="store_true")
    p.add_argument("--synthetic-n-samples", type=int, default=16)
    p.add_argument("--aug-scale-min", type=float, default=1.0)
    p.add_argument("--aug-scale-max", type=float, default=1.4)
    p.add_argument("--no-color-flip-aug", dest="disable_color_flip_aug",
                   action="store_true")
    p.add_argument("--n-workers", type=int, default=8)
    p.add_argument("--worker-mode", default="thread",
                   choices=("thread", "process"))
    p.add_argument("--subset-train", default=1.0, type=_subset_train)
    p.add_argument("--subset-deterministic", action="store_true")
    p.add_argument("--cache-dataset", action="store_true")
    p.add_argument("--scannet-semantic-n-classes", type=int, default=40,
                   choices=(20, 40, 200, 549))
    p.add_argument("--scannet-subsample", type=int, default=50)
    p.add_argument("--validation-scannet-subsample", type=int, default=100,
                   choices=(50, 100, 200, 500))
    p.add_argument("--hypersim-subsample", type=int, default=1)
    p.add_argument("--hypersim-use-old-depth-stats", action="store_true",
                   help="recorded; warns (the prepared meta.json holds the "
                   "depth statistics)")
    p.add_argument("--sunrgbd-depth-do-not-force-mm", action="store_true")
    p.add_argument("--sunrgbd-instances-version", default="panopticndt",
                   choices=("emsanet", "panopticndt", "anyold"))
    p.add_argument("--validation-split", default="valid")
    p.add_argument("--validation-input-height", type=int, default=None)
    p.add_argument("--validation-input-width", type=int, default=None)
    p.add_argument("--validation-full-resolution", action="store_true")
    p.add_argument("--validation-scannet-benchmark-mode",
                   action="store_true")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one device each")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun started (one "
                   "card per rank)")
    p.add_argument("--overfit-n-batches", type=int, default=-1)
    p.add_argument("--validation-on-train", action="store_true")
    p.add_argument("--validation-skip", type=float, default=0.0)
    p.add_argument("--validation-force-interval", type=int, default=20)
    p.add_argument("--checkpointing-metrics", nargs="+", default=())
    p.add_argument("--checkpointing-best-only", action="store_true")
    p.add_argument("--checkpointing-skip", type=float, default=0.0)
    p.add_argument("--resume-ckpt-interval", type=int, default=20)
    p.add_argument("--resume-ckpt-filepath", default=None)
    p.add_argument("--weights-filepath", default=None)
    return p


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    """The model group of `emsanet_tpu/utils/cli.py:70-230`."""
    p.add_argument("--tasks", nargs="+", default=("semantic",),
                   choices=KNOWN_TASKS)
    p.add_argument("--enable-panoptic", action="store_true")
    p.add_argument("--input-modalities", nargs="+", default=("rgb", "depth"),
                   choices=KNOWN_MODALITIES)
    p.add_argument("--input-height", type=int, default=480)
    p.add_argument("--input-width", type=int, default=640)
    p.add_argument("--activation", default="relu", choices=KNOWN_ACTIVATIONS)
    p.add_argument("--dropout-p", type=float, default=0.1)
    p.add_argument("--encoder-normalization", default="batchnorm",
                   choices=KNOWN_NORMALIZATIONS)
    p.add_argument("--encoder-fusion", default="se-add-uni-rgb",
                   choices=KNOWN_ENCODER_FUSIONS)
    for mod in KNOWN_MODALITIES:
        p.add_argument(f"--{mod}-encoder-backbone", default="resnet34",
                       help="resnet18/34/50/101, resnet18se/34se, each with "
                       "an optional '-d16'")
        p.add_argument(f"--{mod}-encoder-backbone-resnet-block",
                       default="nonbottleneck1d", choices=KNOWN_BLOCKS)
    p.add_argument("--no-pretrained-backbone", action="store_true",
                   help="no effect, as in main.py: a backbone starts from "
                   "pretrained weights exactly where a file is given")
    for what in ("", "rgb-", "depth-", "rgbd-"):
        p.add_argument(f"--{what}encoder-backbone-pretrained-weights-"
                       "filepath", default=None)
    p.add_argument("--he-init", nargs="+", default=("encoder-fusion",),
                   choices=("encoder-fusion", "encoder-decoder-fusion",
                            "context-module", "decoder"))
    p.add_argument("--no-zero-init-decoder-residuals", action="store_true")
    p.add_argument("--context-module", default="ppm",
                   choices=KNOWN_CONTEXT_MODULES)
    p.add_argument("--upsampling-context-module", default="bilinear",
                   choices=("nearest", "bilinear"))
    p.add_argument("--upsampling-prediction", default="learned-3x3-zeropad",
                   choices=KNOWN_UPSAMPLINGS)
    p.add_argument("--decoder-normalization", default="batchnorm",
                   choices=KNOWN_NORMALIZATIONS)
    p.add_argument("--encoder-decoder-skip-downsamplings", nargs="+",
                   type=int, default=(4, 8, 16))
    p.add_argument("--compute-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--remat", action="store_true",
                   help="recompute each encoder stage and decoder module "
                   "in the backward pass (torch.utils.checkpoint): less "
                   "activation memory for more compute")
    for task in DENSE_TASKS:
        p.add_argument(f"--{task}-decoder", default="emsanet",
                       choices=KNOWN_DECODERS)
        p.add_argument(f"--{task}-decoder-block", default="nonbottleneck1d",
                       choices=KNOWN_BLOCKS)
        p.add_argument(f"--{task}-decoder-block-dropout-p", type=float,
                       default=0.2)
        p.add_argument(f"--{task}-decoder-n-blocks", type=int, default=3)
        p.add_argument(f"--{task}-decoder-dropout-p", type=float,
                       default=0.1)
        p.add_argument(f"--{task}-decoder-n-channels", nargs="+", type=int,
                       default=(512, 256, 128))
        p.add_argument(f"--{task}-decoder-downsamplings", nargs="+",
                       type=int, default=(16, 8, 4))
        p.add_argument(f"--{task}-decoder-upsampling",
                       default="learned-3x3-zeropad",
                       choices=KNOWN_UPSAMPLINGS)
        p.add_argument(f"--{task}-encoder-decoder-fusion", default="add-rgb",
                       choices=KNOWN_ENCODER_DECODER_FUSIONS)
        p.add_argument(f"--{task}-no-multiscale-supervision",
                       action="store_true")
    # deprecated aliases (the reference's args.py:1268-1315 shim)
    p.add_argument("--encoder-decoder-fusion", default=None,
                   choices=KNOWN_ENCODER_DECODER_FUSIONS,
                   help="[DEPRECATED] sets every decoder's fusion")
    p.add_argument("--upsampling-decoder", default=None,
                   choices=KNOWN_UPSAMPLINGS,
                   help="[DEPRECATED] sets every decoder's upsampling")
    p.add_argument("--normalization", default=None,
                   choices=KNOWN_NORMALIZATIONS,
                   help="[DEPRECATED] sets the encoder's and decoders' "
                   "normalization")
    for mod in KNOWN_MODALITIES:
        p.add_argument(f"--{mod}-encoder-backbone-block", default=None,
                       choices=KNOWN_BLOCKS,
                       help=f"[DEPRECATED] --{mod}-encoder-backbone-resnet-"
                       "block; wins where given")
    p.add_argument("--instance-center-sigma", type=int, default=8)
    p.add_argument("--instance-center-heatmap-threshold", type=float,
                   default=0.1)
    p.add_argument("--instance-center-heatmap-nms-kernel-size", type=int,
                   default=17)
    p.add_argument("--instance-center-heatmap-apply-foreground-mask",
                   action="store_true")
    p.add_argument("--instance-center-heatmap-top-k", type=int, default=64)
    p.add_argument("--instance-center-encoding", default="sigmoid",
                   choices=("sigmoid", "none"))
    p.add_argument("--instance-offset-encoding", default="tanh",
                   choices=("tanh", "relative", "deeplab"))
    p.add_argument("--instance-offset-distance-threshold", type=int,
                   default=None)


def model_config_from_args(a: argparse.Namespace) -> ModelConfig:
    """The ModelConfig of the model flags, with the deprecated aliases
    applied as `emsanet_tpu/utils/cli.py::args_to_config` applies them."""
    kw = {f.name: getattr(a, f.name) for f in dataclasses.fields(ModelConfig)
          if getattr(a, f.name, None) is not None}
    if a.encoder_decoder_fusion:
        for task in DENSE_TASKS:
            kw[f"{task}_encoder_decoder_fusion"] = a.encoder_decoder_fusion
    if a.upsampling_decoder:
        for task in DENSE_TASKS:
            kw[f"{task}_decoder_upsampling"] = a.upsampling_decoder
    if a.normalization:
        kw["encoder_normalization"] = a.normalization
        kw["decoder_normalization"] = a.normalization
    for mod in KNOWN_MODALITIES:
        dep = getattr(a, f"{mod}_encoder_backbone_block")
        kw[f"{mod}_encoder_backbone_block"] = (
            dep if dep is not None
            else getattr(a, f"{mod}_encoder_backbone_resnet_block"))
    head_decode_fusion = a.head_decode_fusion or "decode"
    if head_decode_fusion == "auto":  # as emsanet_tpu/utils/cli.py
        head_decode_fusion = best_head_decode_fusion(
            a.validation_batch_size or a.batch_size)
    kw["head_decode_fusion"] = head_decode_fusion
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in kw.items()})


def resolve_argv(argv: Sequence[str]) -> List[str]:
    """`resume <run_dir> [flags]` -> the run's recorded `argsv.txt`, then
    `--resume-ckpt-filepath <run_dir>/checkpoints/ckpt_resume.pt`, then
    `flags` (`emsanet_tpu/utils/cli.py:437-442`); any other argv as it
    is."""
    argv = list(argv)
    if argv[:1] != ["resume"]:
        return argv
    if len(argv) < 2:
        raise SystemExit("usage: resume <run_dir> [flags]")
    run_dir = argv[1]
    with open(os.path.join(run_dir, "argsv.txt")) as fh:
        recorded = fh.read().split()
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt_resume.pt")
    return recorded + ["--resume-ckpt-filepath", ckpt] + argv[2:]


def parse_namespace(argv: Optional[Sequence[str]] = None
                    ) -> Tuple[argparse.Namespace, List[str]]:
    """(the flags, the argv parsed): `resume` resolved, and the values of
    a `--config` file made the parser's defaults, so that explicit flags
    override them; the file's keys that name no flag are dropped, as in
    `emsanet_tpu/utils/cli.py:445-458`."""
    argv = resolve_argv(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    if "--config" in argv:
        with open(argv[argv.index("--config") + 1]) as fh:
            file_cfg = json.load(fh)
        known = {a.dest for a in parser._actions}
        parser.set_defaults(**{
            k: tuple(v) if isinstance(v, list) else v
            for section in ("model", "data", "train")
            for k, v in file_cfg.get(section, {}).items() if k in known})
    return parser.parse_args(argv), argv


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> Tuple[EMSANetConfig, str, List[str]]:
    """(validated configuration, device name, the argv parsed)."""
    a, argv = parse_namespace(argv)
    return config_from_args(a), a.device, argv


def config_from_args(a: argparse.Namespace) -> EMSANetConfig:
    """The validated configuration of `build_parser`'s flags (the
    inference scripts parse them too, beside their own)."""
    model = model_config_from_args(a)
    data = DataConfig(
        dataset=a.dataset, dataset_path=a.dataset_path, split=a.split,
        validation_split=a.validation_split, raw_depth=a.raw_depth,
        batch_size=a.batch_size, n_workers=a.n_workers,
        worker_mode=a.worker_mode,
        validation_batch_size=a.validation_batch_size,
        aug_scale_min=a.aug_scale_min, aug_scale_max=a.aug_scale_max,
        disable_color_flip_aug=a.disable_color_flip_aug,
        subset_train=a.subset_train,
        subset_deterministic=a.subset_deterministic,
        cache_dataset=a.cache_dataset,
        scannet_semantic_n_classes=a.scannet_semantic_n_classes,
        scannet_subsample=a.scannet_subsample,
        validation_scannet_subsample=a.validation_scannet_subsample,
        hypersim_subsample=a.hypersim_subsample,
        use_original_scene_labels=a.use_original_scene_labels,
        validation_scannet_benchmark_mode=(
            a.validation_scannet_benchmark_mode),
        validation_full_resolution=a.validation_full_resolution,
        validation_input_height=a.validation_input_height,
        validation_input_width=a.validation_input_width,
        class_weighting=a.class_weighting or a.semantic_class_weighting,
        class_weighting_c=(
            a.class_weighting_c if a.class_weighting_c is not None
            else a.semantic_class_weighting_logarithmic_c),
        hypersim_use_old_depth_stats=a.hypersim_use_old_depth_stats,
        sunrgbd_depth_do_not_force_mm=a.sunrgbd_depth_do_not_force_mm,
        sunrgbd_instances_version=a.sunrgbd_instances_version,
        synthetic_n_samples=a.synthetic_n_samples,
    )
    smoothing = a.label_smoothing  # the deprecated alias sets both
    train = TrainConfig(
        n_epochs=a.n_epochs, optimizer=a.optimizer,
        learning_rate=a.learning_rate,
        learning_rate_scheduler=a.learning_rate_scheduler,
        momentum=a.momentum,
        weight_decay=a.weight_decay,
        tasks_weighting=(tuple(a.tasks_weighting) if a.tasks_weighting
                         else None),
        instance_weighting=tuple(a.instance_weighting),
        instance_center_loss=a.instance_center_loss,
        orientation_kappa=a.orientation_kappa, normal_loss=a.normal_loss,
        semantic_loss_label_smoothing=(
            a.semantic_loss_label_smoothing if smoothing is None
            else smoothing),
        scene_loss_label_smoothing=(
            a.scene_loss_label_smoothing if smoothing is None
            else smoothing),
        validation_skip=a.validation_skip,
        validation_force_interval=a.validation_force_interval,
        checkpointing_metrics=tuple(a.checkpointing_metrics),
        checkpointing_best_only=a.checkpointing_best_only,
        checkpointing_skip=a.checkpointing_skip,
        resume_ckpt_interval=a.resume_ckpt_interval,
        resume_ckpt_filepath=a.resume_ckpt_filepath,
        weights_filepath=a.weights_filepath,
        overfit_n_batches=a.overfit_n_batches,
        validation_on_train=a.validation_on_train,
        skip_sanity_check=a.skip_sanity_check,
        validation_only=a.validation_only,
        visualize_validation=a.visualize_validation,
        visualization_output_path=a.visualization_output_path,
        results_basepath=a.results_basepath,
        seed=a.seed, n_devices=a.n_devices, mixed_precision=a.mixed_precision,
        hostname=a.hostname, notes=a.notes,
        disable_progress_bars=a.disable_progress_bars, debug=a.debug,
    )
    return validate_train_for_port(
        EMSANetConfig(model=model, data=data, train=train))


@dataclasses.dataclass
class Run:
    """What a configuration trains and validates with."""

    cfg: EMSANetConfig
    device: torch.device
    ds_config: DatasetConfig
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    class_weights: Optional[torch.Tensor]
    train_step: Any
    eval_step: Any
    data: DataHelper
    lr_fn: Any
    # the colour generators `--visualize-validation` shares across epochs
    colors: Optional[ColorGenerators] = None
    mesh: Optional[Mesh] = None  # the data-parallel group, if any

    @property
    def is_main(self) -> bool:
        return self.mesh is None or self.mesh.is_main


def setup(cfg: EMSANetConfig, device=None, mesh: Optional[Mesh] = None
          ) -> Run:
    """The model (the reference's initialization from the seed), the
    optimizer, the train and eval steps and the data of a configuration;
    with `mesh`, on the rank's device, with the rank's rows of each batch
    and the averaging train step."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    m, d, t = cfg.model, cfg.data, cfg.train
    ds_config = get_dataset_config(d)
    if mesh is not None:
        mesh_ops.check_batch_sizes(d.batch_size, d.validation_batch_size,
                                   mesh.size)
    data = get_datahelper(cfg, shard=(0, 1) if mesh is None
                          else (mesh.rank, mesh.size))
    names = [e["name"] for e in parse_datasets(d.dataset)]
    sunrgbd_combined = names[0] == "sunrgbd" and any(
        n in ("nyuv2", "hypersim", "scannet") for n in names[1:])
    data.set_train_preprocessor(get_preprocessor(
        cfg, ds_config, "train",
        multiscale_downscales=m.side_output_downscales or None,
        sunrgbd_combined=sunrgbd_combined))
    data.set_valid_preprocessor(get_preprocessor(
        cfg, ds_config, "test", sunrgbd_combined=sunrgbd_combined))
    class_weights = None
    if "semantic" in m.tasks and d.class_weighting != "none":
        class_weights = torch.from_numpy(
            data.dataset_train.semantic_compute_class_weights(
                weight_mode=d.class_weighting, c=d.class_weighting_c)).to(dev)
    model = build_train_model(m, ds_config, device=str(dev), seed=t.seed)
    for mod in ("rgb", "depth"):
        path = getattr(m, f"{mod}_encoder_backbone_pretrained_weights_filepath")
        if path:
            load_backbone_pretrained(model, path, mod,
                                     getattr(m, f"{mod}_encoder_backbone"))
    optimizer = get_optimizer(model.parameters(), t)
    is_thing = torch.tensor(ds_config.classes_is_thing, device=dev)
    use_orientations = torch.tensor(ds_config.classes_use_orientations,
                                    device=dev)
    return Run(cfg=cfg, device=dev, ds_config=ds_config, model=model,
               optimizer=optimizer,
               class_weights=class_weights,
               train_step=make_train_step(model, cfg, optimizer,
                                          class_weights, mesh),
               eval_step=make_eval_step(model, cfg, is_thing,
                                        use_orientations=use_orientations),
               data=data, lr_fn=get_lr_fn(t),
               colors=(ColorGenerators.for_dataset(ds_config)
                       if t.visualize_validation else None),
               mesh=mesh)


def dropout_generator_for(seed: int, epoch: int, step: int,
                          device) -> torch.Generator:
    """The dropout generator of one step (`main.py` folds the same
    (epoch, step) index into its dropout key)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed + 1) * 1_000_000_007 + epoch * 100003 + step)
    return g


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def run_validation(run: Run, epoch: int,
                   artifacts_dir: Optional[str] = None,
                   examples_dir: Optional[str] = None,
                   on_batch: Optional[Callable[[Dict, Dict], None]] = None
                   ) -> Dict[str, float]:
    """Every validation loader through the eval step and the task
    helpers (`main.py:242-278`); returns the 'valid_'-prefixed logs and
    saves each helper's artifacts as `<name>_epoch_<epoch>.npy` into
    `artifacts_dir`, where given. With `--visualize-validation`, the
    first batch's predictions and ground truth are drawn into
    `<examples_dir>/epoch_<epoch:04d>/` (`main.py:260-267`). `on_batch`,
    where given, sees every (batch, host predictions) the helpers see.

    Over a mesh each rank evaluates its rows, and rank 0 gathers every
    rank's predictions and batch, joins them into the global batch and
    alone runs the helpers (and `on_batch`), so its logs are one
    process's over the same batches, padding rows included once; the
    other ranks return {}."""
    mesh = run.mesh
    helpers = get_task_helpers(run.cfg, run.ds_config)
    for th in helpers:
        th.initialize()
    n_batches = 0
    for loader in run.data.valid_loaders.values():
        for batch in loader.batches(0):
            preds = run.eval_step({
                k: torch.from_numpy(batch[k]).to(run.device)
                for k in EVAL_KEYS if k in batch})
            draw = (run.colors is not None and examples_dir is not None
                    and n_batches == 0)
            preds = {k: _host(v) for k, v in preds.items()
                     if draw or k in PREDICTION_KEYS}
            n_batches += 1
            if mesh is not None:
                parts = mesh_ops.gather_to_main(mesh, (batch, preds))
                if not mesh.is_main:
                    continue
                batch = mesh_ops.concat_rows([b for b, _ in parts])
                preds = mesh_ops.concat_rows([p for _, p in parts])
            for th in helpers:
                th.validation_step(batch, preds)
            if on_batch is not None:
                on_batch(batch, preds)
            if draw:
                out = os.path.join(examples_dir, f"epoch_{epoch:04d}")
                visualize_predictions(preds, batch, out, run.ds_config,
                                      run.colors)
                visualize_batches(batch, out, run.ds_config, run.colors)
    if not run.is_main:
        return {}
    logs: Dict[str, float] = {}
    for th in helpers:
        artifacts, th_logs = th.validation_epoch_end()
        logs.update({f"valid_{k}": v for k, v in th_logs.items()})
        if artifacts_dir is not None:
            for name, arr in artifacts.items():
                np.save(os.path.join(artifacts_dir,
                                     f"{name}_epoch_{epoch}.npy"), arr)
    return logs


def sanity_check(run: Run) -> float:
    """One train step on a copy of the model and the optimizer (the
    first batch of epoch 0; over a mesh, each rank's rows of it and the
    averaging step); returns its total loss. The run's own model and
    optimizer are left as they were."""
    model = copy.deepcopy(run.model)
    optimizer = get_optimizer(model.parameters(), run.cfg.train)
    optimizer.load_state_dict(copy.deepcopy(run.optimizer.state_dict()))
    step = make_train_step(model, run.cfg, optimizer, run.class_weights,
                           run.mesh)
    batch = next(iter(run.data.train_loader.batches(0)))
    g = torch.Generator(device=run.device)
    g.manual_seed(run.cfg.train.seed + 1)
    metrics = step(extract_device_batch(batch, run.device), g)
    return float(metrics["total_loss"])


def make_run_dir(cfg: EMSANetConfig, argv: Sequence[str]) -> str:
    """`<results_basepath>/<dataset>/run_<timestamp>/` with its
    `checkpoints/`, `artifacts/` and `examples/`, `args.json` and
    `argsv.txt`."""
    dataset = cfg.data.dataset.split(":")[0].split("[")[0]
    ts = datetime.datetime.now().strftime("%Y_%m_%d-%H_%M_%S-%f")
    run_dir = os.path.join(cfg.train.results_basepath, dataset, f"run_{ts}")
    for sub in ("checkpoints", "artifacts", "examples"):
        os.makedirs(os.path.join(run_dir, sub), exist_ok=True)
    fields = dataclasses.asdict(cfg)
    fields.pop("_validated", None)
    with open(os.path.join(run_dir, "args.json"), "w") as fh:
        json.dump(fields, fh, indent=2)
    with open(os.path.join(run_dir, "argsv.txt"), "w") as fh:
        fh.write(" ".join(argv))
    return run_dir


def wandb_config(cfg: EMSANetConfig, a: argparse.Namespace
                 ) -> Dict[str, Any]:
    """The run's configuration as `main.py` hands it to `wandb.init`
    (the JAX package's `cfg.to_dict()`): the port's sections, with the
    two model fields it keeps no copy of (the deprecated shared
    `encoder_decoder_fusion`, which the JAX parser spreads over the
    tasks and leaves at its default, and `--no-pretrained-backbone`),
    less the port's own `train.debug` (the JAX package keeps `--debug`
    on its namespace)."""
    out = dataclasses.asdict(cfg)
    out["model"]["encoder_decoder_fusion"] = "add-rgb"
    out["model"]["no_pretrained_backbone"] = bool(a.no_pretrained_backbone)
    out["train"].pop("debug", None)
    return out


def start_wandb(a: argparse.Namespace, cfg: EMSANetConfig, run_dir: str):
    """`main.py`'s optional wandb: None with `--wandb-mode disabled`;
    else `wandb` imported here, `wandb.init(project=..., mode=...,
    config=wandb_config(...), dir=run_dir)`, and the module returned
    for `wandb.log`. Any exception of the import or the init prints
    `[emsanet-tpu] wandb unavailable: <error>` and gives None: the run
    trains on without it."""
    if a.wandb_mode == "disabled":
        return None
    try:
        import wandb

        wandb.init(project=a.wandb_name or a.wandb_project,
                   mode=a.wandb_mode, config=wandb_config(cfg, a),
                   dir=run_dir)
    except Exception as e:  # wandb is optional, as in main.py
        print(f"[emsanet-tpu] wandb unavailable: {e}", flush=True)
        return None
    return wandb


def _epoch_logs(epoch: int, lr: float, seconds: float,
                sums: Optional[Dict[str, torch.Tensor]], n: int
                ) -> Dict[str, Any]:
    logs: Dict[str, Any] = {"epoch": epoch, "lr": lr,
                            "time_train_s": round(seconds, 2)}
    # sorted, as the JAX package's loss dict (a pytree) comes out
    logs.update({f"train_{k}": float(sums[k]) / max(n, 1)
                 for k in sorted(sums or {})})
    return logs


def replicate(run: Run) -> None:
    """Over a mesh, rank 0's parameters and buffers on every rank (after
    each rank loaded the same weights or checkpoint: a check that they
    start the same, at the cost of one broadcast)."""
    if run.mesh is not None:
        mesh_ops.broadcast_(run.mesh, [*run.model.parameters(),
                                       *run.model.buffers()])


def train(run: Run, run_dir: str,
          ns: Optional[argparse.Namespace] = None
          ) -> Optional[Dict[str, Any]]:
    """`main.py`'s loop from the sanity check on; returns the last
    epoch's logs (those of the validation with `validation_only`). Over a
    mesh every rank runs it; only rank 0 writes and prints, and its logs
    hold the validation's. `ns`: the parsed flags, whose `--wandb-*`
    ones start wandb after the validation-only return, as in `main.py`
    (None: no wandb)."""
    cfg, t = run.cfg, run.cfg.train
    main_rank = run.is_main
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    artifacts_dir = os.path.join(run_dir, "artifacts") if main_rank else None
    examples_dir = t.visualization_output_path or os.path.join(run_dir,
                                                               "examples")
    say = print if main_rank else (lambda *a, **k: None)

    def save(path, epoch, logs):
        # rank 0 writes; the others wait until the file is complete
        if main_rank:
            save_checkpoint(path, run.model, run.optimizer, epoch, logs)
        if run.mesh is not None:
            run.mesh.barrier()

    next_epoch = 0
    if t.weights_filepath:
        load_weights_file(t.weights_filepath, run.model)
    if t.resume_ckpt_filepath:
        last_epoch, _ = load_checkpoint(t.resume_ckpt_filepath, run.model,
                                        run.optimizer)
        next_epoch = last_epoch + 1
    replicate(run)
    if not t.skip_sanity_check:
        say(f"[emsanet-torch] sanity train loss: {sanity_check(run):.4f}",
            flush=True)
    csv_logger = CSVLogger(os.path.join(run_dir, "metrics.csv"))
    if t.validation_only:
        logs = run_validation(run, next_epoch, artifacts_dir, examples_dir)
        say(json.dumps(logs), flush=True)
        if main_rank:
            csv_logger.log({"epoch": next_epoch, **logs})
        return logs

    wandb = (start_wandb(ns, cfg, run_dir) if ns is not None and main_rank
             else None)
    checkpoint_helper = CheckpointHelper(tuple(t.checkpointing_metrics))
    n_epochs = t.n_epochs
    epoch, logs = next_epoch, None
    try:
        for epoch in range(next_epoch, n_epochs):
            t0 = time.time()
            lr = run.lr_fn(epoch)
            set_learning_rate(run.optimizer, lr)
            sums, n = None, 0
            for i, batch in enumerate(run.data.train_loader.batches(epoch)):
                # one dropout generator for every rank, as the JAX
                # package gives every shard the same key
                metrics = run.train_step(
                    extract_device_batch(batch, run.device),
                    dropout_generator_for(t.seed, epoch, i, run.device))
                # summed on the device: no host sync per step
                sums = metrics if sums is None else {
                    k: sums[k] + v for k, v in metrics.items()}
                n += 1
            logs = _epoch_logs(epoch, lr, time.time() - t0, sums, n)
            if (epoch >= t.validation_skip * n_epochs
                    or (epoch + 1) % t.validation_force_interval == 0
                    or epoch == n_epochs - 1):
                t1 = time.time()
                logs.update(run_validation(run, epoch, artifacts_dir,
                                           examples_dir))
                logs["time_valid_s"] = round(time.time() - t1, 2)
                improved = checkpoint_helper.check_for_checkpoint(
                    {k.replace("valid_", ""): v for k, v in logs.items()
                     if isinstance(v, (int, float))})
                if run.mesh is not None:  # rank 0's logs decide
                    improved = mesh_ops.broadcast_object(run.mesh, improved)
                if epoch >= t.checkpointing_skip * n_epochs:
                    for metric in improved:
                        suffix = ("best" if t.checkpointing_best_only
                                  else f"epoch_{epoch:04d}")
                        save(os.path.join(ckpt_dir,
                                          f"ckpt_{metric}_{suffix}.pt"),
                             epoch, logs)
            if ((epoch + 1) % t.resume_ckpt_interval == 0
                    or epoch == n_epochs - 1):
                save(os.path.join(ckpt_dir, "ckpt_resume.pt"), epoch, logs)
            if main_rank:
                csv_logger.log(logs)
            if wandb is not None:
                wandb.log(logs, step=epoch)
            say(json.dumps(logs), flush=True)
    except KeyboardInterrupt:
        raise
    except Exception:
        if main_rank:
            try:
                save_checkpoint(os.path.join(
                    ckpt_dir, f"ckpt_error__epoch_{epoch:04d}.pt"),
                    run.model, run.optimizer, epoch, {})
            except Exception:  # the traceback below is what matters
                pass
            with open(os.path.join(run_dir, "error.log"), "w") as fh:
                fh.write(traceback.format_exc())
        raise
    finally:
        if main_rank:
            csv_logger.write()
        run.data.close()
    if main_rank:
        with open(os.path.join(run_dir, "finished"), "w") as fh:
            fh.write("done\n")
    return logs


def train_rank(mesh: Mesh, cfg: EMSANetConfig, argv: Sequence[str]
               ) -> Optional[Dict[str, Any]]:
    """One rank of a data-parallel run: its setup, the run directory
    that rank 0 makes, and `train`; returns the logs (rank 0's hold the
    validation's)."""
    run = setup(cfg, mesh=mesh)
    run_dir = make_run_dir(cfg, argv) if mesh.is_main else None
    run_dir = mesh_ops.broadcast_object(mesh, run_dir)
    if mesh.is_main:
        print(f"[emsanet-torch] run dir: {run_dir}", flush=True)
        print(f"[emsanet-torch] data parallel over {mesh.size} ranks "
              f"({run.device.type})", flush=True)
    return train(run, run_dir, parse_namespace(list(argv))[0])


def main(argv: Optional[Sequence[str]] = None) -> int:
    a, argv = parse_namespace(argv)
    cfg = config_from_args(a)
    if a.distributed:
        resolve_device(a.device)
        mesh = mesh_ops.mesh_from_env(a.device)
        try:
            train_rank(mesh, cfg, argv)
        finally:
            mesh_ops.close_mesh(mesh)
        return 0
    n = cfg.train.n_devices or 1
    if n > 1:
        resolve_device(a.device)
        mesh_ops.launch(train_rank, n, a.device, cfg, argv, timeout=None)
        return 0
    run = setup(cfg, a.device)
    run_dir = make_run_dir(cfg, argv)
    print(f"[emsanet-torch] run dir: {run_dir}", flush=True)
    train(run, run_dir, a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
