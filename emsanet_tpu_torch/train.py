"""Train the port's EMSANet on one GPU.

    python -m emsanet_tpu_torch.train --dataset synthetic --n-epochs 2 \\
        --tasks semantic instance orientation scene --enable-panoptic \\
        --mixed-precision --fused-training

Counterpart of the repository's `main.py` setup and epoch loop: dataset,
train preprocessor (with the `_down_{s}` targets of multiscale
supervision), median-frequency class weights, model, optimizer, the
OneCycle learning rate set once per epoch, and a dropout generator per
step seeded from (seed + 1, epoch * 100003 + step). Flags take
`emsanet_tpu/utils/cli.py`'s names. It prints one line of mean losses
per epoch. Validation, checkpoints, CSV and wandb logging are not ported
yet. It runs on the card unless `--device cpu` is given, and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence, Tuple

import torch

from emsanet_tpu_torch.config import (
    DataConfig,
    EMSANetConfig,
    ModelConfig,
    TrainConfig,
    validate_train_for_port,
)
from emsanet_tpu_torch.data import DataLoader
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.synthetic import get_dataset
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.models.emsanet import build_train_model
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
from emsanet_tpu_torch.training.lr_schedule import get_lr_fn
from emsanet_tpu_torch.training.optim import get_optimizer, set_learning_rate
from emsanet_tpu_torch.training.step import (
    extract_device_batch,
    make_train_step,
)


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> Tuple[EMSANetConfig, str]:
    """(validated configuration, device name)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tasks", nargs="+", default=("semantic",))
    p.add_argument("--enable-panoptic", action="store_true")
    p.add_argument("--input-height", type=int, default=480)
    p.add_argument("--input-width", type=int, default=640)
    p.add_argument("--dropout-p", type=float, default=0.1)
    p.add_argument("--rgb-encoder-backbone", default="resnet34")
    p.add_argument("--depth-encoder-backbone", default="resnet34")
    for task in ("semantic", "instance"):
        p.add_argument(f"--{task}-decoder-block-dropout-p", type=float,
                       default=0.2)
        p.add_argument(f"--{task}-no-multiscale-supervision",
                       action="store_true")
    p.add_argument("--instance-center-sigma", type=int, default=8)
    p.add_argument("--compute-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--mixed-precision", action="store_true")
    p.add_argument("--fused-training", action="store_true")
    p.add_argument("--n-epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--optimizer", default="sgd",
                   choices=("sgd", "adam", "adamw", "radam"))
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--tasks-weighting", nargs="+", type=float, default=None)
    p.add_argument("--instance-weighting", nargs=2, type=float,
                   default=(2.0, 1.0))
    p.add_argument("--instance-center-loss", default="mse",
                   choices=("mse", "bce"))
    p.add_argument("--orientation-kappa", type=float, default=1.0)
    p.add_argument("--semantic-loss-label-smoothing", type=float,
                   default=0.0)
    p.add_argument("--scene-loss-label-smoothing", type=float, default=0.0)
    p.add_argument("--semantic-class-weighting", default="median-frequency",
                   choices=("median-frequency", "logarithmic", "linear",
                            "none"))
    p.add_argument("--dataset", default="nyuv2")
    p.add_argument("--synthetic-n-samples", type=int, default=16)
    p.add_argument("--aug-scale-min", type=float, default=1.0)
    p.add_argument("--aug-scale-max", type=float, default=1.4)
    p.add_argument("--no-color-flip-aug", dest="disable_color_flip_aug",
                   action="store_true")
    p.add_argument("--n-workers", type=int, default=8)
    p.add_argument("--n-devices", type=int, default=None)
    a = p.parse_args(argv)
    model = ModelConfig(
        tasks=tuple(a.tasks), enable_panoptic=a.enable_panoptic,
        input_height=a.input_height, input_width=a.input_width,
        dropout_p=a.dropout_p, rgb_encoder_backbone=a.rgb_encoder_backbone,
        depth_encoder_backbone=a.depth_encoder_backbone,
        semantic_decoder_block_dropout_p=a.semantic_decoder_block_dropout_p,
        instance_decoder_block_dropout_p=a.instance_decoder_block_dropout_p,
        semantic_no_multiscale_supervision=(
            a.semantic_no_multiscale_supervision),
        instance_no_multiscale_supervision=(
            a.instance_no_multiscale_supervision),
        instance_center_sigma=a.instance_center_sigma,
        compute_dtype=a.compute_dtype, fused_training=a.fused_training,
    )
    data = DataConfig(
        dataset=a.dataset, batch_size=a.batch_size, n_workers=a.n_workers,
        aug_scale_min=a.aug_scale_min, aug_scale_max=a.aug_scale_max,
        disable_color_flip_aug=a.disable_color_flip_aug,
        class_weighting=a.semantic_class_weighting,
        synthetic_n_samples=a.synthetic_n_samples,
    )
    train = TrainConfig(
        n_epochs=a.n_epochs, optimizer=a.optimizer,
        learning_rate=a.learning_rate, momentum=a.momentum,
        weight_decay=a.weight_decay,
        tasks_weighting=(tuple(a.tasks_weighting) if a.tasks_weighting
                         else None),
        instance_weighting=tuple(a.instance_weighting),
        instance_center_loss=a.instance_center_loss,
        orientation_kappa=a.orientation_kappa,
        semantic_loss_label_smoothing=a.semantic_loss_label_smoothing,
        scene_loss_label_smoothing=a.scene_loss_label_smoothing,
        seed=a.seed, n_devices=a.n_devices, mixed_precision=a.mixed_precision,
    )
    cfg = EMSANetConfig(model=model, data=data, train=train)
    return validate_train_for_port(cfg), a.device


def setup(cfg: EMSANetConfig, device=None):
    """(model, optimizer, train_step, loader, lr_fn) of a configuration."""
    dev = resolve_device(device)
    m, d, t = cfg.model, cfg.data, cfg.train
    ds_config = get_dataset_config(d.dataset)
    dataset = get_dataset(d, m, d.split)
    dataset.preprocessor = get_preprocessor(
        cfg, ds_config, "train",
        multiscale_downscales=m.side_output_downscales or None)
    loader = DataLoader(dataset, d.batch_size, shuffle=True, drop_last=True,
                        n_workers=d.n_workers, seed=t.seed)
    class_weights = None
    if "semantic" in m.tasks and d.class_weighting != "none":
        class_weights = torch.from_numpy(
            dataset.semantic_compute_class_weights(
                weight_mode=d.class_weighting, c=d.class_weighting_c)).to(dev)
    model = build_train_model(m, ds_config, device=str(dev), seed=t.seed)
    optimizer = get_optimizer(model.parameters(), t)
    step = make_train_step(model, cfg, optimizer, class_weights)
    return model, optimizer, step, loader, get_lr_fn(t)


def dropout_generator_for(seed: int, epoch: int, step: int,
                          device) -> torch.Generator:
    """The dropout generator of one step (`main.py` folds the same
    (epoch, step) index into its dropout key)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed + 1) * 1_000_000_007 + epoch * 100003 + step)
    return g


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg, device = parse_args(argv)
    dev = resolve_device(device)
    model, optimizer, train_step, loader, lr_fn = setup(cfg, dev)
    for epoch in range(cfg.train.n_epochs):
        t0 = time.time()
        lr = lr_fn(epoch)
        set_learning_rate(optimizer, lr)
        sums, n = None, 0
        for i, batch in enumerate(loader.batches(epoch)):
            metrics = train_step(
                extract_device_batch(batch, dev),
                dropout_generator_for(cfg.train.seed, epoch, i, dev))
            # summed on the device: no host sync per step
            sums = metrics if sums is None else {
                k: sums[k] + v for k, v in metrics.items()}
            n += 1
        logs = {"epoch": epoch, "lr": lr,
                "time_train_s": round(time.time() - t0, 2)}
        logs.update({f"train_{k}": float(v) / max(n, 1)
                     for k, v in (sums or {}).items()})
        print(json.dumps(logs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
