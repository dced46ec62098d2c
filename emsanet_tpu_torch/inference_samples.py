"""Inference on raw RGB-D sample files, one 2x4 result panel each.

    python -m emsanet_tpu_torch.inference_samples --dataset nyuv2 \\
        --tasks semantic scene instance orientation --enable-panoptic \\
        --raw-depth --weights-filepath <ckpt> --sample-path ./samples \\
        --depth-max 8000 --depth-scale 8 --output-path ./panels

Counterpart of the repository's `inference_samples.py`. Each
`*_rgb.png` / `*_depth.png` pair of `--sample-path` (Kinect-v2 style:
RGB uint8, depth uint16 in mm) is read with `datasets/png.py::read_png`;
the depth is clipped above `--depth-max` in raw units and then scaled by
`--depth-scale` (`prepare_raw_depth`); the test-phase preprocessor
(with the raw inputs kept) makes a batch of one, which runs through the
model in eval mode and the postprocessing on the card (the trainer's
eval step). The panel's tiles, left to right and top to bottom: RGB
(the raw image resized to the input size with PIL's bicubic resize,
`imaging.resize_bicubic_u8`), depth, semantic, instance, instance
centres, instance offsets, panoptic, orientation. The scene class is
printed. Without matplotlib there is no window: every panel is written,
to `--output-path/result_<name>.png`, or to `result_<name>.png` in the
working directory (the reference's fallback).

Flags: the trainer's (`train.py::build_parser`; `--head-decode-fusion
auto` as there) plus the four above. `--weights-filepath` takes a port
checkpoint (`.pt`, also what `import_torch_checkpoint.py` writes) or a
JAX package checkpoint; without it the weights are random from
`--seed`. It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.config import EMSANetConfig
from emsanet_tpu_torch.datasets.base import SampleIdentifier
from emsanet_tpu_torch.datasets.metadata import DatasetConfig
from emsanet_tpu_torch.datasets.png import read_png, write_png
from emsanet_tpu_torch.datasets.registry import get_dataset_config
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.imaging import resize_bicubic_u8
from emsanet_tpu_torch.models.emsanet import build_train_model
from emsanet_tpu_torch.preprocessing.collate import batch_collate
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
from emsanet_tpu_torch.training.step import make_eval_step
from emsanet_tpu_torch.visualization import (
    ColorGenerators,
    dense_instance_maps,
    semantic_colors,
    visualize_depth,
    visualize_instance,
    visualize_instance_center,
    visualize_instance_offset,
    visualize_orientation,
    visualize_panoptic,
    visualize_semantic,
)
from emsanet_tpu_torch.weights import load_weights_file

def prepare_raw_depth(depth, depth_max, depth_scale) -> np.ndarray:
    """Kinect-style raw depth: values above `depth_max` become 0
    (invalid), then `depth_scale` applies, in that order, so the clip
    threshold is in raw sensor units (mm for the Kinect-v2 samples)."""
    depth = np.asarray(depth).astype(np.float32)
    if depth_max is not None:
        depth = np.where(depth > depth_max, 0, depth)
    return depth * depth_scale


def build_parser() -> argparse.ArgumentParser:
    parser = trainer.build_parser()
    group = parser.add_argument_group("inference")
    group.add_argument("--sample-path", default="./samples",
                       help="directory with *_rgb.png / *_depth.png pairs")
    group.add_argument("--depth-max", type=float, default=None,
                       help="clip depth values above this (raw units)")
    group.add_argument("--depth-scale", type=float, default=1.0,
                       help="scale factor applied to depth after clipping")
    group.add_argument("--output-path", default=None,
                       help="directory for the panels (default: the "
                       "working directory)")
    return parser


def host(preds: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The eval step's outputs as numpy arrays (bf16 as float32)."""
    return {k: trainer._host(v) for k, v in preds.items()}


def eval_model(cfg: EMSANetConfig, ds_config: DatasetConfig,
               device: torch.device, verbose: bool = True):
    """(model, eval step) of the inference scripts: the training model
    (float32 parameters, cast to the compute dtype at use) from
    `--seed`, with `--weights-filepath` loaded where given."""
    model = build_train_model(cfg.model, ds_config, device=str(device),
                              seed=cfg.train.seed)
    if cfg.train.weights_filepath:
        load_weights_file(cfg.train.weights_filepath, model,
                          verbose=verbose)
        if verbose:
            print(f"loaded weights: {cfg.train.weights_filepath}")
    elif verbose:
        print("WARNING: no --weights-filepath given, using random weights")
    model.eval()
    is_thing = torch.tensor(ds_config.classes_is_thing, device=device)
    return model, make_eval_step(model, cfg, is_thing)


def panel_tiles(batch: Dict, preds: Dict[str, np.ndarray],
                ds_config: DatasetConfig, colors: ColorGenerators
                ) -> List[Tuple[str, np.ndarray]]:
    """The panel's eight (name, image) tiles of sample 0 (reference
    `inference_samples.py:135-168`)."""
    raw = batch["_no_preprocessing"][0]
    h, w = batch["rgb"].shape[1:3]
    rgb_vis = resize_bicubic_u8(raw["rgb"], h, w)
    blank = np.zeros_like(rgb_vis)
    center, offset, orientation = dense_instance_maps(preds, 0)
    depth = batch["depth"][0]  # (H, W): not normalized for an rgb model
    return [
        ("rgb", rgb_vis),
        ("depth", visualize_depth(depth[..., 0] if depth.ndim == 3
                                  else depth)),
        ("semantic", visualize_semantic(
            preds["semantic_segmentation_idx"][0] + 1,
            semantic_colors(ds_config))),
        ("instance", visualize_instance(
            preds["instance_segmentation"][0], colors.instance)
         if "instance_segmentation" in preds else blank),
        ("instance_center", visualize_instance_center(center)
         if center is not None else blank),
        ("instance_offset", visualize_instance_offset(offset)
         if offset is not None else blank),
        ("panoptic", visualize_panoptic(
            preds["panoptic_segmentation_deeplab"][0],
            color_generator=colors.panoptic)
         if "panoptic_segmentation_deeplab" in preds else blank),
        ("orientation", visualize_orientation(
            orientation, preds.get("panoptic_foreground_mask", [None])[0])
         if orientation is not None else blank),
    ]


def assemble(tiles: Sequence[Tuple[str, np.ndarray]]) -> np.ndarray:
    rows = [np.concatenate([img for _, img in tiles[r * 4:(r + 1) * 4]],
                           axis=1) for r in range(2)]
    return np.concatenate(rows, axis=0)


def run(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Every sample pair through the model; returns per sample its name,
    panel path, scene line and host ms of each step (read, preprocess,
    frame: the eval step to the predictions on the host, panel, write)."""
    ns = build_parser().parse_args(argv)
    cfg = trainer.config_from_args(ns)
    device = resolve_device(ns.device)
    ds_config = get_dataset_config(cfg.data)
    _, eval_step = eval_model(cfg, ds_config, device)
    preprocessor = get_preprocessor(cfg, ds_config, phase="test",
                                    keep_raw_inputs=True)
    colors = ColorGenerators.for_dataset(ds_config)
    rgb_files = sorted(glob.glob(os.path.join(ns.sample_path, "*_rgb.png")))
    if not rgb_files:
        raise FileNotFoundError(f"no *_rgb.png files in {ns.sample_path}")
    out_dir = ns.output_path or "."
    reports = []
    for rgb_file in rgb_files:
        name = os.path.basename(rgb_file)[:-len("_rgb.png")]
        ms = {}
        t0 = time.perf_counter()
        rgb = read_png(rgb_file)[..., :3]
        depth = prepare_raw_depth(
            read_png(rgb_file.replace("_rgb.png", "_depth.png")),
            ns.depth_max, ns.depth_scale)
        t1 = time.perf_counter()
        batch = batch_collate([preprocessor({
            "rgb": rgb, "depth": depth,
            "identifier": SampleIdentifier((name,))})])
        t2 = time.perf_counter()
        preds = host(eval_step({
            k: torch.from_numpy(batch[k]).to(device)
            for k in ("rgb", "depth")}))
        t3 = time.perf_counter()
        panel = assemble(panel_tiles(batch, preds, ds_config, colors))
        t4 = time.perf_counter()
        out_file = os.path.join(out_dir, f"result_{name}.png")
        write_png(out_file, panel)
        t5 = time.perf_counter()
        for key, (a, b) in zip(("read", "preprocess", "frame", "panel",
                                "write"),
                               ((t0, t1), (t1, t2), (t2, t3), (t3, t4),
                                (t4, t5))):
            ms[key] = (b - a) * 1e3
        scene = None
        if "scene_class_idx" in preds:
            scene_idx = int(preds["scene_class_idx"][0]) + 1
            names = ds_config.scene_class_names
            label = names[scene_idx] if scene_idx < len(names) else str(
                scene_idx)
            scene = (f"{name}: scene = {label} "
                     f"({float(preds['scene_class_score'][0]):.3f})")
            print(scene)
        print(f"{name}: wrote {out_file} (host ms: " + ", ".join(
            f"{k} {v:.1f}" for k, v in ms.items()) + ")")
        reports.append({"name": name, "panel": out_file, "scene": scene,
                        "ms": ms})
    return reports


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
