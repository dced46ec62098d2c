"""Inference over a dataset split, written in benchmark formats.

    python -m emsanet_tpu_torch.inference_dataset --dataset nyuv2 \\
        --dataset-path datasets/nyuv2 --weights-filepath <ckpt> \\
        --inference-output-path ./out \\
        --inference-output-format semantic instance panoptic mapping

Counterpart of the repository's `inference_dataset.py`. Every batch of
the validation loaders (one per camera; `--inference-split` names
another split) runs through the trainer's eval step (the model in eval
mode and the postprocessing, on the card), and each valid sample is
written in the asked formats:
- semantic: a class PNG in the full label space (`write_semantic`);
- instance: one binary mask PNG per valid instance and a txt index of
  mask, class and score (`write_instance`);
- panoptic: an RGB PNG, R the semantic class and G/B the 16-bit
  instance id (`write_panoptic`);
- mapping: an npz of class + score (score clipped to [0, 0.999]) as
  float32 (`write_mapping`);
then `meta.json` (dataset, split, formats, samples written, weights,
seconds, configuration). `--inference-max-samples` stops early;
`--inference-output-fullres` resizes the semantic and panoptic maps
back to each sample's own resolution (nearest, in the host library)
before writing. PNG files go through `datasets/png.py::write_png`.

Flags: the trainer's (`train.py::build_parser`; `--head-decode-fusion
auto` picks the reference's mode for the validation batch size) plus
the five above. It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.data import get_datahelper
from emsanet_tpu_torch.datasets.png import write_png
from emsanet_tpu_torch.datasets.registry import get_dataset_config
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.inference_samples import eval_model, host
from emsanet_tpu_torch.metrics import LABEL_DIVISOR
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
from emsanet_tpu_torch.task_helper import _resize_ids_nearest

FORMATS = ("semantic", "instance", "panoptic", "mapping")


def build_parser():
    parser = trainer.build_parser()
    g = parser.add_argument_group("dataset inference")
    g.add_argument("--inference-output-path", default="./inference_output")
    g.add_argument("--inference-output-format", nargs="+",
                   default=("semantic",), choices=FORMATS)
    g.add_argument("--inference-split", default=None,
                   help="split to run on (default: the validation split)")
    g.add_argument("--inference-max-samples", type=int, default=None)
    g.add_argument("--inference-output-fullres", action="store_true",
                   help="resize predictions back to the native resolution "
                   "before writing (the benchmark protocol)")
    return parser


def write_semantic(out_dir: str, ident: str, semantic_idx: np.ndarray
                   ) -> None:
    """Per-pixel class PNG in the full label space."""
    write_png(os.path.join(out_dir, f"{ident}.png"),
              semantic_idx.astype(np.uint8))


def write_instance(out_dir: str, ident: str, instance_seg: np.ndarray,
                   meta_semantic: np.ndarray, meta_score: np.ndarray,
                   meta_valid: np.ndarray) -> None:
    """Instance masks + index txt."""
    mask_dir = os.path.join(out_dir, "masks", ident)
    os.makedirs(mask_dir, exist_ok=True)
    lines = []
    for k in range(meta_valid.shape[0]):
        if not meta_valid[k]:
            continue
        inst_id = k + 1
        mask = (instance_seg == inst_id).astype(np.uint8) * 255
        if not mask.any():
            continue
        rel = os.path.join("masks", ident, f"{inst_id:03d}.png")
        write_png(os.path.join(out_dir, rel), mask)
        lines.append(f"{rel} {int(meta_semantic[k])} "
                     f"{float(meta_score[k]):.6f}")
    with open(os.path.join(out_dir, f"{ident}.txt"), "w") as fh:
        fh.write("\n".join(lines) + ("\n" if lines else ""))


def write_panoptic(out_dir: str, ident: str, panoptic: np.ndarray,
                   label_divisor: int) -> None:
    """R = semantic class, G/B = the 16-bit instance id."""
    sem = (panoptic // label_divisor).astype(np.uint8)
    inst = (panoptic % label_divisor).astype(np.uint16)
    img = np.stack(
        [sem, (inst >> 8).astype(np.uint8), (inst & 0xFF).astype(np.uint8)],
        axis=-1)
    write_png(os.path.join(out_dir, f"{ident}.png"), img)


def write_mapping(out_dir: str, ident: str, semantic_idx: np.ndarray,
                  semantic_score: np.ndarray) -> None:
    """Packed class + score float32 npz: value = class + score, the
    score clipped to [0, 0.999]."""
    os.makedirs(out_dir, exist_ok=True)
    packed = semantic_idx.astype(np.float32) + np.clip(
        semantic_score.astype(np.float32), 0.0, 0.999)
    np.savez_compressed(os.path.join(out_dir, f"{ident}.npz"), packed=packed)


def _identifier(ident) -> str:
    return ident.to_filename() if hasattr(ident, "to_filename") else str(
        ident)


def write_sample(out_root: str, formats: Sequence[str], ident: str,
                 preds: Dict[str, np.ndarray], b: int, full_hw=None
                 ) -> None:
    """Sample b of a batch's predictions in every asked format; the
    semantic and panoptic maps at `full_hw` (h, w) where given."""
    def at_output_res(ids):
        return ids if full_hw is None else _resize_ids_nearest(
            np.asarray(ids), *full_hw)

    if "semantic" in formats:
        write_semantic(os.path.join(out_root, "semantic"), ident,
                       at_output_res(preds["semantic_segmentation_idx"][b]
                                     + 1))
    if "instance" in formats and "instance_segmentation" in preds:
        write_instance(os.path.join(out_root, "instance"), ident,
                       preds["instance_segmentation"][b],
                       preds["panoptic_instance_meta_semantic_idx"][b],
                       preds["panoptic_instance_meta_score"][b],
                       preds["panoptic_instance_meta_valid"][b])
    if "panoptic" in formats and "panoptic_segmentation_deeplab" in preds:
        write_panoptic(
            os.path.join(out_root, "panoptic"), ident,
            at_output_res(preds["panoptic_segmentation_deeplab"][b]),
            LABEL_DIVISOR)
    if "mapping" in formats:
        write_mapping(os.path.join(out_root, "mapping"), ident,
                      preds["semantic_segmentation_idx"][b] + 1,
                      preds["semantic_segmentation_score"][b])


def run(argv: Optional[Sequence[str]] = None) -> Dict:
    """The split through the model and the writers; returns meta.json's
    content plus host seconds per batch ('batch_s': eval step to the
    host, 'write_s': the writers)."""
    ns = build_parser().parse_args(argv)
    cfg = trainer.config_from_args(ns)
    if ns.inference_split:
        cfg.data.validation_split = ns.inference_split
    device = resolve_device(ns.device)
    ds_config = get_dataset_config(cfg.data)
    data = get_datahelper(cfg)
    data.set_valid_preprocessor(get_preprocessor(cfg, ds_config, "test"))
    _, eval_step = eval_model(cfg, ds_config, device, verbose=False)

    out_root = ns.inference_output_path
    formats = tuple(ns.inference_output_format)
    t_start = time.time()
    n_written, batch_s, write_s = 0, [], []
    try:
        for loader in data.valid_loaders.values():
            for batch in loader.batches(0):
                t0 = time.perf_counter()
                preds = host(eval_step({
                    k: torch.from_numpy(batch[k]).to(device)
                    for k in ("rgb", "depth") if k in batch}))
                t1 = time.perf_counter()
                valid = batch.get("_valid_mask",
                                  np.ones(len(batch["identifier"]), bool))
                full = batch.get("rgb_fullres")
                for b, ident in enumerate(batch["identifier"]):
                    if not valid[b]:
                        continue
                    if (ns.inference_max_samples
                            and n_written >= ns.inference_max_samples):
                        break
                    full_hw = (np.asarray(full).shape[1:3]
                               if ns.inference_output_fullres
                               and full is not None else None)
                    write_sample(out_root, formats, _identifier(ident),
                                 preds, b, full_hw)
                    n_written += 1
                batch_s.append(t1 - t0)
                write_s.append(time.perf_counter() - t1)
    finally:
        data.close()
    fields = dataclasses.asdict(cfg)
    fields.pop("_validated", None)
    meta = {
        "dataset": cfg.data.dataset,
        "split": cfg.data.validation_split,
        "formats": list(formats),
        "n_samples": n_written,
        "weights": cfg.train.weights_filepath,
        "elapsed_s": round(time.time() - t_start, 2),
        "config": fields,
    }
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, "meta.json"), "w") as fh:
        json.dump(meta, fh, indent=2, default=str)
    print(f"wrote {n_written} samples to {out_root} ({meta['elapsed_s']}s)")
    return {**meta, "batch_s": batch_s, "write_s": write_s}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
