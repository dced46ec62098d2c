"""Import an upstream PyTorch EMSANet checkpoint as a port checkpoint.

    python -m emsanet_tpu_torch.import_torch_checkpoint ckpt.pth out_dir \\
        [--backbone resnet34] [--n-semantic-classes 40] \\
        [--n-scene-classes 0] [--no-orientation] [--rename-json f.json] \\
        [--device cuda]

Counterpart of `tools/import_torch_checkpoint.py`:
 1. load the state dict (`torch.load` with `weights_only=True`; a
    `{'state_dict': ...}` wrapper is unwrapped and a 'model.' prefix
    stripped);
 2. rename key prefixes: `REFERENCE_RENAMES` ('fused_encoders.' ->
    'encoder.', the panoptic helper's decoders -> 'decoders.*') and any
    `--rename-json` {old_prefix: new_prefix};
 3. map every key onto the port's names (`torch_compat/name_map.py`;
    tensors cross unchanged, both sides OIHW), skipping
    `num_batches_tracked` and reporting the keys the map does not know;
 4. merge them into a model of the asked shape (`--backbone` for both
    encoders, `--n-semantic-classes`, `--n-scene-classes`, 0 taking the
    checkpoint's own count, `--no-orientation`; the rest initialized as
    training initializes it, from seed 0) with
    `weights.merge_loaded_params`'s transfer rules;
 5. write `<out_dir>/imported_torch.pt` in `training/checkpoint.py`'s
    format, which `--weights-filepath` reads (the reference writes an
    `.npz` for `load_imported_npz`).
The merge model is built on the card unless `--device cpu` is given
(without a card, 'cuda' raises); the file written loads on either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from emsanet_tpu_torch.config import flagship_config
from emsanet_tpu_torch.datasets.metadata import (
    DEPTH_STATS,
    INDOOR_DOMESTIC_SCENES,
    NYUV2_40,
    build_dataset_config,
    scene_list,
    semantic_list,
)
from emsanet_tpu_torch.device import resolve_device
from emsanet_tpu_torch.models.backbone import STAGE_BLOCKS
from emsanet_tpu_torch.models.emsanet import build_train_model
from emsanet_tpu_torch.torch_compat.name_map import emsanet_torch_name_map
from emsanet_tpu_torch.training.checkpoint import save_checkpoint
from emsanet_tpu_torch.weights import (
    convert_torch_state_dict,
    merge_loaded_params,
)

REFERENCE_RENAMES = {
    "fused_encoders.": "encoder.",
    "decoders.panoptic_helper.semantic_decoder.":
        "decoders.semantic_decoder.",
    "decoders.panoptic_helper.instance_decoder.":
        "decoders.instance_decoder.",
}
OUT_NAME = "imported_torch.pt"
SCENE_HEAD = "scene_decoder.head.weight"


def renamed(state_dict: Dict[str, torch.Tensor],
            renames: Optional[Dict[str, str]] = None
            ) -> Dict[str, torch.Tensor]:
    """The state dict with the 'model.' prefix stripped and the key
    prefixes of `REFERENCE_RENAMES` and `renames` replaced."""
    all_renames = {**REFERENCE_RENAMES, **(renames or {})}
    out = {}
    for key, value in state_dict.items():
        if key.startswith("model."):
            key = key[len("model."):]
        for old, new in all_renames.items():
            if key.startswith(old):
                key = new + key[len(old):]
        out[key] = value
    return out


def _dataset_config(n_semantic: int, n_scene: int):
    """Label tables of the asked sizes: NYUv2's 40 classes, or numbered
    ones; the indoor-domestic scenes, or numbered ones."""
    semantic = NYUV2_40 if n_semantic == len(NYUV2_40) else tuple(
        (f"class_{i}", False, False) for i in range(1, n_semantic + 1))
    scenes = INDOOR_DOMESTIC_SCENES if n_scene == len(
        INDOOR_DOMESTIC_SCENES) else tuple(
        f"scene_{i}" for i in range(1, n_scene + 1))
    return build_dataset_config(semantic_list(semantic), scene_list(scenes),
                                DEPTH_STATS["synthetic"])


def import_checkpoint(checkpoint: str, out_dir: str,
                      backbone: str = "resnet34", n_semantic_classes: int = 40,
                      n_scene_classes: int = 0, orientation: bool = True,
                      renames: Optional[Dict[str, str]] = None,
                      verbose: bool = True, device: str = "cuda") -> str:
    """Steps 1-5 of the module's docstring, the merge model on `device`;
    returns the file written."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    raw = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    tasks = ("semantic", "instance") + (
        ("orientation",) if orientation else ()) + ("scene",)
    name_map = emsanet_torch_name_map(STAGE_BLOCKS[backbone], tasks)
    loaded, unmatched = convert_torch_state_dict(renamed(raw, renames),
                                                 name_map)
    say(f"[import] converted {len(loaded)} tensors; {len(unmatched)} "
        "unmatched keys")
    for key in unmatched[:20]:
        say(f"[import]   unmatched: {key}")
    n_scene = n_scene_classes or (loaded[SCENE_HEAD].shape[0]
                                  if SCENE_HEAD in loaded else 0)
    if n_scene <= 0:
        raise ValueError(f"{checkpoint} has no scene head: pass "
                         "--n-scene-classes")
    cfg = flagship_config(tasks=tasks, rgb_encoder_backbone=backbone,
                          depth_encoder_backbone=backbone)
    model = build_train_model(cfg, _dataset_config(n_semantic_classes,
                                                   n_scene),
                              device=dev, seed=0)
    merged = merge_loaded_params(loaded, model.state_dict(), verbose=verbose)
    model.load_state_dict(merged, strict=True)
    out = os.path.join(out_dir, OUT_NAME)
    save_checkpoint(out, model, None, 0,
                    {"source": os.path.abspath(checkpoint)})
    say(f"[import] wrote {out}; load it with --weights-filepath")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint")
    ap.add_argument("out_dir")
    ap.add_argument("--backbone", default="resnet34",
                    choices=sorted(STAGE_BLOCKS))
    ap.add_argument("--n-semantic-classes", type=int, default=40)
    ap.add_argument("--n-scene-classes", type=int, default=0,
                    help="0: the checkpoint's own count")
    ap.add_argument("--no-orientation", action="store_true")
    ap.add_argument("--rename-json", default=None,
                    help="JSON {old_prefix: new_prefix} of extra renames")
    ap.add_argument("--device", default="cuda",
                    help="where the merge model is built (cuda or cpu)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    renames = None
    if args.rename_json:
        with open(args.rename_json) as fh:
            renames = json.load(fh)
    import_checkpoint(args.checkpoint, args.out_dir, args.backbone,
                      args.n_semantic_classes, args.n_scene_classes,
                      not args.no_orientation, renames,
                      device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
