"""Files and comparisons of the inference scripts' card-against-CPU
checks (`tests/test_torch_cuda_inference.py` and `chip_smoke.py`'s
`[inference]` phase). JAX-free.

Limits (phase 8's): an id map (semantic, instance mask, panoptic) may
differ in at most `ID_SHARE` of its pixels; a panel tile in at most
`ID_SHARE` of its pixels by more than `TILE_LEVELS` levels in a channel
(tiles drawn from float maps move by one level where a value lies within
rounding of a level's edge); instance scores and mapping values within
`SCORE_TOL`.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Tuple

import numpy as np

from emsanet_tpu_torch.datasets.png import read_png, write_png

ID_SHARE = 1e-3
TILE_LEVELS = 1
SCORE_TOL = 1e-4
TILE_NAMES = ("rgb", "depth", "semantic", "instance", "instance_center",
              "instance_offset", "panoptic", "orientation")
TASK_FLAGS = ("--tasks", "semantic", "instance", "orientation", "scene",
              "--enable-panoptic")
SMALL_FLAGS = (*TASK_FLAGS, "--rgb-encoder-backbone", "resnet18",
               "--depth-encoder-backbone", "resnet18", "--input-height",
               "96", "--input-width", "128", "--fused-inference")


def write_samples(root: str, shapes: Iterable[Tuple[int, int]],
                  seed: int = 0) -> Tuple[str, ...]:
    """Kinect-v2-style pairs `sample<i>_rgb.png` (uint8) and
    `sample<i>_depth.png` (uint16 mm, 0..12000: some above an 8000 mm
    `--depth-max`); returns the names."""
    rng = np.random.RandomState(seed)
    names = []
    for i, (h, w) in enumerate(shapes):
        name = f"sample{i}"
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([(xx * 255 // max(w - 1, 1)),
                        (yy * 255 // max(h - 1, 1)),
                        rng.randint(0, 256, (h, w))], -1).astype(np.uint8)
        depth = (500 + 11500 * xx / max(w - 1, 1)
                 + rng.randint(0, 200, (h, w))).astype(np.uint16)
        depth[: h // 8] = 0  # a depth shadow
        write_png(os.path.join(root, f"{name}_rgb.png"), rgb)
        write_png(os.path.join(root, f"{name}_depth.png"), depth)
        names.append(name)
    return tuple(names)


def panel_tiles(panel: np.ndarray, h: int, w: int) -> Dict[str, np.ndarray]:
    if panel.shape != (2 * h, 4 * w, 3) or panel.dtype != np.uint8:
        raise AssertionError(f"panel {panel.dtype} {panel.shape}, expected "
                             f"uint8 {(2 * h, 4 * w, 3)}")
    return {name: panel[(i // 4) * h:(i // 4 + 1) * h,
                        (i % 4) * w:(i % 4 + 1) * w]
            for i, name in enumerate(TILE_NAMES)}


def compare_panels(dir_a: str, dir_b: str, names: Iterable[str], h: int,
                   w: int) -> Dict[str, float]:
    """Per tile, the largest share of pixels (over the samples) that
    differ by more than TILE_LEVELS in a channel; raises beyond
    ID_SHARE."""
    worst: Dict[str, float] = {}
    for name in names:
        a, b = (panel_tiles(read_png(os.path.join(d, f"result_{name}.png")),
                            h, w) for d in (dir_a, dir_b))
        for tile in TILE_NAMES:
            off = (np.abs(a[tile].astype(int) - b[tile].astype(int))
                   > TILE_LEVELS).any(-1)
            worst[tile] = max(worst.get(tile, 0.0), float(off.mean()))
    bad = {k: v for k, v in worst.items() if v > ID_SHARE}
    if bad:
        raise AssertionError(f"panel tiles differ beyond {ID_SHARE}: {bad}")
    return worst


def _files(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def compare_dataset_outputs(dir_a: str, dir_b: str) -> Dict[str, float]:
    """Two output trees of `inference_dataset.py`: the same files; id
    maps (PNGs) within ID_SHARE, instance scores and mapping values
    within SCORE_TOL; returns the largest of each and the file count."""
    names = _files(dir_a)
    if _files(dir_b) != names:
        raise AssertionError(f"output trees differ: "
                             f"{sorted(set(names) ^ set(_files(dir_b)))[:5]}")
    share = score = 0.0
    for name in names:
        a, b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if name.endswith(".png"):
            pa, pb = read_png(a), read_png(b)
            if pa.shape != pb.shape:
                raise AssertionError(f"{name}: {pa.shape} vs {pb.shape}")
            off = pa != pb
            share = max(share, float(
                (off.any(-1) if off.ndim == 3 else off).mean()))
        elif name.endswith(".txt"):
            with open(a) as fa, open(b) as fb:
                la, lb = fa.read().split("\n"), fb.read().split("\n")
            if [ln.split()[:2] for ln in la] != [ln.split()[:2] for ln in lb]:
                raise AssertionError(f"{name}: masks or classes differ")
            for x, y in zip(la, lb):
                if x:
                    score = max(score, abs(float(x.split()[2])
                                           - float(y.split()[2])))
        elif name.endswith(".npz"):
            score = max(score, float(np.abs(
                np.load(a)["packed"] - np.load(b)["packed"]).max()))
    if share > ID_SHARE or score > SCORE_TOL:
        raise AssertionError(f"dataset outputs: id maps differ in {share} "
                             f"of their pixels (limit {ID_SHARE}), scores by "
                             f"{score} (limit {SCORE_TOL})")
    return {"files": len(names), "id_share": share, "score_err": score}


def read_back(root: str) -> Dict[str, int]:
    """Every file `inference_dataset.py` wrote, read back (PNGs with
    `read_png`, npz with `np.load`); counts by kind."""
    counts: Dict[str, int] = {}
    for name in _files(root):
        kind = name.split(os.sep)[0]
        if name.endswith(".png"):
            arr = read_png(os.path.join(root, name))
            if arr.size == 0:
                raise AssertionError(f"{name}: empty image")
        elif name.endswith(".npz"):
            packed = np.load(os.path.join(root, name))["packed"]
            if not np.isfinite(packed).all():
                raise AssertionError(f"{name}: not finite")
        counts[kind] = counts.get(kind, 0) + 1
    return counts
