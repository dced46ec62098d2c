"""Visualization: renderers for every prediction and ground-truth key,
and the writers of PNG and JSON files per sample identifier.

Counterpart of `emsanet_tpu/visualization.py`, numpy only: semantic
(palette), instance (distinct colours from a generator kept across
images), centre heatmaps, offsets (colour wheel), dense and per-instance
orientations, panoptic, score heatmaps, depth, blends, and the writers
`visualize_predictions` / `visualize_batches`. The reference keeps its
shared generators in a module global (`setup_shared_color_generators`);
here `ColorGenerators.for_dataset(dataset_config)` makes them and the
caller passes them on, with the same colours in the same order.

PNG files go through `datasets/png.py::write_png` (the pixels equal
PIL's; the zlib stream differs). The mask fill of
`visualize_instance_orientations` is the reference's bit for bit; its
arrows and degree text are the port's own rendering
(`imaging.draw_line`, `imaging.draw_text` with a built-in bitmap font),
where the reference draws with PIL's `ImageDraw` and its default font.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from emsanet_tpu_torch import imaging
from emsanet_tpu_torch.datasets.metadata import (
    DatasetConfig,
    generate_distinct_colors,
)
from emsanet_tpu_torch.datasets.png import write_png
from emsanet_tpu_torch.metrics import LABEL_DIVISOR
from emsanet_tpu_torch.task_helper import interleave_planes_np

WHITE = (255, 255, 255)
TEXT_COLORS = {"black": (0, 0, 0), "white": (255, 255, 255)}


# ---------------------------------------------------------------------------
# colour generators (kept across images, reference visualization.py:54-75)


class InstanceColorGenerator:
    """Assigns each instance id a stable distinct color."""

    def __init__(self, seed: int = 1):
        self._colors = generate_distinct_colors(256, seed=seed)
        self._assigned: Dict[int, Tuple[int, int, int]] = {0: (0, 0, 0)}

    def color(self, instance_id: int) -> Tuple[int, int, int]:
        if instance_id not in self._assigned:
            idx = len(self._assigned) % len(self._colors)
            self._assigned[instance_id] = self._colors[idx]
        return self._assigned[instance_id]

    def colorize(self, instance_map: np.ndarray) -> np.ndarray:
        out = np.zeros((*instance_map.shape, 3), np.uint8)
        for iid in np.unique(instance_map):
            out[instance_map == iid] = self.color(int(iid))
        return out


class PanopticColorGenerator:
    """Stuff classes get their semantic color; things get per-instance
    shades of their class color."""

    def __init__(self, semantic_colors: np.ndarray,
                 is_thing: Sequence[bool], seed: int = 2):
        self.semantic_colors = np.asarray(semantic_colors, np.uint8)
        self.is_thing = np.asarray(is_thing, bool)
        self._shade_cache: Dict[int, np.ndarray] = {}
        self._rng = np.random.RandomState(seed)

    def _shade(self, panoptic_id: int) -> np.ndarray:
        if panoptic_id not in self._shade_cache:
            sem = panoptic_id // LABEL_DIVISOR
            base = self.semantic_colors[sem % len(self.semantic_colors)]
            jitter = self._rng.randint(-40, 41, 3)
            self._shade_cache[panoptic_id] = np.clip(
                base.astype(int) + jitter, 0, 255
            ).astype(np.uint8)
        return self._shade_cache[panoptic_id]

    def colorize(self, panoptic_map: np.ndarray) -> np.ndarray:
        out = np.zeros((*panoptic_map.shape, 3), np.uint8)
        for pid in np.unique(panoptic_map):
            sem = int(pid) // LABEL_DIVISOR
            if pid == 0 or sem >= len(self.is_thing):
                continue
            if self.is_thing[sem]:
                out[panoptic_map == pid] = self._shade(int(pid))
            else:
                out[panoptic_map == pid] = self.semantic_colors[sem]
        return out


def semantic_colors(dataset_config: DatasetConfig) -> np.ndarray:
    return np.asarray(dataset_config.semantic_colors, np.uint8)


@dataclass
class ColorGenerators:
    """The instance and panoptic generators that one run shares across
    its images (the reference's `setup_shared_color_generators`)."""

    instance: InstanceColorGenerator
    panoptic: PanopticColorGenerator

    @classmethod
    def for_dataset(cls, dataset_config: DatasetConfig) -> "ColorGenerators":
        return cls(InstanceColorGenerator(), PanopticColorGenerator(
            semantic_colors(dataset_config), dataset_config.classes_is_thing))


# ---------------------------------------------------------------------------
# stateless renderers


def visualize_semantic(semantic: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """semantic: (H, W) ids in the full label space; colors: (C, 3)."""
    colors = np.asarray(colors, np.uint8)
    return colors[np.clip(semantic, 0, len(colors) - 1)]


def visualize_heatmap(heatmap: np.ndarray) -> np.ndarray:
    """Scalar map in [0, 1] -> an inferno-like colormap."""
    x = np.clip(np.asarray(heatmap, np.float32), 0, 1)
    r = np.clip(2.0 * x, 0, 1)
    g = np.clip(2.0 * x - 0.5, 0, 1) ** 1.5
    b = np.clip(1.0 - 2.0 * x, 0, 1) * 0.5 + 0.1 * x
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def visualize_score(score: np.ndarray) -> np.ndarray:
    return visualize_heatmap(score)


def visualize_depth(depth: np.ndarray) -> np.ndarray:
    d = np.asarray(depth, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    valid = d > 0
    if valid.any():
        lo, hi = np.percentile(d[valid], [2, 98])
        d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    return visualize_heatmap(np.where(valid, d, 0))


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    lut = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ])
    return np.take_along_axis(lut, i[None, ..., None], 0)[0]


def visualize_instance_offset(offset: np.ndarray) -> np.ndarray:
    """Offset vectors as a color wheel (hue = direction, sat = magnitude)."""
    off = np.asarray(offset, np.float32)
    angle = np.arctan2(off[..., 0], off[..., 1])
    mag = np.linalg.norm(off, axis=-1)
    mag = mag / max(mag.max(), 1e-6)
    rgb = _hsv_to_rgb((angle / (2 * np.pi)) % 1.0, mag, np.ones_like(mag))
    return (rgb * 255).astype(np.uint8)


def visualize_instance_center(center: np.ndarray) -> np.ndarray:
    c = np.asarray(center)
    if c.ndim == 3:
        c = c[..., 0]
    return visualize_heatmap(c)


def visualize_instance(instance: np.ndarray,
                       color_generator: Optional[InstanceColorGenerator] = None
                       ) -> np.ndarray:
    gen = color_generator or InstanceColorGenerator()
    return gen.colorize(np.asarray(instance))


def visualize_panoptic(panoptic: np.ndarray,
                       dataset_config: Optional[DatasetConfig] = None,
                       color_generator: Optional[PanopticColorGenerator] = None
                       ) -> np.ndarray:
    gen = color_generator
    if gen is None:
        if dataset_config is None:
            raise ValueError(
                "visualize_panoptic needs a color generator or dataset_config"
            )
        gen = ColorGenerators.for_dataset(dataset_config).panoptic
    return gen.colorize(np.asarray(panoptic))


def visualize_orientation(orientation: np.ndarray,
                          foreground: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """Dense biternion field -> hue by angle."""
    o = np.asarray(orientation, np.float32)
    angle = (np.arctan2(o[..., 0], o[..., 1]) / (2 * np.pi)) % 1.0
    rgb = _hsv_to_rgb(angle, np.ones_like(angle), np.ones_like(angle))
    img = (rgb * 255).astype(np.uint8)
    if foreground is not None:
        img[~np.asarray(foreground, bool)] = 0
    return img


def visualize_instance_orientations(
    instance: np.ndarray,
    orientations: Dict[int, float],
    shared_color_generator: Optional[InstanceColorGenerator] = None,
    thickness: int = 3,
    font_size: int = 45,
    bg_color: int = 0,
    bg_color_font: str = "black",
    draw_arrows: bool = True,
) -> np.ndarray:
    """Per-instance orientation overlay: instance masks filled with the
    shared instance color plus a centroid arrow along the yaw (0 deg =
    image-up, clockwise) and the angle in degrees as text at the
    centroid + (2, 2), in the font's pixels scaled to about font_size / 3
    pixels high."""
    inst = np.asarray(instance)
    out = np.full((*inst.shape, 3), np.uint8(bg_color), np.uint8)
    items = sorted((orientations or {}).items())
    for iid, theta in items:
        mask = inst == iid
        if not mask.any():
            continue
        if shared_color_generator is not None:
            color = np.asarray(shared_color_generator.color(int(iid)),
                               np.uint8)
        else:
            hue = (theta / (2 * np.pi)) % 1.0
            color = (_hsv_to_rgb(np.asarray([hue]), np.asarray([1.0]),
                                 np.asarray([1.0]))[0] * 255
                     ).astype(np.uint8)
        out[mask] = color
    if not draw_arrows or not items:
        return out

    scale = max(1, round(max(font_size // 3, 8) / imaging.GLYPH_HEIGHT))
    text_color = TEXT_COLORS[bg_color_font]
    for iid, theta in items:
        ys, xs = np.nonzero(inst == iid)
        if ys.size == 0:
            continue
        cy, cx = float(ys.mean()), float(xs.mean())
        # arrow length scales with the instance footprint
        length = max(np.sqrt(ys.size) * 0.6, 8.0)
        dx = np.sin(theta) * length
        dy = -np.cos(theta) * length
        tip = (cx + dx, cy + dy)
        imaging.draw_line(out, (cx, cy), tip, WHITE, thickness)
        # arrowhead: two short lines rotated +-150 deg from the shaft
        for rot in (np.deg2rad(150), -np.deg2rad(150)):
            hx = np.sin(theta + rot) * length * 0.35
            hy = -np.cos(theta + rot) * length * 0.35
            imaging.draw_line(out, tip, (tip[0] + hx, tip[1] + hy), WHITE,
                              thickness)
        deg = int(round(np.degrees(theta))) % 360
        imaging.draw_text(out, (cx + 2, cy + 2), f"{deg}°", text_color,
                          scale)
    return out


def dense_instance_maps(predictions, b):
    """(center (H,W,1), offset (H,W,2), orientation (H,W,2)) for sample b.

    Accepts both postprocessing layouts: the dense keys
    ('instance_centers' / 'instance_offsets' / 'instance_orientation')
    and the parity-plane layout ('instance_head_planes' (N, C, 4, H/2,
    W/2)), interleaved here on the host. Missing entries are None.
    """
    center = offset = orientation = None
    if "instance_centers" in predictions:
        center = np.asarray(predictions["instance_centers"][b])
        offset = np.asarray(predictions["instance_offsets"][b])
        if "instance_orientation" in predictions:
            orientation = np.asarray(predictions["instance_orientation"][b])
    elif "instance_head_planes" in predictions:
        planes = np.asarray(predictions["instance_head_planes"][b])
        maps = interleave_planes_np(planes)  # (C, H, W)
        center = maps[0][..., None]
        offset = np.moveaxis(maps[1:3], 0, -1)
        if maps.shape[0] >= 5:
            orientation = np.moveaxis(maps[3:5], 0, -1)
    return center, offset, orientation


def blend(rgb: np.ndarray, overlay: np.ndarray, alpha: float = 0.5
          ) -> np.ndarray:
    rgb = np.asarray(rgb, np.float32)
    overlay = np.asarray(overlay, np.float32)
    return np.clip((1 - alpha) * rgb + alpha * overlay, 0, 255).astype(
        np.uint8
    )


# ---------------------------------------------------------------------------
# writers (PNG / JSON per identifier)


def _save_png(path: str, img: np.ndarray) -> None:
    write_png(os.path.abspath(path), img)


def _identifier(identifiers, b: int) -> str:
    if identifiers is not None and hasattr(identifiers[b], "to_filename"):
        return identifiers[b].to_filename()
    return f"sample_{b:04d}"


def _orientation_overlays(output_path, prefix, ident, instance, oris,
                          gen) -> None:
    for suffix, kw in (("orientations",
                        dict(bg_color=0, bg_color_font="black")),
                       ("orientations_white_bg",
                        dict(bg_color=255, bg_color_font="white"))):
        _save_png(os.path.join(output_path, prefix + suffix, f"{ident}.png"),
                  visualize_instance_orientations(
                      instance, oris, shared_color_generator=gen, **kw))


def visualize_predictions(
    predictions: Dict[str, np.ndarray],
    batch: Dict[str, Any],
    output_path: str,
    dataset_config: DatasetConfig,
    colors: ColorGenerators,
    batch_index: Optional[int] = None,
) -> None:
    """Write one PNG per prediction key per sample (reference
    `visualize_predictions`), and the scene as JSON. predictions: numpy
    arrays of the postprocessed outputs."""
    palette = semantic_colors(dataset_config)
    identifiers = batch.get("identifier")
    n = None
    for v in predictions.values():
        if hasattr(v, "shape") and len(getattr(v, "shape", ())) >= 1:
            n = v.shape[0]
            break
    if n is None:
        return
    indices = range(n) if batch_index is None else [batch_index]
    for b in indices:
        ident = _identifier(identifiers, b)
        if "semantic_segmentation_idx" in predictions:
            sem = np.asarray(predictions["semantic_segmentation_idx"][b]) + 1
            _save_png(os.path.join(output_path, "semantic", f"{ident}.png"),
                      visualize_semantic(sem, palette))
            _save_png(
                os.path.join(output_path, "semantic_score", f"{ident}.png"),
                visualize_score(
                    np.asarray(predictions["semantic_segmentation_score"][b])
                ),
            )
        # one host-side plane interleave per sample feeds the center /
        # offset / orientation renderers below
        center, offset, orientation = dense_instance_maps(predictions, b)
        if "instance_segmentation" in predictions:
            _save_png(
                os.path.join(output_path, "instance", f"{ident}.png"),
                visualize_instance(
                    np.asarray(predictions["instance_segmentation"][b]),
                    colors.instance),
            )
            if center is not None:
                _save_png(os.path.join(output_path, "instance_center",
                                       f"{ident}.png"),
                          visualize_instance_center(center))
            if offset is not None:
                _save_png(os.path.join(output_path, "instance_offset",
                                       f"{ident}.png"),
                          visualize_instance_offset(offset))
        if "panoptic_segmentation_deeplab" in predictions:
            _save_png(
                os.path.join(output_path, "panoptic", f"{ident}.png"),
                visualize_panoptic(np.asarray(
                    predictions["panoptic_segmentation_deeplab"][b]),
                    color_generator=colors.panoptic),
            )
        if orientation is not None:
            fg = None
            if "panoptic_foreground_mask" in predictions:
                fg = np.asarray(predictions["panoptic_foreground_mask"][b])
            _save_png(
                os.path.join(output_path, "orientation", f"{ident}.png"),
                visualize_orientation(orientation, fg),
            )
        if (
            "orientations_instance" in predictions
            and "instance_segmentation" in predictions
        ):
            # per-instance overlay with arrows + degree text (reference
            # *_orientations / *_orientations_white_bg outputs)
            angles = np.asarray(predictions["orientations_instance"][b])
            valid = predictions.get("orientations_panoptic_instance_valid")
            inst_map = np.asarray(predictions["instance_segmentation"][b])
            present = set(np.unique(inst_map)) - {0}
            oris = {
                k + 1: float(angles[k])
                for k in range(angles.shape[0])
                if (k + 1) in present
                and (valid is None or bool(np.asarray(valid[b])[k]))
            }
            _orientation_overlays(output_path, "", ident, inst_map, oris,
                                  colors.instance)
        if "scene_class_idx" in predictions:
            scene_idx = int(predictions["scene_class_idx"][b]) + 1
            names = dataset_config.scene_class_names
            meta = {
                "scene_class_idx": scene_idx,
                "scene_class_name": names[scene_idx]
                if scene_idx < len(names) else str(scene_idx),
                "scene_class_score": float(
                    predictions["scene_class_score"][b]
                ),
            }
            path = os.path.join(output_path, "scene", f"{ident}.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as fh:
                json.dump(meta, fh, indent=2)


def visualize_batches(
    batch: Dict[str, Any],
    output_path: str,
    dataset_config: DatasetConfig,
    colors: ColorGenerators,
) -> None:
    """Write the ground truth's visualizations for a batch (reference
    `visualize_batches`)."""
    palette = semantic_colors(dataset_config)
    identifiers = batch.get("identifier")
    rgb = batch.get("rgb")
    n = len(identifiers) if identifiers is not None else (
        rgb.shape[0] if rgb is not None else 0
    )
    for b in range(n):
        ident = _identifier(identifiers, b)
        if "semantic" in batch:
            _save_png(os.path.join(output_path, "gt_semantic", f"{ident}.png"),
                      visualize_semantic(np.asarray(batch["semantic"][b]),
                                         palette))
        if "instance" in batch:
            _save_png(os.path.join(output_path, "gt_instance", f"{ident}.png"),
                      visualize_instance(np.asarray(batch["instance"][b]),
                                         colors.instance))
        if "instance_center" in batch:
            _save_png(
                os.path.join(output_path, "gt_instance_center",
                             f"{ident}.png"),
                visualize_instance_center(
                    np.asarray(batch["instance_center"][b])
                ),
            )
        if "panoptic" in batch:
            _save_png(os.path.join(output_path, "gt_panoptic", f"{ident}.png"),
                      visualize_panoptic(np.asarray(batch["panoptic"][b]),
                                         color_generator=colors.panoptic))
        if "instance" in batch and "orientations" in batch:
            oris = batch["orientations"][b] or {}
            _orientation_overlays(
                output_path, "gt_", ident, np.asarray(batch["instance"][b]),
                {int(k): float(v) for k, v in oris.items()}, colors.instance)
        if "depth" in batch:
            _save_png(os.path.join(output_path, "gt_depth", f"{ident}.png"),
                      visualize_depth(np.asarray(batch["depth"][b])))
