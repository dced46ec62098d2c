"""On-device input normalization (counterpart:
`emsanet_tpu/ops/device_prep.py`).

Raw uint8 RGB and raw uint16 depth go to the card as they are; the
standardization runs there. Tensors are NHWC, like the JAX package.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

# ImageNet statistics
_RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
_RGB_SCALE = (1.0 / (255.0 * _RGB_STD)).astype(np.float32)
_RGB_SHIFT = (_RGB_MEAN / _RGB_STD).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rgb_affine(device: torch.device):
    """(scale, shift) on `device`, copied there once: a copy from pageable
    host memory makes the host wait for the device's queue, every frame."""
    return (torch.from_numpy(_RGB_SCALE).to(device),
            torch.from_numpy(_RGB_SHIFT).to(device))


def normalize_rgb_device(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> standardized float32."""
    scale, shift = _rgb_affine(rgb_u8.device)
    return rgb_u8.to(torch.float32) * scale - shift


def normalize_depth_device(
    depth_raw: torch.Tensor,
    depth_mean: float,
    depth_std: float,
    raw_depth: bool = False,
) -> torch.Tensor:
    """(N, H, W, 1) raw-unit depth -> standardized float32.

    raw_depth keeps invalid (0) pixels at exactly 0.
    """
    d = depth_raw.to(torch.float32)
    normalized = (d - np.float32(depth_mean)) / np.float32(depth_std)
    if raw_depth:
        normalized = torch.where(d > 0, normalized, 0.0)
    return normalized


def prepare_inputs_device(
    batch: Dict[str, torch.Tensor],
    depth_mean: float,
    depth_std: float,
    raw_depth: bool = False,
) -> Dict[str, torch.Tensor]:
    """Normalize raw rgb/depth batch entries (floats pass through)."""
    out = dict(batch)
    rgb = batch.get("rgb")
    if rgb is not None and rgb.dtype == torch.uint8:
        out["rgb"] = normalize_rgb_device(rgb)
    depth = batch.get("depth")
    if depth is not None and depth.dtype != torch.float32:
        if depth.ndim == 3:
            depth = depth[..., None]
        out["depth"] = normalize_depth_device(
            depth, depth_mean, depth_std, raw_depth
        )
    return out
