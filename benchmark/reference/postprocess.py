"""Panoptic-DeepLab postprocessing of EMSANet's maps, plain PyTorch.

The semantics of EMSANet's published postprocessing, per image:
- semantic: the argmax class and its softmax probability;
- centers: a pixel of the center heatmap is a candidate where it equals
  the maximum of its 17x17 window (padded with -inf) and exceeds 0.1;
  the 64 highest candidates are kept; a
  candidate within Chebyshev distance 8 of a higher-ranked one is dropped;
  ties of the heatmap rank by the pixel order the caller names: row-major,
  or parity-major (the pixels (2i + p, 2j + q) of plane p * 2 + q, plane
  by plane, each row-major), the order of a program that decodes the
  heads on parity planes;
- grouping: each foreground pixel (a thing class) votes at its position
  plus its offset (scaled by the image's height and width) and takes the
  nearest valid center (the first of tied ones); 0 is no instance;
- panoptic merge: each instance takes the majority thing class of its
  pixels; a thing pixel with an instance of a class is class * 2^16 +
  instance id, a thing pixel without one void (0), a stuff pixel
  class * 2^16;
- orientation: the circular mean of the (sin, cos) field over each
  instance's pixels, in [0, 2 pi).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

LABEL_DIVISOR = 2 ** 16
THRESHOLD = 0.1
NMS_KERNEL = 17
TOP_K = 64


def semantic_decode(logits: torch.Tensor):
    """(N, C, H, W) logits -> int32 class (N, H, W), float32 score."""
    idx = logits.argmax(1).to(torch.int32)
    score = 1.0 / torch.exp(logits - logits.amax(1, keepdim=True)).sum(1)
    return idx, score


def pixel_order(h: int, w: int, parity: bool, device) -> torch.Tensor:
    """Flat pixel indices in row-major or parity-major order."""
    idx = torch.arange(h * w, device=device)
    if not parity:
        return idx
    return idx.reshape(h // 2, 2, w // 2, 2).permute(1, 3, 0, 2).reshape(-1)


def find_centers(center: torch.Tensor, parity: bool = False):
    """center (H, W) -> yx (K, 2) int64, scores (K,), valid (K,)."""
    h, w = center.shape
    pooled = F.max_pool2d(center[None, None], NMS_KERNEL, 1,
                          NMS_KERNEL // 2)[0, 0]
    hm = torch.where((center >= pooled) & (center > THRESHOLD), center, 0.0)
    order = pixel_order(h, w, parity, center.device)
    scores, pos = torch.sort(hm.reshape(-1)[order], descending=True,
                             stable=True)
    scores, flat = scores[:TOP_K], order[pos[:TOP_K]]
    valid = scores > 0
    yx = torch.stack([flat // w, flat % w], -1)
    radius = NMS_KERNEL // 2
    near = ((yx[:, None, :] - yx[None, :, :]).abs() <= radius).all(-1)
    earlier = torch.ones(TOP_K, TOP_K, dtype=torch.bool,
                         device=center.device).tril(-1)
    dup = (near & earlier & valid[None, :]).any(-1)
    return yx, scores, valid & ~dup


def group(yx, valid, offset, foreground):
    """offset (2, H, W) normalized (dy, dx); foreground (H, W) bool ->
    instance ids (H, W) int32 in [0, K]."""
    _, h, w = offset.shape
    ys = torch.arange(h, device=offset.device, dtype=torch.float32)
    xs = torch.arange(w, device=offset.device, dtype=torch.float32)
    vy = (ys[:, None] + offset[0] * h).reshape(-1)
    vx = (xs[None, :] + offset[1] * w).reshape(-1)
    cy, cx = yx[:, 0].float(), yx[:, 1].float()
    dist = (vy[:, None] - cy[None]) ** 2 + (vx[:, None] - cx[None]) ** 2
    dist = torch.where(valid[None], dist, math.inf)
    best = dist.argmin(1).reshape(h, w).to(torch.int32) + 1
    keep = foreground & valid.any()
    return torch.where(keep, best, 0)


def merge(sem_full, sem_score, inst, scores, valid, is_thing, orientation):
    """One image's panoptic merge. sem_full (H, W) class in the full label
    space (0 void), inst (H, W) in [0, K], orientation (2, H, W) or None.
    """
    k = scores.shape[0]
    n_cls = is_thing.shape[0]
    thing = is_thing[sem_full.long()]
    key = inst.long() * n_cls + sem_full.long()
    hist = torch.zeros((k + 1) * n_cls, device=inst.device).index_add_(
        0, key.reshape(-1), thing.float().reshape(-1)).view(k + 1, n_cls)
    hist = torch.where(is_thing[None], hist, 0.0)
    has_votes = hist.amax(1) > 0
    inst_sem = torch.where(has_votes, hist.argmax(1), 0)
    pix_sem = inst_sem[inst.long()]
    assigned = thing & (inst > 0) & (pix_sem > 0)
    panoptic = torch.where(
        assigned, pix_sem * LABEL_DIVISOR + inst.long(),
        torch.where(thing, 0, sem_full.long() * LABEL_DIVISOR))
    out = {
        "panoptic": panoptic.to(torch.int32),
        "meta_semantic_idx": inst_sem[1:].to(torch.int32),
        "meta_area": hist.sum(1)[1:].to(torch.int32),
        "meta_score": scores,
        "meta_valid": has_votes[1:] & valid,
    }
    if orientation is not None:
        sums = torch.zeros(k + 1, 2, device=inst.device).index_add_(
            0, inst.long().reshape(-1), orientation.reshape(2, -1).T)
        out["orientations"] = torch.remainder(
            torch.atan2(sums[1:, 0], sums[1:, 1]), 2 * math.pi)
    return out


def postprocess_image(sem_idx, sem_score, instance, is_thing,
                      parity: bool = False) -> Dict[str, torch.Tensor]:
    """One image's instance, panoptic and orientation results from its
    semantic class (H, W) (0-based, without void) and score, and its
    instance maps (5, H, W): center, offset, orientation; heatmap ties
    ranked in parity-major order with `parity`."""
    sem_full = sem_idx.long() + 1
    foreground = is_thing[sem_full]
    yx, scores, valid = find_centers(instance[0], parity)
    inst = group(yx, valid, instance[1:3], foreground)
    out = merge(sem_full, sem_score, inst, scores, valid, is_thing,
                instance[3:5] if instance.shape[0] >= 5 else None)
    out.update(instance=inst, centers_yx=yx, centers_score=scores,
               centers_valid=valid, foreground=foreground)
    return out
