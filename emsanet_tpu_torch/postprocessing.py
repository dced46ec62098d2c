"""Postprocessing: semantic, instance, panoptic, orientation, scene.

Counterpart of `emsanet_tpu/postprocessing.py::postprocess` (:804-1252):
fixed-shape, batched tensor code on the device. Center NMS by max
pooling, top-k padded to `top_k` centers with a validity mask,
duplicate-center suppression, pixel grouping (`ops/grouping.py`), the
Panoptic-DeepLab merge by majority vote (`ops/segment_kernels.py`),
per-instance orientations and the scene softmax; the normal map passes
through. Tensors are NHWC / (N, H, W), like the JAX package. Without
`fused_inference` no head defers, and the full-resolution pipeline below
runs on the decoders' maps (:804-1054), through the same grouping and
segment kernels.

Deferred heads (`decode_input`, the 'decode*' modes) are dispatched as
the JAX package does (:825-935):
- with both heads deferred and any mode but 'decode-both', the whole
  pipeline runs on parity planes (`_postprocess_planes`): the semantic
  decode and instance head kernels emit planes, NMS, grouping and merge
  run in parity-major pixel order, and only the final maps are
  interleaved (`ops/plane_interleave.py`);
- otherwise a deferred semantic head is decoded to full-res maps
  (`ops/semantic_decode.py`) and a deferred instance head to full-res
  center / offset / orientation maps (`ops/instance_head.py`), and the
  interleaved pipeline takes over.

The kernels run where the JAX package calls its Pallas kernels on the
TPU (postprocessing.py:335, :500, :655, :693, :768, :857, :910, :1096,
:1130, :385); on CPU tensors their plain versions run.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from emsanet_tpu_torch.config import ModelConfig
from emsanet_tpu_torch.ops import grouping as grouping_ops
from emsanet_tpu_torch.ops import instance_head as instance_head_ops
from emsanet_tpu_torch.ops import plane_interleave as interleave_ops
from emsanet_tpu_torch.ops import segment_kernels as segment_ops
from emsanet_tpu_torch.ops import semantic_decode as semantic_decode_ops
from emsanet_tpu_torch.ops.plane_interleave import (  # noqa: F401
    deinterleave_plane,
    interleave_plane,
)
from emsanet_tpu_torch.ops.segment_ops import small_table_lookup

LABEL_DIVISOR = 2**16
VOID_LABEL = 0


# ---------------------------------------------------------------------------
# semantic


def _decode_classes(y: torch.Tensor, dim: int):
    """argmax + max-softmax score over `dim` (score = 1 / sum exp(y - max)).

    The difference is taken in the input dtype and exponentiated in f32,
    as the JAX package does.
    """
    idx = torch.argmax(y, dim=dim).to(torch.int32)
    mx = torch.amax(y, dim=dim, keepdim=True)
    sumexp = torch.exp((y - mx).float()).sum(dim=dim)
    return idx, 1.0 / sumexp


def postprocess_semantic(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """logits (N, H, W, C) -> 0-based class index and max-softmax score."""
    idx, score = _decode_classes(logits, dim=-1)
    return {"segmentation_idx": idx, "score": score}


def postprocess_semantic_polyphase(
    y4c: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Semantic decode in the deferred polyphase domain.

    y4c: (N, H/2, W/2, 4C), channel c*4 + (p*2+q). The per-pixel
    reductions commute with the interleave, so they run at half
    resolution and only the idx/score maps are interleaved.
    """
    n, h2, w2, c4 = y4c.shape
    y = y4c.reshape(n, h2, w2, c4 // 4, 2, 2)
    idx, score = _decode_classes(y, dim=3)  # (N, H/2, W/2, 2, 2)

    def interleave(a):
        return a.permute(0, 1, 3, 2, 4).reshape(n, 2 * h2, 2 * w2)

    return {"segmentation_idx": interleave(idx), "score": interleave(score)}


# ---------------------------------------------------------------------------
# instance


def _nms_keep_mask(heatmap: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """x == maxpool_k(x) with SAME padding by -inf (separable)."""
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    x = heatmap[:, None]
    pooled = F.max_pool2d(F.pad(x, (0, 0, lo, hi), value=-math.inf),
                          (kernel_size, 1), stride=1)
    pooled = F.max_pool2d(F.pad(pooled, (lo, hi, 0, 0), value=-math.inf),
                          (1, kernel_size), stride=1)
    return heatmap >= pooled[:, 0]


def _pool1d(x: torch.Tensor, lo: int, hi: int, axis: int) -> torch.Tensor:
    """out[i] = max over e in [lo, hi] of x[i+e], -inf outside the extent.

    x is (N, 2, H/2, W/2); axis 2 (rows) or 3 (columns)."""
    if hi < lo:
        return torch.full_like(x, -math.inf)
    size = x.shape[axis]
    pad_lo, pad_hi = max(0, -lo), max(0, hi)
    pad = (0, 0, pad_lo, pad_hi) if axis == 2 else (pad_lo, pad_hi, 0, 0)
    xp = F.pad(x, pad, value=-math.inf)
    k = hi - lo + 1
    xp = xp.narrow(axis, lo + pad_lo, size + k - 1)
    window = (k, 1) if axis == 2 else (1, k)
    return F.max_pool2d(xp, window, stride=1)


def _nms_keep_mask_planes(hm: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """`_nms_keep_mask` on parity planes (bitwise the same).

    hm: (N, 2, 2, H/2, W/2), full-res pixel (2i+p, 2j+q) = hm[:, p, q, i,
    j]. The full-res window [lo, hi] = [-(k-1)//2, k//2] splits into a
    same-parity window and a cross-parity window that depends on the own
    parity (`emsanet_tpu/postprocessing.py:175-215`); rows, then columns.
    """
    lo_f, hi_f = -((kernel_size - 1) // 2), kernel_size // 2
    s_lo, s_hi = (lo_f + 1) // 2, hi_f // 2

    def bounds(par):
        return (lo_f + 2 * par) // 2, (hi_f - 1 + 2 * par) // 2

    rp = []
    for p in (0, 1):
        lo, hi = bounds(p)
        rp.append(torch.maximum(_pool1d(hm[:, p], s_lo, s_hi, axis=2),
                                _pool1d(hm[:, 1 - p], lo, hi, axis=2)))
    rp = torch.stack(rp, dim=1)  # (N, 2, 2, H/2, W/2)
    cp = []
    for q in (0, 1):
        lo, hi = bounds(q)
        cp.append(torch.maximum(_pool1d(rp[:, :, q], s_lo, s_hi, axis=3),
                                _pool1d(rp[:, :, 1 - q], lo, hi, axis=3)))
    return hm >= torch.stack(cp, dim=2)


def _top_k(flat: torch.Tensor, k: int):
    """Top-k along the last axis, ties by lowest index (lax.top_k's
    order): a stable descending sort."""
    values, indices = torch.sort(flat, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def _suppress_duplicate_centers(yx: torch.Tensor, valid: torch.Tensor,
                                radius: int) -> torch.Tensor:
    """Drop centers with a higher-ranked candidate within Chebyshev
    `radius` (the tied-plateau tie-break of the JAX package)."""
    y = yx[..., 0]
    x = yx[..., 1]
    close = ((y[:, :, None] - y[:, None, :]).abs() <= radius) & (
        (x[:, :, None] - x[:, None, :]).abs() <= radius)
    k = yx.shape[1]
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                    device=yx.device), -1)
    dup = (close & earlier[None] & valid[:, None, :]).any(dim=-1)
    return valid & ~dup


def find_instance_centers(
    center_heatmap: torch.Tensor,
    threshold: float = 0.1,
    nms_kernel_size: int = 17,
    top_k: int = 64,
    foreground_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Up to `top_k` centers per image: 'yx' (N, K, 2) int32, 'scores',
    'valid'."""
    n, h, w = center_heatmap.shape
    hm = center_heatmap
    if foreground_mask is not None:
        hm = torch.where(foreground_mask, hm, 0.0)
    keep = _nms_keep_mask(hm, nms_kernel_size)
    hm = torch.where(keep & (hm > threshold), hm, 0.0)
    scores, flat_idx = _top_k(hm.reshape(n, h * w), top_k)
    valid = scores > 0.0
    yx = torch.stack([flat_idx // w, flat_idx % w], dim=-1).to(torch.int32)
    valid = _suppress_duplicate_centers(yx, valid, nms_kernel_size // 2)
    return {"yx": yx, "scores": scores, "valid": valid}


def find_instance_centers_planes(
    heatmap_planes: torch.Tensor,
    threshold: float = 0.1,
    nms_kernel_size: int = 17,
    top_k: int = 64,
    foreground_planes: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """`find_instance_centers` on (N, 4, H/2, W/2) parity planes; 'yx' in
    full-res coordinates. The top-k runs over the parity-major flat
    order, ties by lowest index, as in the JAX package."""
    n, four, h2, w2 = heatmap_planes.shape
    hm = heatmap_planes
    if foreground_planes is not None:
        hm = torch.where(foreground_planes, hm, 0.0)
    keep = _nms_keep_mask_planes(hm.reshape(n, 2, 2, h2, w2),
                                 nms_kernel_size).reshape(n, 4, h2, w2)
    hm = torch.where(keep & (hm > threshold), hm, 0.0)
    scores, flat_idx = _top_k(hm.reshape(n, four * h2 * w2), top_k)
    valid = scores > 0.0
    par = flat_idx // (h2 * w2)
    rem = flat_idx % (h2 * w2)
    ys = 2 * (rem // w2) + par // 2
    xs = 2 * (rem % w2) + par % 2
    yx = torch.stack([ys, xs], dim=-1).to(torch.int32)
    valid = _suppress_duplicate_centers(yx, valid, nms_kernel_size // 2)
    return {"yx": yx, "scores": scores, "valid": valid}


@functools.lru_cache(maxsize=None)
def _offset_scale(h: int, w: int, device: torch.device) -> torch.Tensor:
    """[h, w] f32 on `device`, made there once per size: a copy from
    pageable host memory makes the host wait for the device's queue."""
    return torch.tensor([h, w], dtype=torch.float32).to(device)


def _instance_ids(best, best_d, centers_valid, foreground,
                  offset_distance_threshold):
    instance_id = best + 1
    any_valid = centers_valid.any(dim=-1)[:, None]
    if offset_distance_threshold is not None:
        near = best_d <= torch.tensor(float(offset_distance_threshold),
                                      dtype=torch.float32) ** 2
        instance_id = torch.where(near, instance_id, 0)
    instance_id = torch.where(any_valid, instance_id, 0)
    return torch.where(foreground, instance_id, 0)


def group_pixels_to_instances_planes(
    centers_yx: torch.Tensor,
    centers_valid: torch.Tensor,
    offset_y_planes: torch.Tensor,
    offset_x_planes: torch.Tensor,
    foreground_flat: torch.Tensor,
    full_hw,
    normalized_offset: bool = True,
    offset_distance_threshold: Optional[float] = None,
) -> torch.Tensor:
    """`group_pixels_to_instances` in parity-major flat pixel order.

    offset planes: (N, 4, H/2, W/2) (dy / dx); foreground_flat (N, P)
    bool, P = 4 H/2 W/2 in the same order. Returns (N, P) int32 ids in
    [0, K]. The voted position is formed as in the interleaved path, so
    the grouping kernel's distances are bit-identical."""
    n, four, h2, w2 = offset_y_planes.shape
    h, w = full_hw
    dev = offset_y_planes.device
    par = torch.arange(four, device=dev)[:, None, None]
    iy = torch.arange(h2, device=dev)[None, :, None]
    jx = torch.arange(w2, device=dev)[None, None, :]
    loc_y = (2 * iy + par // 2).float().expand(four, h2, w2)
    loc_x = (2 * jx + par % 2).float().expand(four, h2, w2)
    off_y = offset_y_planes.float()
    off_x = offset_x_planes.float()
    if normalized_offset:
        scale = _offset_scale(h, w, dev)
        off_y = off_y * scale[0]
        off_x = off_x * scale[1]
    voted = torch.stack([loc_y[None] + off_y, loc_x[None] + off_x],
                        dim=-1).reshape(n, four * h2 * w2, 2)
    best, best_d = grouping_ops.group_pixels_argmin(
        voted, centers_yx.float().contiguous(), centers_valid.contiguous())
    return _instance_ids(best, best_d, centers_valid, foreground_flat,
                         offset_distance_threshold)


def group_pixels_to_instances(
    centers_yx: torch.Tensor,
    centers_valid: torch.Tensor,
    offset: torch.Tensor,
    foreground_mask: torch.Tensor,
    normalized_offset: bool = True,
    offset_distance_threshold: Optional[float] = None,
) -> torch.Tensor:
    """Assign each foreground pixel to its nearest voted center.

    offset: (N, H, W, 2) (dy, dx); returns (N, H, W) int32 ids in [0, K]
    with 0 = unassigned.
    """
    n, h, w, _ = offset.shape
    dev = offset.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    loc = torch.stack([ys, xs], dim=-1)
    off = offset.float()
    if normalized_offset:
        off = off * _offset_scale(h, w, dev)
    voted = (loc[None] + off).reshape(n, h * w, 2)
    best, best_d = grouping_ops.group_pixels_argmin(
        voted, centers_yx.float().contiguous(), centers_valid.contiguous())
    return _instance_ids(best, best_d, centers_valid,
                         foreground_mask.reshape(n, h * w),
                         offset_distance_threshold).reshape(n, h, w)


def postprocess_instance(
    center: torch.Tensor,
    offset: torch.Tensor,
    foreground_mask: torch.Tensor,
    threshold: float = 0.1,
    nms_kernel_size: int = 17,
    top_k: int = 64,
    apply_foreground_mask_to_heatmap: bool = False,
    normalized_offset: bool = True,
    offset_distance_threshold: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Heatmap -> centers -> grouping."""
    centers = find_instance_centers(
        center[..., 0],
        threshold=threshold,
        nms_kernel_size=nms_kernel_size,
        top_k=top_k,
        foreground_mask=(
            foreground_mask if apply_foreground_mask_to_heatmap else None
        ),
    )
    seg = group_pixels_to_instances(
        centers["yx"], centers["valid"], offset, foreground_mask,
        normalized_offset=normalized_offset,
        offset_distance_threshold=offset_distance_threshold,
    )
    return {
        "segmentation": seg,
        "centers_yx": centers["yx"],
        "centers_score": centers["scores"],
        "centers_valid": centers["valid"],
    }


# ---------------------------------------------------------------------------
# panoptic merge


def panoptic_merge(
    semantic_idx: torch.Tensor,
    semantic_score: torch.Tensor,
    instance_seg: torch.Tensor,
    centers_score: torch.Tensor,
    centers_valid: torch.Tensor,
    is_thing: torch.Tensor,
    n_classes: int,
    label_divisor: int = LABEL_DIVISOR,
    void_label: int = VOID_LABEL,
    orientation_vectors: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Panoptic-DeepLab merge on (N, H, W) maps (see `panoptic_merge_flat`)."""
    n, h, w = semantic_idx.shape
    flat = panoptic_merge_flat(
        semantic_idx.reshape(n, h * w),
        semantic_score.reshape(n, h * w),
        instance_seg.reshape(n, h * w),
        centers_score, centers_valid, is_thing, n_classes,
        label_divisor=label_divisor, void_label=void_label,
        orientation_vectors=(
            orientation_vectors.reshape(n, h * w, 2)
            if orientation_vectors is not None else None
        ),
    )
    out = dict(flat)
    for key in ("panoptic", "panoptic_score", "pixel_instance_semantic",
                "foreground_mask"):
        out[key] = flat[key].reshape(n, h, w)
    return out


def panoptic_merge_flat(
    semantic_idx: torch.Tensor,
    semantic_score: torch.Tensor,
    instance_seg: torch.Tensor,
    centers_score: torch.Tensor,
    centers_valid: torch.Tensor,
    is_thing: torch.Tensor,
    n_classes: int,
    label_divisor: int = LABEL_DIVISOR,
    void_label: int = VOID_LABEL,
    orientation_vectors: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Majority-vote semantics per instance over flat (N, P) maps.

    semantic_idx is in the full label space (0 = void); instance_seg in
    [0, K] (0 = none); is_thing (C_full,) bool. With
    `orientation_vectors` (N, P, 2), the per-instance orientation sums
    ride the same segment pass and come back as 'instance_orientations'.
    """
    n, n_pix = semantic_idx.shape
    k = centers_score.shape[1]
    thing_mask = small_table_lookup(semantic_idx, is_thing)
    has_instance = instance_seg > 0
    vote_weight = thing_mask.float()
    flat_or = (orientation_vectors.float().contiguous()
               if orientation_vectors is not None else
               torch.zeros((n, n_pix, 1), dtype=torch.float32,
                           device=semantic_idx.device))
    inst_i32 = instance_seg.to(torch.int32).contiguous()  # both passes
    hist, sums = segment_ops.segment_hist_and_sums(
        inst_i32, semantic_idx.to(torch.int32).contiguous(),
        vote_weight.contiguous(), flat_or,
        num_segments=k + 1, num_classes=n_classes,
    )
    hist = torch.where(is_thing[None, None, :], hist, 0.0)
    inst_semantic = torch.argmax(hist, dim=-1).to(torch.int32)
    inst_has_votes = hist.amax(dim=-1) > 0
    inst_area = hist.sum(dim=-1)
    inst_semantic = torch.where(inst_has_votes, inst_semantic, void_label)

    # (N, 2, K + 1): each instance's class and its center's score (0 for
    # key 0, no instance)
    tables = torch.zeros((n, 2, k + 1), dtype=torch.float32,
                         device=semantic_idx.device)
    tables[:, 0] = inst_semantic
    tables[:, 1, 1:] = centers_score
    looked_up = segment_ops.segment_lookup(inst_i32, tables)
    pixel_inst_sem = looked_up[:, 0].to(torch.int32)
    pixel_inst_score = looked_up[:, 1]

    thing_assigned = thing_mask & has_instance & (pixel_inst_sem > 0)
    panoptic = torch.where(
        thing_assigned,
        pixel_inst_sem * label_divisor + instance_seg,
        torch.where(thing_mask, void_label, semantic_idx * label_divisor),
    ).to(torch.int32)
    panoptic_score = torch.where(
        thing_assigned, pixel_inst_score * semantic_score,
        torch.where(thing_mask, 0.0, semantic_score))

    out_extra = {}
    if orientation_vectors is not None:
        angles = torch.atan2(sums[:, 1:, 0], sums[:, 1:, 1])
        out_extra["instance_orientations"] = torch.remainder(
            angles, 2 * math.pi)
    return {
        **out_extra,
        "panoptic": panoptic,
        "panoptic_score": panoptic_score.float(),
        "pixel_instance_semantic": pixel_inst_sem,
        "foreground_mask": thing_mask,
        "instance_meta_semantic_idx": inst_semantic[:, 1:],
        "instance_meta_area": inst_area[:, 1:].to(torch.int32),
        "instance_meta_score": centers_score,
        "instance_meta_valid": inst_has_votes[:, 1:] & centers_valid,
    }


# ---------------------------------------------------------------------------
# orientation / scene


def aggregate_instance_orientations(
    orientation: torch.Tensor, instance_seg: torch.Tensor, top_k: int,
) -> Dict[str, torch.Tensor]:
    """Per-instance circular mean of the (sin, cos) field -> (N, K) angles
    in [0, 2*pi)."""
    n, h, w, _ = orientation.shape
    flat_inst = instance_seg.reshape(n, h * w).to(torch.int32).contiguous()
    _, sums = segment_ops.segment_hist_and_sums(
        flat_inst, torch.zeros_like(flat_inst),
        torch.zeros(flat_inst.shape, dtype=torch.float32,
                    device=flat_inst.device),
        orientation.reshape(n, h * w, 2).float().contiguous(),
        num_segments=top_k + 1, num_classes=8,  # histogram unused here
    )
    sums = sums[:, 1:]
    angles = torch.atan2(sums[..., 0], sums[..., 1])
    return {"instance_orientations": torch.remainder(angles, 2 * math.pi)}


def postprocess_scene(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    probs = torch.softmax(logits.float(), dim=-1)
    return {
        "class_idx": torch.argmax(probs, dim=-1).to(torch.int32),
        "class_score": probs.amax(dim=-1),
    }


# ---------------------------------------------------------------------------
# top level


def postprocess(
    outputs: Dict[str, Any],
    is_thing: torch.Tensor,
    cfg: Optional[ModelConfig] = None,
    gt_foreground: Optional[torch.Tensor] = None,
    use_orientations: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Full postprocessing over raw model outputs (the flat key contract
    of the JAX package). is_thing: (C_full,) bool, void at 0, on the
    outputs' device."""
    cfg = cfg or ModelConfig()
    if ("decode_input" in outputs.get("semantic", {})
            and "decode_input" in outputs.get("instance", {})
            and cfg.head_decode_fusion != "decode-both"):
        return _postprocess_planes(outputs, is_thing, cfg,
                                   gt_foreground=gt_foreground,
                                   use_orientations=use_orientations)
    results: Dict[str, torch.Tensor] = {}
    n_classes_full = int(is_thing.shape[0])

    semantic_full = semantic_score = None
    if "semantic" in outputs:
        if "decode_input" in outputs["semantic"]:
            di = outputs["semantic"]["decode_input"]
            idx, score = semantic_decode_ops.semantic_decode_interleaved(
                di["x"], di["kernel"])
            sem = {"segmentation_idx": idx, "score": score}
        elif "logits_polyphase" in outputs["semantic"]:
            sem = postprocess_semantic_polyphase(
                outputs["semantic"]["logits_polyphase"])
        else:
            sem = postprocess_semantic(outputs["semantic"]["logits"])
        results["semantic_segmentation_idx"] = sem["segmentation_idx"]
        results["semantic_segmentation_score"] = sem["score"]
        semantic_full = sem["segmentation_idx"] + 1
        semantic_score = sem["score"]

    if "decode_input" in outputs.get("instance", {}):
        outputs = dict(outputs)
        outputs["instance"] = _decode_instance_head(
            outputs["instance"]["decode_input"], cfg)

    if "instance" in outputs:
        inst_out = outputs["instance"]
        if semantic_full is not None:
            foreground = small_table_lookup(semantic_full, is_thing)
        else:
            foreground = torch.ones(inst_out["center"].shape[:3],
                                    dtype=torch.bool,
                                    device=inst_out["center"].device)
        kwargs = dict(
            threshold=cfg.instance_center_heatmap_threshold,
            nms_kernel_size=cfg.instance_center_heatmap_nms_kernel_size,
            top_k=cfg.instance_center_heatmap_top_k,
            apply_foreground_mask_to_heatmap=(
                cfg.instance_center_heatmap_apply_foreground_mask),
            normalized_offset=cfg.instance_normalized_offset,
            offset_distance_threshold=cfg.instance_offset_distance_threshold,
        )
        if gt_foreground is not None:
            results["instance_segmentation_gt_foreground"] = (
                postprocess_instance(inst_out["center"], inst_out["offset"],
                                     gt_foreground.bool(), **kwargs)
            )["segmentation"]
        inst = postprocess_instance(inst_out["center"], inst_out["offset"],
                                    foreground, **kwargs)
        results["instance_segmentation"] = inst["segmentation"]
        results["instance_centers"] = inst_out["center"]
        results["instance_offsets"] = inst_out["offset"]
        results["instance_centers_yx"] = inst["centers_yx"]
        results["instance_centers_score"] = inst["centers_score"]
        results["instance_centers_valid"] = inst["centers_valid"]
        results["instance_foreground"] = foreground

        pan = None
        if semantic_full is not None and cfg.enable_panoptic:
            pan = panoptic_merge(
                semantic_full, semantic_score, inst["segmentation"],
                inst["centers_score"], inst["centers_valid"], is_thing,
                n_classes=n_classes_full,
                orientation_vectors=inst_out.get("orientation"),
            )
            results["panoptic_segmentation_deeplab"] = pan["panoptic"]
            results["panoptic_segmentation_deeplab_panoptic_score"] = pan[
                "panoptic_score"]
            results["panoptic_segmentation_deeplab_semantic_idx"] = pan[
                "pixel_instance_semantic"]
            results["panoptic_foreground_mask"] = pan["foreground_mask"]
            for key in ("semantic_idx", "area", "score", "valid"):
                results[f"panoptic_instance_meta_{key}"] = pan[
                    f"instance_meta_{key}"]

        if "orientation" in inst_out:
            if pan is not None and "instance_orientations" in pan:
                results["orientations_instance"] = pan[
                    "instance_orientations"]
            else:
                results["orientations_instance"] = (
                    aggregate_instance_orientations(
                        inst_out["orientation"], inst["segmentation"],
                        top_k=cfg.instance_center_heatmap_top_k,
                    )["instance_orientations"])
            results["instance_orientation"] = inst_out["orientation"]
            if (use_orientations is not None
                    and "panoptic_instance_meta_semantic_idx" in results):
                inst_sem = results["panoptic_instance_meta_semantic_idx"]
                results["orientations_panoptic_instance_valid"] = (
                    use_orientations[inst_sem.long()]
                    & results["panoptic_instance_meta_valid"])

    if "normal" in outputs:
        results["normal"] = outputs["normal"]["normal"]
    if "scene" in outputs:
        scene = postprocess_scene(outputs["scene"]["logits"])
        results["scene_class_idx"] = scene["class_idx"]
        results["scene_class_score"] = scene["class_score"]
    return results


def _instance_encodings(decode_input: Dict[str, torch.Tensor],
                        cfg: ModelConfig):
    return instance_head_ops.encodings_for(
        decode_input["x"].shape[-1], cfg.instance_sigmoid_for_center,
        cfg.instance_tanh_for_offset)


def _decode_instance_head(decode_input: Dict[str, torch.Tensor],
                          cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A deferred instance head -> the full-res center (N, H, W, 1),
    offset (N, H, W, 2) and orientation (N, H, W, 2) maps, f32."""
    full = instance_head_ops.instance_head_upsample_interleaved(
        decode_input["x"], decode_input["kernel"],
        _instance_encodings(decode_input, cfg))
    maps = full.permute(0, 2, 3, 1)  # (N, H, W, C) view, channel-major
    out = {"center": maps[..., 0:1], "offset": maps[..., 1:3]}
    if full.shape[1] >= 5:
        out["orientation"] = maps[..., 3:5]
    return out


def _postprocess_planes(
    outputs: Dict[str, Any],
    is_thing: torch.Tensor,
    cfg: ModelConfig,
    gt_foreground: Optional[torch.Tensor] = None,
    use_orientations: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Parity-plane postprocessing, both heads deferred (counterpart of
    `emsanet_tpu/postprocessing.py::_postprocess_planes`, :1055-1252,
    key for key).

    The semantic decode and instance head kernels emit parity planes;
    every per-pixel stage (foreground lookup, NMS, grouping, the merge's
    segment passes) runs in parity-major flat order, and only the final
    maps are interleaved, in one `interleave_planes` call. The head maps
    come back as `instance_head_planes` (N, C, 4, H/2, W/2) f32.
    """
    results: Dict[str, torch.Tensor] = {}
    n_classes_full = int(is_thing.shape[0])

    sdi = outputs["semantic"]["decode_input"]
    idx4, score4 = semantic_decode_ops.semantic_decode_planes(
        sdi["x"], sdi["kernel"])
    n, _, h2, w2 = idx4.shape
    h, w = 2 * h2, 2 * w2
    p_total = 4 * h2 * w2
    to_interleave: Dict[str, torch.Tensor] = {
        "semantic_segmentation_idx": idx4,
        "semantic_segmentation_score": score4,
    }
    sem_full_planes = idx4 + 1  # full label space, void at 0
    fg_planes = small_table_lookup(sem_full_planes, is_thing)
    fg_flat = fg_planes.reshape(n, p_total)

    di = outputs["instance"]["decode_input"]
    planes = instance_head_ops.instance_head_upsample(
        di["x"], di["kernel"], _instance_encodings(di, cfg))
    c_head = planes.shape[1]
    center_planes = planes[:, 0]
    off_y_planes, off_x_planes = planes[:, 1], planes[:, 2]

    apply_fg = cfg.instance_center_heatmap_apply_foreground_mask
    centers_kwargs = dict(
        threshold=cfg.instance_center_heatmap_threshold,
        nms_kernel_size=cfg.instance_center_heatmap_nms_kernel_size,
        top_k=cfg.instance_center_heatmap_top_k,
    )
    group_kwargs = dict(
        normalized_offset=cfg.instance_normalized_offset,
        offset_distance_threshold=cfg.instance_offset_distance_threshold,
    )
    centers = find_instance_centers_planes(
        center_planes, foreground_planes=fg_planes if apply_fg else None,
        **centers_kwargs)
    inst_flat = group_pixels_to_instances_planes(
        centers["yx"], centers["valid"], off_y_planes, off_x_planes,
        fg_flat, (h, w), **group_kwargs)

    if gt_foreground is not None:
        gt_planes = deinterleave_plane(gt_foreground.bool())
        centers_gt = find_instance_centers_planes(
            center_planes, foreground_planes=gt_planes if apply_fg else None,
            **centers_kwargs)
        inst_gt_flat = group_pixels_to_instances_planes(
            centers_gt["yx"], centers_gt["valid"], off_y_planes,
            off_x_planes, gt_planes.reshape(n, p_total), (h, w),
            **group_kwargs)
        to_interleave["instance_segmentation_gt_foreground"] = (
            inst_gt_flat.reshape(n, 4, h2, w2))

    to_interleave["instance_segmentation"] = inst_flat.reshape(n, 4, h2, w2)
    results["instance_centers_yx"] = centers["yx"]
    results["instance_centers_score"] = centers["scores"]
    results["instance_centers_valid"] = centers["valid"]
    to_interleave["instance_foreground"] = fg_planes
    results["instance_head_planes"] = planes

    ori_flat = None
    if c_head >= 5:
        ori_flat = torch.stack([planes[:, 3].reshape(n, p_total),
                                planes[:, 4].reshape(n, p_total)], dim=-1)
        results["instance_orientation_planes"] = planes[:, 3:5]

    pan = None
    if cfg.enable_panoptic:
        pan = panoptic_merge_flat(
            sem_full_planes.reshape(n, p_total), score4.reshape(n, p_total),
            inst_flat, centers["scores"], centers["valid"], is_thing,
            n_classes=n_classes_full, orientation_vectors=ori_flat)
        to_interleave["panoptic_segmentation_deeplab"] = pan[
            "panoptic"].reshape(n, 4, h2, w2)
        to_interleave["panoptic_segmentation_deeplab_panoptic_score"] = pan[
            "panoptic_score"].reshape(n, 4, h2, w2)
        to_interleave["panoptic_segmentation_deeplab_semantic_idx"] = pan[
            "pixel_instance_semantic"].reshape(n, 4, h2, w2)
        for key in ("semantic_idx", "area", "score", "valid"):
            results[f"panoptic_instance_meta_{key}"] = pan[
                f"instance_meta_{key}"]

    if ori_flat is not None:
        if pan is not None and "instance_orientations" in pan:
            results["orientations_instance"] = pan["instance_orientations"]
        else:
            # the aggregation only reshapes (N, H, W[, 2]) to (N, P[, 2]),
            # so flat (N, P, 1[, 2]) tensors are exact
            results["orientations_instance"] = aggregate_instance_orientations(
                ori_flat[:, :, None, :], inst_flat[:, :, None],
                top_k=cfg.instance_center_heatmap_top_k,
            )["instance_orientations"]
        if (use_orientations is not None
                and "panoptic_instance_meta_semantic_idx" in results):
            inst_sem = results["panoptic_instance_meta_semantic_idx"]
            results["orientations_panoptic_instance_valid"] = (
                use_orientations[inst_sem.long()]
                & results["panoptic_instance_meta_valid"])

    if "normal" in outputs:
        results["normal"] = outputs["normal"]["normal"]
    if "scene" in outputs:
        scene = postprocess_scene(outputs["scene"]["logits"])
        results["scene_class_idx"] = scene["class_idx"]
        results["scene_class_score"] = scene["class_score"]

    results.update(interleave_ops.interleave_planes(to_interleave))
    if pan is not None:
        results["panoptic_foreground_mask"] = results["instance_foreground"]
    return results
