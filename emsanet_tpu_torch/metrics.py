"""Validation metrics, in numpy on the host: mIoU, balanced accuracy,
mean absolute angular error and panoptic quality.

A copy of `emsanet_tpu/metrics.py` (`MeanIoU`, `BalancedAccuracy`,
`MeanAbsoluteAngularError`, `PanopticQuality`, `deeplab_merge_numpy`),
unchanged in what it computes. PQ follows the COCO panopticapi rules:
segments match at IoU > 0.5 within a class, void ground truth leaves the
union, and a predicted segment that lies more than half on void is no
false positive. Segment ids are `semantic * 2**16 + instance`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

LABEL_DIVISOR = 2**16
VOID_LABEL = 0


class MeanIoU:
    """Confusion-matrix mIoU over the full label space; class 0 = void."""

    def __init__(self, n_classes: int, ignore_void: bool = True):
        self.n_classes = n_classes
        self.ignore_void = ignore_void
        self.reset()

    def reset(self):
        self.confusion = np.zeros(
            (self.n_classes, self.n_classes), dtype=np.int64
        )

    def update(self, pred: np.ndarray, target: np.ndarray):
        """pred/target: int arrays in the full label space (0 = void)."""
        pred = np.asarray(pred).reshape(-1)
        target = np.asarray(target).reshape(-1)
        if self.ignore_void:
            keep = target > 0
            pred, target = pred[keep], target[keep]
        idx = target * self.n_classes + pred
        binc = np.bincount(idx, minlength=self.n_classes**2)
        self.confusion += binc.reshape(self.n_classes, self.n_classes)

    def compute(self) -> float:
        conf = self.confusion.astype(np.float64)
        if self.ignore_void:
            conf = conf[1:, 1:]
        tp = np.diag(conf)
        union = conf.sum(0) + conf.sum(1) - tp
        present = union > 0
        iou = np.where(present, tp / np.maximum(union, 1), 0.0)
        return float(iou[present].mean()) if present.any() else 0.0

    def per_class_iou(self) -> np.ndarray:
        conf = self.confusion.astype(np.float64)
        if self.ignore_void:
            conf = conf[1:, 1:]
        tp = np.diag(conf)
        union = conf.sum(0) + conf.sum(1) - tp
        return tp / np.maximum(union, 1)


class BalancedAccuracy:
    """Mean per-class recall (scene classification bAcc, SURVEY.md M11)."""

    def __init__(self, n_classes: int, ignore_void: bool = True):
        self.n_classes = n_classes
        self.ignore_void = ignore_void
        self.reset()

    def reset(self):
        self.correct = np.zeros(self.n_classes, np.int64)
        self.total = np.zeros(self.n_classes, np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        pred = np.asarray(pred).reshape(-1)
        target = np.asarray(target).reshape(-1)
        if self.ignore_void:
            keep = target > 0
            pred, target = pred[keep], target[keep]
        for c in np.unique(target):
            mask = target == c
            self.total[c] += mask.sum()
            self.correct[c] += (pred[mask] == c).sum()

    def compute(self) -> float:
        present = self.total > 0
        if not present.any():
            return 0.0
        recall = self.correct[present] / self.total[present]
        return float(recall.mean())


class MeanAbsoluteAngularError:
    """MAAE in degrees over matched instances (SURVEY.md M11)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0

    def update(self, pred_rad: np.ndarray, target_rad: np.ndarray):
        pred = np.asarray(pred_rad, np.float64)
        target = np.asarray(target_rad, np.float64)
        diff = np.abs(np.arctan2(np.sin(pred - target), np.cos(pred - target)))
        self._sum += float(np.degrees(diff).sum())
        self._count += diff.size

    def compute(self) -> float:
        return self._sum / max(self._count, 1)


class PanopticQuality:
    """COCO panopticapi-compatible PQ/SQ/RQ (SURVEY.md M12).

    Segments are encoded as `semantic * label_divisor + instance` (things)
    or `semantic * label_divisor` (stuff); `void_label` (0) is ignored.
    Matching: IoU > 0.5 between same-class segments; crowd-free protocol.
    panopticapi void handling: void GT area is subtracted from the union,
    and predicted segments overlapping void by > 50% of their area are not
    counted as false positives.
    """

    def __init__(
        self,
        num_categories: int,
        is_thing: Sequence[bool],
        ignored_label: int = VOID_LABEL,
        label_divisor: int = LABEL_DIVISOR,
    ):
        self.num_categories = num_categories
        self.is_thing = np.asarray(is_thing, bool)
        self.ignored_label = ignored_label
        self.label_divisor = label_divisor
        self.reset()

    def reset(self):
        n = self.num_categories
        self.iou_sum = np.zeros(n, np.float64)
        self.tp = np.zeros(n, np.int64)
        self.fp = np.zeros(n, np.int64)
        self.fn = np.zeros(n, np.int64)

    def update(
        self, pred: np.ndarray, target: np.ndarray
    ) -> List[List[Tuple[int, int, float]]]:
        """pred/target: (H, W) or (N, H, W) int panoptic id maps.

        Returns the per-image matched segments ([(target_id, pred_id,
        iou)], same as `match_segments`) so callers that also need the
        matching (orientation MAAE meta aggregation) don't pay a second
        full matching pass per image.
        """
        pred = np.asarray(pred)
        target = np.asarray(target)
        if pred.ndim == 3:
            return [self._update_single(p, t) for p, t in zip(pred, target)]
        return [self._update_single(pred, target)]

    def match_segments(
        self, pred: np.ndarray, target: np.ndarray
    ) -> List[Tuple[int, int, float]]:
        """panopticapi-style segment matching for one image.

        Returns [(target_id, pred_id, iou)] for all same-class pairs with
        IoU > 0.5 (the panoptic instance meta used e.g. for the
        orientation MAAE aggregation, reference key
        'panoptic_mae_deeplab_deg').
        """
        _, _, _, _, _, _, matches = self._match(
            pred.astype(np.int64).reshape(-1),
            target.astype(np.int64).reshape(-1),
        )
        return matches

    def _match(self, pred: np.ndarray, target: np.ndarray):
        div = self.label_divisor
        void_t = (target // div) == self.ignored_label
        void_area_total = int(void_t.sum())

        # per-segment areas
        t_ids, t_areas = np.unique(target, return_counts=True)
        p_ids, p_areas = np.unique(pred, return_counts=True)
        t_area = dict(zip(t_ids.tolist(), t_areas.tolist()))
        p_area = dict(zip(p_ids.tolist(), p_areas.tolist()))

        # intersections via combined key
        combined = target * (2**25) + pred  # pred ids < 2**25 (C*2^16 + K)
        c_ids, c_areas = np.unique(combined, return_counts=True)
        inter: Dict[Tuple[int, int], int] = {}
        for cid, area in zip(c_ids.tolist(), c_areas.tolist()):
            tid, pid = divmod(cid, 2**25)
            inter[(tid, pid)] = area

        # intersection of each pred segment with GT void
        pred_void_inter: Dict[int, int] = {}
        if void_area_total:
            pv = pred[void_t]
            pv_ids, pv_areas = np.unique(pv, return_counts=True)
            pred_void_inter = dict(zip(pv_ids.tolist(), pv_areas.tolist()))

        matches: List[Tuple[int, int, float]] = []
        for (tid, pid), int_area in inter.items():
            t_cls = tid // div
            p_cls = pid // div
            if t_cls == self.ignored_label or p_cls == self.ignored_label:
                continue
            if t_cls != p_cls:
                continue
            union = (
                t_area[tid]
                + p_area[pid]
                - int_area
                - inter.get((self.ignored_label * div, pid), 0)
            )
            # subtract pred overlap with *any* void GT segment class-0 only:
            # panopticapi subtracts pred∩void_gt from the union
            iou = int_area / union if union > 0 else 0.0
            if iou > 0.5:
                matches.append((tid, pid, iou))
        return (t_ids, t_area, p_ids, p_area, inter, pred_void_inter,
                matches)

    def _update_single(self, pred: np.ndarray, target: np.ndarray):
        div = self.label_divisor
        pred = pred.astype(np.int64).reshape(-1)
        target = target.astype(np.int64).reshape(-1)

        (t_ids, t_area, p_ids, p_area, inter, pred_void_inter,
         matches) = self._match(pred, target)

        matched_t, matched_p = set(), set()
        for tid, pid, iou in matches:
            t_cls = tid // div
            self.tp[t_cls] += 1
            self.iou_sum[t_cls] += iou
            matched_t.add(tid)
            matched_p.add(pid)

        for tid in t_ids.tolist():
            t_cls = tid // div
            if t_cls == self.ignored_label or tid in matched_t:
                continue
            self.fn[t_cls] += 1

        for pid in p_ids.tolist():
            p_cls = pid // div
            if p_cls == self.ignored_label or pid in matched_p:
                continue
            # >50% void overlap -> not a false positive (panopticapi rule)
            if pred_void_inter.get(pid, 0) > 0.5 * p_area[pid]:
                continue
            self.fp[p_cls] += 1
        return matches

    def compute(self) -> Dict[str, float]:
        results = {}
        for name, mask in (
            ("all", np.ones(self.num_categories, bool)),
            ("things", self.is_thing),
            ("stuff", ~self.is_thing),
        ):
            mask = mask.copy()
            mask[self.ignored_label] = False
            present = mask & ((self.tp + self.fp + self.fn) > 0)
            if not present.any():
                results[f"{name}_pq"] = 0.0
                results[f"{name}_sq"] = 0.0
                results[f"{name}_rq"] = 0.0
                results[f"{name}_n"] = 0
                continue
            sq = np.where(
                self.tp > 0, self.iou_sum / np.maximum(self.tp, 1), 0.0
            )
            rq_den = self.tp + 0.5 * self.fp + 0.5 * self.fn
            rq = np.where(rq_den > 0, self.tp / np.maximum(rq_den, 1e-12), 0.0)
            pq = sq * rq
            results[f"{name}_pq"] = float(pq[present].mean())
            results[f"{name}_sq"] = float(sq[present].mean())
            results[f"{name}_rq"] = float(rq[present].mean())
            results[f"{name}_n"] = int(present.sum())
        return results


def deeplab_merge_numpy(
    semantic: np.ndarray,
    instance: np.ndarray,
    is_thing: Sequence[bool],
    label_divisor: int = LABEL_DIVISOR,
    void_label: int = VOID_LABEL,
) -> np.ndarray:
    """Host-side panoptic merge for GT target generation (SURVEY.md M13).

    Same semantics as `postprocessing.panoptic_merge` but for GT maps where
    instance ids are already consistent (no majority vote needed: GT
    instances carry their semantic class directly).
    """
    is_thing = np.asarray(is_thing, bool)
    thing = is_thing[semantic]
    out = semantic.astype(np.int64) * label_divisor
    has_inst = instance > 0
    out = np.where(
        thing & has_inst,
        semantic.astype(np.int64) * label_divisor + instance,
        out,
    )
    out[thing & ~has_inst] = void_label
    return out
