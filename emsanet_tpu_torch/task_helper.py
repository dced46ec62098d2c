"""Per-task validation helpers: metric accumulation over postprocessed
predictions, and each epoch's logs and artifacts.

A copy of `emsanet_tpu/task_helper.py` (the semantic, scene, instance,
panoptic, orientation and normal helpers and `get_task_helpers`). The protocol is
`initialize()`, `validation_step(batch, predictions)`,
`validation_epoch_end() -> (artifacts, logs)`, with `batch` the collated
numpy batch and `predictions` numpy arrays of the eval step's outputs
(`PREDICTION_KEYS` are the ones the helpers read). They run on the host.
Nearest resizes of id maps to the ground truth's resolution run in the
host library (`native.resize_nearest_i32`), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from emsanet_tpu_torch import native
from emsanet_tpu_torch.metrics import (
    LABEL_DIVISOR,
    BalancedAccuracy,
    MeanAbsoluteAngularError,
    MeanIoU,
    PanopticQuality,
    deeplab_merge_numpy,
)


# the prediction keys the helpers read
PREDICTION_KEYS = (
    "semantic_segmentation_idx", "scene_class_idx",
    "instance_segmentation", "instance_segmentation_gt_foreground",
    "panoptic_segmentation_deeplab", "orientations_instance",
    "instance_orientation", "instance_orientation_planes", "normal",
)


def interleave_planes_np(planes) -> np.ndarray:
    """Parity planes (..., 4, H/2, W/2) -> full-res (..., H, W), plane
    p = 2 * row parity + column parity (`postprocessing`'s layout)."""
    planes = np.asarray(planes)
    *lead, _, h2, w2 = planes.shape
    a = planes.reshape(*lead, 2, 2, h2, w2)
    a = np.moveaxis(a, (-4, -3), (-3, -1))
    return a.reshape(*lead, 2 * h2, 2 * w2)


def _valid_slice(batch, arr):
    """Drop padded samples from the last validation batch."""
    mask = batch.get("_valid_mask")
    if mask is None:
        return arr
    return arr[np.asarray(mask)]


def _resize_ids_nearest(ids: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Nearest resize of an id map, in the host library."""
    if ids.shape == (oh, ow):
        return ids
    return native.resize_nearest_i32(ids.astype(np.int32), oh,
                                     ow).astype(ids.dtype)


def _pred_at_gt_resolution(batch, pred_ids: np.ndarray, gt_key: str):
    """(pred_fullres, gt_fullres) pairs per sample.

    Reference protocol (SURVEY.md M6/M9 FullResCloner): predictions are
    resized back to the native resolution recorded by the preprocessing
    trace and scored against the '<key>_fullres' targets when present.
    """
    gt_full = batch.get(f"{gt_key}_fullres")
    if gt_full is None:
        return pred_ids, np.asarray(batch[gt_key])
    prepad = batch.get("_prepad_hw")  # bucketed full-res validation
    if prepad is not None:
        prepad = np.asarray(prepad)
        pred_ids = [
            p[: int(prepad[i, 0]), : int(prepad[i, 1])]
            for i, p in enumerate(pred_ids)
        ]
    gt_full = np.asarray(gt_full)
    oh, ow = gt_full.shape[-2:]
    pred_full = np.stack(
        [_resize_ids_nearest(p, oh, ow) for p in pred_ids]
    )
    return pred_full, gt_full


class TaskHelperBase:
    def initialize(self):
        pass

    def validation_step(self, batch: Dict, predictions: Dict):
        raise NotImplementedError

    def validation_epoch_end(self) -> Tuple[Dict[str, Any], Dict[str, float]]:
        raise NotImplementedError


class SemanticTaskHelper(TaskHelperBase):
    def __init__(self, n_classes_with_void: int):
        self.n_classes = n_classes_with_void

    def initialize(self):
        self.miou = MeanIoU(self.n_classes)

    def validation_step(self, batch, predictions):
        pred = np.asarray(predictions["semantic_segmentation_idx"]) + 1
        pred, target = _pred_at_gt_resolution(batch, pred, "semantic")
        self.miou.update(_valid_slice(batch, pred),
                         _valid_slice(batch, target))

    def validation_epoch_end(self):
        artifacts = {"semantic_confusion": self.miou.confusion.copy()}
        return artifacts, {"semantic_miou": self.miou.compute()}


class SceneTaskHelper(TaskHelperBase):
    def __init__(self, n_classes_with_void: int):
        self.n_classes = n_classes_with_void

    def initialize(self):
        self.bacc = BalancedAccuracy(self.n_classes)

    def validation_step(self, batch, predictions):
        pred = np.asarray(predictions["scene_class_idx"]) + 1
        target = np.asarray(batch["scene"])
        self.bacc.update(_valid_slice(batch, pred),
                         _valid_slice(batch, target))

    def validation_epoch_end(self):
        return {}, {"scene_bacc": self.bacc.compute()}


class InstanceTaskHelper(TaskHelperBase):
    """Class-agnostic instance quality via PQ with GT foreground.

    Reference metric `instance_all_with_gt_deeplab_pq` (README.md:268-336):
    predicted instances merged with *GT* semantics/foreground, scored as a
    2-class (thing-vs-stuff collapsed) panoptic problem.
    """

    def __init__(self, is_thing: Sequence[bool]):
        self.is_thing = np.asarray(is_thing, bool)

    def initialize(self):
        # single thing category: class-agnostic
        self.pq = PanopticQuality(2, (False, True))

    def validation_step(self, batch, predictions):
        # prefer the GT-foreground variant (reference protocol for the
        # instance-only metric, SURVEY.md §3.4)
        inst_pred = np.asarray(
            predictions.get(
                "instance_segmentation_gt_foreground",
                predictions["instance_segmentation"],
            )
        )
        inst_gt = np.asarray(batch["instance"])
        sem_gt = np.asarray(batch["semantic"])
        thing_gt = self.is_thing[sem_gt]
        for b in range(inst_pred.shape[0]):
            mask = batch.get("_valid_mask")
            if mask is not None and not mask[b]:
                continue
            # encode as 1*divisor + id on GT-thing pixels, void elsewhere
            pred_pan = np.where(
                thing_gt[b] & (inst_pred[b] > 0),
                LABEL_DIVISOR + inst_pred[b], 0,
            )
            gt_pan = np.where(
                thing_gt[b] & (inst_gt[b] > 0), LABEL_DIVISOR + inst_gt[b], 0
            )
            self.pq.update(pred_pan, gt_pan)

    def validation_epoch_end(self):
        res = self.pq.compute()
        return {}, {
            "instance_all_with_gt_deeplab_pq": res["all_pq"],
            "instance_all_with_gt_deeplab_rq": res["all_rq"],
            "instance_all_with_gt_deeplab_sq": res["all_sq"],
        }


class PanopticTaskHelper(TaskHelperBase):
    """Full panoptic evaluation: PQ vs GT merge + post-merge semantic mIoU
    + panoptic orientation MAAE."""

    def __init__(self, is_thing: Sequence[bool], n_classes_with_void: int,
                 has_orientation: bool = False,
                 use_orientations: Optional[Sequence[bool]] = None):
        self.is_thing = np.asarray(is_thing, bool)
        self.n_classes = n_classes_with_void
        self.has_orientation = has_orientation
        self.use_orientations = (
            np.asarray(use_orientations, bool)
            if use_orientations is not None
            else self.is_thing
        )

    def initialize(self):
        self.pq = PanopticQuality(self.n_classes, self.is_thing.tolist())
        self.miou = MeanIoU(self.n_classes)
        self.mae = MeanAbsoluteAngularError()

    def validation_step(self, batch, predictions):
        pred_pan = np.asarray(predictions["panoptic_segmentation_deeplab"])
        valid = np.asarray(
            batch.get("_valid_mask", np.ones(pred_pan.shape[0], bool))
        )
        if "panoptic" in batch or "panoptic_fullres" in batch:
            pred_pan, gt_pan = _pred_at_gt_resolution(
                batch, pred_pan, "panoptic"
            )
        else:
            gt_pan = deeplab_merge_numpy(
                np.asarray(batch["semantic"]), np.asarray(batch["instance"]),
                self.is_thing,
            )
        pq_matches = self.pq.update(pred_pan[valid], gt_pan[valid])
        # post-merge semantic mIoU (README 'mIoU after panoptic merge')
        sem_after = (pred_pan // LABEL_DIVISOR).astype(np.int32)
        sem_gt = np.asarray(
            batch.get("semantic_fullres", batch["semantic"])
        )
        self.miou.update(sem_after[valid], sem_gt[valid])

        if self.has_orientation and "orientations_instance" in predictions:
            self._update_orientation(
                batch, predictions, valid, pq_matches
            )

    def _update_orientation(self, batch, predictions, valid, pq_matches):
        """MAAE aggregated via the panoptic instance meta.

        Reference protocol ('panoptic_mae_deeplab_deg', README.md:268-336):
        predicted panoptic instances are matched to GT panoptic segments
        by the panoptic-quality rule (same class, IoU > 0.5); for every
        matched pair whose class uses orientations and whose GT instance
        carries an annotated orientation, the angular error between the
        per-instance predicted orientation and the GT orientation counts.
        Unmatched predictions/GT contribute nothing (they are already
        penalized through PQ).
        """
        pred_angles = np.asarray(predictions["orientations_instance"])
        gt_orients = batch.get("orientations_present") or batch.get(
            "orientations"
        )
        if gt_orients is None:
            return
        div = LABEL_DIVISOR
        # pq_matches holds the matches from self.pq.update over the
        # valid-masked subset, in subset order (no second matching pass)
        valid_indices = np.flatnonzero(valid)
        for subset_i, b in enumerate(valid_indices):
            ori = gt_orients[b] if isinstance(gt_orients, list) else gt_orients
            if not ori:
                continue
            for tid, pid, _ in pq_matches[subset_i]:
                cls = tid // div
                gt_inst = tid % div
                pred_inst = pid % div
                if (
                    cls >= len(self.use_orientations)
                    or not self.use_orientations[cls]
                    or pred_inst == 0
                    or int(gt_inst) not in ori
                    or pred_inst - 1 >= pred_angles.shape[1]
                ):
                    continue
                self.mae.update(
                    np.asarray([pred_angles[b, pred_inst - 1]]),
                    np.asarray([ori[int(gt_inst)]]),
                )

    def validation_epoch_end(self):
        res = self.pq.compute()
        logs = {
            "panoptic_all_with_gt_deeplab_pq": res["all_pq"],
            "panoptic_all_with_gt_deeplab_rq": res["all_rq"],
            "panoptic_all_with_gt_deeplab_sq": res["all_sq"],
            "panoptic_things_with_gt_deeplab_pq": res["things_pq"],
            "panoptic_stuff_with_gt_deeplab_pq": res["stuff_pq"],
            "panoptic_deeplab_semantic_miou": self.miou.compute(),
        }
        if self.has_orientation:
            logs["panoptic_mae_deeplab_deg"] = self.mae.compute()
        return {}, logs


class OrientationTaskHelper(TaskHelperBase):
    """MAAE over GT instances (valid_orientation_mae_gt_deg)."""

    def __init__(self):
        pass

    def initialize(self):
        self.mae = MeanAbsoluteAngularError()

    def validation_step(self, batch, predictions):
        if "instance_orientation" in predictions:
            dense = np.asarray(predictions["instance_orientation"])
        elif "instance_orientation_planes" in predictions:
            # parity-plane layout (postprocessing planes pipeline):
            # (N, 2, 4, H/2, W/2) -> dense (N, H, W, 2) on the host
            planes = np.asarray(predictions["instance_orientation_planes"])
            dense = np.moveaxis(interleave_planes_np(planes), 1, -1)
        else:
            return
        inst_gt = np.asarray(batch["instance"])
        gt_orients = batch.get("orientations_present") or batch.get(
            "orientations"
        )
        valid = np.asarray(
            batch.get("_valid_mask", np.ones(inst_gt.shape[0], bool))
        )
        if gt_orients is None:
            return
        for b in range(inst_gt.shape[0]):
            if not valid[b]:
                continue
            ori = gt_orients[b] if isinstance(gt_orients, list) else gt_orients
            for iid, theta in (ori or {}).items():
                mask = inst_gt[b] == iid
                if not mask.any():
                    continue
                vec = dense[b][mask].mean(0)
                pred_angle = np.arctan2(vec[0], vec[1]) % (2 * np.pi)
                self.mae.update(np.asarray([pred_angle]), np.asarray([theta]))

    def validation_epoch_end(self):
        return {}, {"orientation_mae_gt_deg": self.mae.compute()}


class NormalTaskHelper(TaskHelperBase):
    """Mean angular error in degrees between predicted and ground-truth
    normals over the pixels with a valid (norm > 0.5) ground truth
    (`normal_mae_deg`; `emsanet_tpu/task_helper.py:325-344`)."""

    def initialize(self):
        self._err_sum = 0.0
        self._count = 0

    def validation_step(self, batch, predictions):
        pred = np.asarray(predictions["normal"])
        target = np.asarray(batch["normal"])
        valid = np.asarray(
            batch.get("_valid_mask", np.ones(pred.shape[0], bool)))
        pred, target = pred[valid], target[valid]
        mask = np.linalg.norm(target, axis=-1) > 0.5
        cos = np.clip(np.sum(pred * target, -1), -1, 1)[mask]
        self._err_sum += float(np.degrees(np.arccos(cos)).sum())
        self._count += int(mask.sum())

    def validation_epoch_end(self):
        mae = self._err_sum / max(self._count, 1)
        return {}, {"normal_mae_deg": mae}


def get_task_helpers(cfg, dataset_config) -> List[TaskHelperBase]:
    """One helper per task, in the reference's order. cfg: EMSANetConfig;
    dataset_config: `datasets.metadata.DatasetConfig`."""
    n_sem = len(dataset_config.semantic_class_names)
    n_scene = len(dataset_config.scene_class_names)
    is_thing = dataset_config.classes_is_thing
    helpers: List[TaskHelperBase] = []
    tasks = cfg.model.tasks
    if "semantic" in tasks:
        helpers.append(SemanticTaskHelper(n_sem))
    if "instance" in tasks:
        helpers.append(InstanceTaskHelper(is_thing))
    if cfg.model.enable_panoptic:
        helpers.append(
            PanopticTaskHelper(
                is_thing, n_sem,
                has_orientation="orientation" in tasks,
                use_orientations=dataset_config.classes_use_orientations,
            )
        )
    if "orientation" in tasks:
        helpers.append(OrientationTaskHelper())
    if "scene" in tasks:
        helpers.append(SceneTaskHelper(n_scene))
    if "normal" in tasks:
        helpers.append(NormalTaskHelper())
    return helpers
