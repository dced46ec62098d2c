"""The train step (multi-task losses, weighted total, backward,
optimizer step) and the eval step (forward in eval mode and
postprocessing) (counterpart: `emsanet_tpu/training/step.py`).

Side outputs are supervised against the `_down_{s}` target sub-batches;
each task's total is its full-resolution loss plus the sum of its side
losses. With `fused_train_head` the semantic head's final x2 stage and
the full-res CE run as one fused loss (`ops/semantic_train_head.py`).
BatchNorm running statistics are updated in place during the forward,
so the step returns only the losses; they stay on the device.

Over a data-parallel mesh (`parallel/mesh.py`) each rank runs the
forward and backward on its rows with its own BatchNorm batch statistics
(plain BatchNorm, not `SyncBatchNorm`: the JAX package's `shard_map` step
normalizes with the shard's statistics, and the pair kernels keep their
local sums); then ONE `all_reduce` per dtype averages the gradients, the
BatchNorm running statistics (every float buffer of the model) and the
losses over the ranks, the JAX package's `pmean`s
(`emsanet_tpu/training/step.py:273-277`), before `optimizer.step()`.
Not DDP: DDP's default copies rank 0's buffers instead of averaging
them, overlaps its buckets with the backward, which the one flat buffer
does not need to match the JAX step, and wraps the model, which changes
its `state_dict` keys. A parameter without a gradient keeps none on every
rank, as in the one-process step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from emsanet_tpu_torch.losses import (
    bce_center,
    build_loss_weighting,
    cross_entropy_scene,
    cross_entropy_semantic,
    get_total_loss_key,
    l1_normal,
    l1_offset,
    mse_center,
    von_mises_orientation,
)
from emsanet_tpu_torch.models.layers import dropout_generator
from emsanet_tpu_torch.ops.semantic_train_head import (
    fused_semantic_head_loss,
)
from emsanet_tpu_torch.parallel.mesh import all_mean_


def extract_device_batch(batch: Dict[str, Any],
                         device) -> Dict[str, Any]:
    """The arrays of a collated batch as tensors on `device` (lists,
    identifiers and `*_fullres` copies dropped; `_down_{s}` kept)."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_down_") and isinstance(v, dict):
            sub = extract_device_batch(v, device)
            if sub:
                out[k] = sub
        elif isinstance(v, np.ndarray) and not k.endswith("_fullres"):
            out[k] = torch.from_numpy(v).to(device)
    return out


def compute_losses(
    outputs: Dict[str, Any], batch: Dict[str, Any],
    class_weights: Optional[torch.Tensor] = None,
    semantic_side_downscales: Tuple[int, ...] = (),
    instance_side_downscales: Tuple[int, ...] = (),
    normal_side_downscales: Tuple[int, ...] = (),
    orientation_kappa: float = 1.0,
    label_smoothing: float = 0.0,
    scene_label_smoothing: Optional[float] = None,
    instance_center_loss: str = "mse",
) -> Dict[str, torch.Tensor]:
    """Per-task total losses keyed by `get_total_loss_key` names; side
    outputs are matched in order with the task's side downscales."""
    losses: Dict[str, torch.Tensor] = {}
    if scene_label_smoothing is None:
        scene_label_smoothing = label_smoothing

    def down(s):
        return batch.get(f"_down_{s}", {})

    if "semantic" in outputs and "semantic" in batch:
        sem = outputs["semantic"]
        if "decode_input" in sem:
            di = sem["decode_input"]
            total = fused_semantic_head_loss(
                di["x"], di["kernel"], batch["semantic"], class_weights,
                label_smoothing)
        else:
            total = cross_entropy_semantic(sem["logits"], batch["semantic"],
                                           class_weights, label_smoothing)
        for side, s in zip(sem.get("side_outputs", ()),
                           semantic_side_downscales):
            tgt = down(s).get("semantic")
            if tgt is not None:
                total = total + cross_entropy_semantic(
                    side, tgt, class_weights, label_smoothing)
        losses[get_total_loss_key("semantic")] = total

    if "instance" in outputs and "instance_center" in batch:
        inst = outputs["instance"]
        center_fn = bce_center if instance_center_loss == "bce" else mse_center
        center = center_fn(inst["center"], batch["instance_center"],
                           batch.get("instance_center_mask"))
        offset = l1_offset(inst["offset"], batch["instance_offset"],
                           batch["instance_foreground"])
        orient = None
        if "orientation" in inst and "orientation" in batch:
            orient = von_mises_orientation(
                inst["orientation"], batch["orientation"],
                batch["orientation_foreground"], kappa=orientation_kappa)
        for side, s in zip(inst.get("side_outputs", ()),
                           instance_side_downscales):
            sub = down(s)
            if "instance_center" not in sub:
                continue
            center = center + center_fn(side[..., 0:1],
                                        sub["instance_center"],
                                        sub.get("instance_center_mask"))
            offset = offset + l1_offset(side[..., 1:3],
                                        sub["instance_offset"],
                                        sub["instance_foreground"])
            if orient is not None and "orientation" in sub:
                orient = orient + von_mises_orientation(
                    side[..., 3:5], sub["orientation"],
                    sub["orientation_foreground"], kappa=orientation_kappa)
        losses[get_total_loss_key("instance_center")] = center
        losses[get_total_loss_key("instance_offset")] = offset
        if orient is not None:
            losses[get_total_loss_key("instance_orientation")] = orient

    if "scene" in outputs and "scene" in batch:
        losses[get_total_loss_key("scene")] = cross_entropy_scene(
            outputs["scene"]["logits"], batch["scene"],
            label_smoothing=scene_label_smoothing)

    if "normal" in outputs and "normal" in batch:
        total = l1_normal(outputs["normal"]["normal"], batch["normal"],
                          batch.get("normal_mask"))
        for side, s in zip(outputs["normal"].get("side_outputs", ()),
                           normal_side_downscales):
            sub = down(s)
            if "normal" in sub:
                total = total + l1_normal(side, sub["normal"],
                                          sub.get("normal_mask"))
        losses[get_total_loss_key("normal")] = total
    return losses


def model_inputs(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The model's inputs of a batch: its 'rgb' and 'depth', where it has
    them (the model takes the modalities it was built for)."""
    return {k: batch[k] for k in ("rgb", "depth") if k in batch}


def make_train_step(
    model: torch.nn.Module, cfg, optimizer: torch.optim.Optimizer,
    class_weights: Optional[torch.Tensor] = None, mesh=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """`train_step(batch, generator=None)`: forward in train mode (dropout
    drawn from `generator`), the weighted total loss, backward and one
    optimizer step. `batch` holds tensors on the model's device
    (`extract_device_batch`); returns the losses and 'total_loss'. With
    `mesh` (`parallel.mesh.Mesh`), `batch` is the rank's rows and the
    gradients, running statistics and losses are averaged over the ranks
    before the update (the returned losses are the means). cfg:
    EMSANetConfig."""
    m, t = cfg.model, cfg.train
    weighting = build_loss_weighting(m.tasks, t.tasks_weighting,
                                     t.instance_weighting)

    def train_step(batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with dropout_generator(generator):
            outputs = model(model_inputs(batch))
        losses = compute_losses(
            outputs, batch, class_weights,
            semantic_side_downscales=m.task_side_output_downscales(
                "semantic"),
            instance_side_downscales=m.task_side_output_downscales(
                "instance"),
            normal_side_downscales=m.task_side_output_downscales("normal"),
            orientation_kappa=t.orientation_kappa,
            label_smoothing=t.semantic_loss_label_smoothing,
            scene_label_smoothing=t.scene_loss_label_smoothing,
            instance_center_loss=t.instance_center_loss,
        )
        total = weighting.reduce_losses(losses)
        total.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        if mesh is not None:
            all_mean_(mesh, [*(p.grad for p in model.parameters()
                               if p.grad is not None),
                             *(b for b in model.buffers()
                               if b.is_floating_point()),
                             *metrics.values()])
        optimizer.step()
        return metrics

    return train_step


def make_eval_step(
    model: torch.nn.Module, cfg, is_thing: torch.Tensor,
    use_orientations: Optional[torch.Tensor] = None,
) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """`eval_step(batch)`: the forward in eval mode and the whole
    postprocessing, under `torch.inference_mode()` (counterpart:
    `emsanet_tpu/training/step.py::make_eval_step`). `batch` holds
    tensors on the model's device: 'rgb', 'depth' and, where present,
    'instance_foreground' (the ground-truth foreground, which gives the
    'instance_segmentation_gt_foreground' map). Returns the postprocessed
    predictions under the reference's keys; the model's train or eval
    mode is restored afterwards. The heads follow
    `cfg.model.head_decode_fusion`. cfg: EMSANetConfig."""
    from emsanet_tpu_torch.postprocessing import postprocess

    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                outputs = model(model_inputs(batch))
                return postprocess(
                    outputs, is_thing, cfg.model,
                    gt_foreground=batch.get("instance_foreground"),
                    use_orientations=use_orientations)
        finally:
            model.train(was_training)

    return eval_step
