"""Task losses and their fixed weighting (counterpart:
`emsanet_tpu/losses.py`).

- semantic / scene: weighted cross entropy with label smoothing and the
  weighted-pixel-sum reduction (sum of per-pixel weighted CE over the
  sum of the weights), void (label 0) ignored;
- instance center: MSE (or BCE) over the center mask;
- instance offset: L1 over the ground-truth foreground;
- orientation: the biternion von Mises loss over the orientation
  foreground;
- normal: L1 over the 3 channels, averaged over the normal mask (the
  pixels with a valid ground-truth normal) or over every pixel.

Every loss reduces to an f32 scalar (f64 for f64 inputs).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in f32 (f64 stays f64), the dtype every loss reduces in."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cross_entropy_semantic_sums(
    logits: torch.Tensor, target: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of w * nll, sum of w) of `cross_entropy_semantic`.

    logits (..., C) over the void-free classes, in their own dtype (the
    difference to the max is taken in it, as the JAX package does);
    target (...) int in the full label space (0 = void).
    """
    n_classes = logits.shape[-1]
    valid = target > 0
    tgt = (target.long() - 1).clamp(0, n_classes - 1)
    # the max only shifts the exponent; its gradient cancels analytically
    m = logits.detach().amax(-1, keepdim=True)
    d = _acc(logits - m)
    logz = _acc(m[..., 0]) + torch.log(torch.exp(d).sum(-1))
    nll = logz - _acc(logits.gather(-1, tgt[..., None])[..., 0])
    if label_smoothing > 0.0:
        smooth = logz - _acc(logits).mean(-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if class_weights is not None:
        w = class_weights.to(nll.dtype)[tgt]
    else:
        w = torch.ones_like(nll)
    w = torch.where(valid, w, torch.zeros_like(w))
    return (w * nll).sum(), w.sum()


def cross_entropy_semantic(logits, target, class_weights=None,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """Weighted CE with weighted-pixel-sum reduction; void (0) ignored."""
    s, w = cross_entropy_semantic_sums(logits, target, class_weights,
                                       label_smoothing)
    return s / torch.clamp_min(w, 1e-12)


def cross_entropy_scene(logits, target, class_weights=None,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """Scene classification CE; target in the full label space."""
    return cross_entropy_semantic(logits, target, class_weights,
                                  label_smoothing)


def _masked_mean(values: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of values (..., K) over the masked pixels and the K channels."""
    if mask is None:
        return values.mean()
    m = mask.to(values.dtype)
    if m.ndim == values.ndim - 1:
        m = m[..., None]
    return (values * m).sum() / torch.clamp_min(m.sum() * values.shape[-1],
                                                1e-12)


def mse_center(pred, target, mask=None) -> torch.Tensor:
    """Center-heatmap MSE averaged over the mask region."""
    return _masked_mean((_acc(pred) - _acc(target)) ** 2, mask)


def bce_center(pred, target, mask=None, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy of the sigmoid-encoded center heatmap."""
    p = _acc(pred).clamp(eps, 1.0 - eps)
    t = _acc(target)
    return _masked_mean(-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)),
                        mask)


def l1_offset(pred, target, foreground) -> torch.Tensor:
    """Offset L1 averaged over ground-truth foreground pixels."""
    diff = (_acc(pred) - _acc(target)).abs()
    m = foreground.to(diff.dtype)[..., None]
    return (diff * m).sum() / torch.clamp_min(m.sum() * diff.shape[-1], 1e-12)


def von_mises_orientation(pred_biternion, target_biternion, foreground,
                          kappa: float = 1.0) -> torch.Tensor:
    """1 - exp(kappa (cos(delta) - 1)) over the foreground; the
    prediction is L2-normalized here."""
    pred = _acc(pred_biternion)
    pred = pred / torch.clamp_min(torch.linalg.norm(pred, dim=-1,
                                                    keepdim=True), 1e-7)
    cos_delta = (pred * _acc(target_biternion)).sum(-1)
    loss = 1.0 - torch.exp(kappa * (cos_delta - 1.0))
    m = foreground.to(loss.dtype)
    return (loss * m).sum() / torch.clamp_min(m.sum(), 1e-12)


def l1_normal(pred, target, mask=None) -> torch.Tensor:
    """|pred - target| averaged over the masked pixels and the 3 channels,
    or over everything without a mask (`emsanet_tpu/losses.py:155-164`)."""
    return _masked_mean((_acc(pred) - _acc(target)).abs(), mask)


def get_total_loss_key(task: str) -> str:
    return f"{task}_total_loss"


class FixedLossWeighting:
    """total = sum_k w_k * loss_k over the losses present."""

    def __init__(self, weights: Dict[str, float]):
        self.weights = dict(weights)

    def reduce_losses(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for key, weight in self.weights.items():
            if key in losses:
                total = total + weight * losses[key]
        return total


def build_loss_weighting(tasks, tasks_weighting,
                         instance_weighting=(2.0, 1.0)) -> FixedLossWeighting:
    """`emsanet_tpu/losses.py::build_loss_weighting`: orientation is a
    sub-loss of the instance decoder; the instance weight multiplies the
    (center, offset) weighting."""
    tasks_weights = dict(zip(tasks, tasks_weighting))
    loss_weights: Dict[str, float] = {}
    if "orientation" in tasks_weights:
        loss_weights[get_total_loss_key("instance_orientation")] = (
            tasks_weights.pop("orientation"))
    if "instance" in tasks_weights:
        w_inst = tasks_weights.pop("instance")
        w_center, w_offset = instance_weighting
        loss_weights[get_total_loss_key("instance_center")] = w_inst * w_center
        loss_weights[get_total_loss_key("instance_offset")] = w_inst * w_offset
    loss_weights.update(
        {get_total_loss_key(t): v for t, v in tasks_weights.items()})
    return FixedLossWeighting(loss_weights)
