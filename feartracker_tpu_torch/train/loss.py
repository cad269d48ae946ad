"""FEAR training loss: balanced BCE classification + (1 − IoU) regression,
the counterpart of ``feartracker_tpu/train/loss.py``, line for line. The
positive and negative means use static masks, not ``nonzero``, so that the
step's shapes never depend on the data.

Maps are channel-last: pred/target regression (B, H, W, 4) LTRB,
classification (B, H, W, 1), regression weights (B, H, W).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from feartracker_tpu_torch.utils.constants import (
    TARGET_CLASSIFICATION_KEY,
    TARGET_REGRESSION_LABEL_KEY,
    TARGET_REGRESSION_WEIGHT_KEY,
)


def calc_iou(target: torch.Tensor, pred: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """IoU between LTRB offset fields."""
    target_area = (target[..., 0] + target[..., 2]) * (target[..., 1] + target[..., 3])
    pred_area = (pred[..., 0] + pred[..., 2]) * (pred[..., 1] + pred[..., 3])
    w_i = torch.minimum(pred[..., 0], target[..., 0]) + torch.minimum(pred[..., 2], target[..., 2])
    h_i = torch.minimum(pred[..., 3], target[..., 3]) + torch.minimum(pred[..., 1], target[..., 1])
    inter = w_i * h_i
    union = target_area + pred_area - inter
    return (inter + smooth) / (union + smooth)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = torch.sum(mask)
    return torch.where(denom > 0, torch.sum(x * mask) / torch.clamp(denom, min=1.0), 0.0)


def regression_loss(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """mean(1 − IoU) over the cells of positive regression weight."""
    losses = 1.0 - calc_iou(target, pred)
    return _masked_mean(losses, (weight > 0).to(losses.dtype))


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """0.5·mean(BCE | pos) + 0.5·mean(BCE | neg)."""
    bce = _bce_with_logits(logits, labels)
    pos = (labels == 1).to(bce.dtype)
    neg = (labels == 0).to(bce.dtype)
    return 0.5 * _masked_mean(bce, pos) + 0.5 * _masked_mean(bce, neg)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def fear_loss(
    outputs: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    coeffs: Optional[Dict[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """Both parts, each times its coefficient (1.0 each by default). The
    head's outputs are cast to float32 first, as in JAX (a float64 model
    keeps float64)."""
    if coeffs is None:
        coeffs = {TARGET_CLASSIFICATION_KEY: 1.0, TARGET_REGRESSION_LABEL_KEY: 1.0}
    reg = regression_loss(
        _f32(outputs[TARGET_REGRESSION_LABEL_KEY]),
        _f32(targets[TARGET_REGRESSION_LABEL_KEY]),
        _f32(targets[TARGET_REGRESSION_WEIGHT_KEY]),
    )
    cls = classification_loss(
        _f32(outputs[TARGET_CLASSIFICATION_KEY]),
        _f32(targets[TARGET_CLASSIFICATION_KEY]),
    )
    return {
        TARGET_CLASSIFICATION_KEY: cls * coeffs[TARGET_CLASSIFICATION_KEY],
        TARGET_REGRESSION_LABEL_KEY: reg * coeffs[TARGET_REGRESSION_LABEL_KEY],
    }
