"""Batched bbox algebra on tensors (float32, xywh), counterpart of
``feartracker_tpu/core/geometry_jax.py``. Rounding follows the reference:
round-half-even (``torch.round``) and truncation (``torch.trunc``)."""

from __future__ import annotations

import torch


def ensure_bbox_boundaries(bbox: torch.Tensor, img_hw) -> torch.Tensor:
    """Clip xywh into an (h, w) image with int truncation semantics."""
    h, w = img_hw
    x1 = bbox[..., 0].clamp(0, w)
    y1 = bbox[..., 1].clamp(0, h)
    x2 = (x1 + bbox[..., 2]).clamp(0, w)
    y2 = (y1 + bbox[..., 3]).clamp(0, h)
    return torch.trunc(torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1))


def clamp_bbox(bbox: torch.Tensor, img_hw, min_side: float = 3.0) -> torch.Tensor:
    """Clip into the image and enforce a minimum side."""
    h, w = img_hw
    b = ensure_bbox_boundaries(bbox, img_hw)
    x, y, bw, bh = b.unbind(-1)
    small_w = bw < min_side
    x = torch.where(small_w, x - torch.clamp(x + min_side - w, min=0.0), x)
    bw = torch.where(small_w, torch.full_like(bw, min_side), bw)
    small_h = bh < min_side
    y = torch.where(small_h, y - torch.clamp(y + min_side - h, min=0.0), y)
    bh = torch.where(small_h, torch.full_like(bh, min_side), bh)
    return torch.stack([x, y, bw, bh], dim=-1)


def rescale_crop_bbox(
    bbox: torch.Tensor, padded_box: torch.Tensor, instance_size: int, min_side: float = 3.0
) -> torch.Tensor:
    """Map a crop-space bbox back to frame space with banker's rounding."""
    w_scale = padded_box[..., 2] / instance_size
    h_scale = padded_box[..., 3] / instance_size
    x = torch.round(bbox[..., 0] * w_scale + padded_box[..., 0])
    y = torch.round(bbox[..., 1] * h_scale + padded_box[..., 1])
    w = torch.clamp(torch.round(bbox[..., 2] * w_scale), min=min_side)
    h = torch.clamp(torch.round(bbox[..., 3] * h_scale), min=min_side)
    return torch.stack([x, y, w, h], dim=-1)
