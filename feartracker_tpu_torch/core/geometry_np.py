"""Host bbox algebra in numpy, copied from ``feartracker_tpu/core/geometry.py``
with the reference's int and rounding semantics: the host tracker's crop
windows, rescale and clamp, and the evaluation protocols' IoU. All boxes are
``[x, y, w, h]``."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

BBox = Union[Sequence, np.ndarray]


def bbox_iou(a: BBox, b: BBox) -> float:
    """IoU of two xywh boxes with the reference's +1 pixel convention (the
    training loop's online validation scores with it)."""
    x1, y1, w1, h1 = a
    x2, y2, w2, h2 = b
    xa, ya = max(x1, x2), max(y1, y2)
    xb, yb = min(x1 + w1, x2 + w2), min(y1 + h1, y2 + h2)
    inter = max(xb - xa + 1, 0) * max(yb - ya + 1, 0)
    area_a = (w1 + 1) * (h1 + 1)
    area_b = (w2 + 1) * (h2 + 1)
    return inter / (area_a + area_b - inter)


def extend_bbox(bbox: BBox, offset: float = 0.1) -> np.ndarray:
    """Grow a bbox by ``offset`` of its own size on each side, truncated to
    int32. May leave the frame; pair with :func:`ensure_bbox_boundaries`.
    ``1.0 + offset + offset`` is summed left to right, as the reference does:
    ``1.0 + 2 * offset`` can differ in the last bit and flip a truncation."""
    x, y, w, h = bbox
    return np.array(
        [x - w * offset, y - h * offset, w * (1.0 + offset + offset), h * (1.0 + offset + offset)]
    ).astype("int32")


def ensure_bbox_boundaries(bbox: BBox, img_shape: Tuple[int, int]) -> np.ndarray:
    """Clip a bbox into an ``(h, w)`` image → int32."""
    x1, y1, w, h = bbox
    x1, y1 = min(max(0, x1), img_shape[1]), min(max(0, y1), img_shape[0])
    x2, y2 = min(max(0, x1 + w), img_shape[1]), min(max(0, y1 + h), img_shape[0])
    return np.array([x1, y1, x2 - x1, y2 - y1]).astype("int32")


def clamp_bbox(bbox: BBox, shape: Tuple[int, int], min_side: int = 3) -> np.ndarray:
    """Clip into the image and enforce a minimum side length."""
    x, y, w, h = ensure_bbox_boundaries(bbox, img_shape=shape)
    img_h, img_w = shape[0], shape[1]
    if w < min_side:
        w = min_side
        x -= max(0, x + w - img_w)
    if h < min_side:
        h = min_side
        y -= max(0, y + h - img_h)
    return np.array([x, y, w, h])


def handle_empty_bbox(bbox: np.ndarray, min_bbox: int = 3) -> np.ndarray:
    """Enforce a minimum bbox side, in place."""
    bbox[2] = max(bbox[2], min_bbox)
    bbox[3] = max(bbox[3], min_bbox)
    return bbox


def center_to_bbox(center: BBox) -> np.ndarray:
    """xc,yc,w,h → xywh, truncated to int."""
    return np.array(
        [center[0] - center[2] / 2, center[1] - center[3] / 2, center[2], center[3]]
    ).astype("int")


def overlap_xywh_np(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Elementwise IoU of (..., 4) xywh arrays, without the +1 convention."""
    x1 = np.maximum(pred[..., 0], gt[..., 0])
    y1 = np.maximum(pred[..., 1], gt[..., 1])
    x2 = np.minimum(pred[..., 0] + pred[..., 2], gt[..., 0] + gt[..., 2])
    y2 = np.minimum(pred[..., 1] + pred[..., 3], gt[..., 1] + gt[..., 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    union = pred[..., 2] * pred[..., 3] + gt[..., 2] * gt[..., 3] - inter
    return inter / np.maximum(union, 1e-9)


def rescale_crop_bbox(bbox: np.ndarray, padded_box: np.ndarray, instance_size: int,
                      min_side: int = 3) -> list:
    """Map a bbox predicted inside a search crop back to frame coordinates,
    with banker's rounding (python3 ``round``) as the reference does."""
    w_scale = padded_box[2] / instance_size
    h_scale = padded_box[3] / instance_size
    out = [
        round(float(bbox[0]) * w_scale + padded_box[0]),
        round(float(bbox[1]) * h_scale + padded_box[1]),
        max(min_side, round(float(bbox[2]) * w_scale)),
        max(min_side, round(float(bbox[3]) * h_scale)),
    ]
    return list(map(int, out))
