"""Host bbox algebra in numpy, copied from ``feartracker_tpu/core/geometry.py``
with the reference's int and rounding semantics (``python2round``, ``int()``
truncation): the host tracker's crop windows, rescale and clamp, the
evaluation protocols' IoU, and the SiamFC-lineage helpers of the
reference's ``utils/utils.py``. All boxes are ``[x, y, w, h]``.

:func:`transform_bbox` is ``cv2.transform`` of the box's corners without
cv2: a diagonal map (off-diagonal terms within ``DBL_EPSILON``, as cv2
tests) computes ``fma(m00, x, m02)``, any other ``fma(m00, x, m01·y) +
m02``, each fused multiply-add rounded once, as cv2's x86 build computes
them (held against cv2 in the tests)."""

from __future__ import annotations

from fractions import Fraction
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


def limit(radius):
    """max(r, 1/r): the scale and ratio penalties' term."""
    return np.maximum(radius, 1.0 / radius)


def squared_size(w, h):
    """SiamFC's context size sqrt((w + p)(h + p)), p = (w + h) / 2."""
    pad = (w + h) * 0.5
    return np.sqrt((w + pad) * (h + pad))


def python2round(x: float) -> float:
    """Round half away from zero, as Python 2's ``round`` did (the crop side
    of the SiamFC lineage); Python 3 and numpy round half to even."""
    if round(x + 1) - round(x) != 1:
        return x + abs(x) / x * 0.5
    return round(x)


def bbox_to_center(bbox: BBox) -> np.ndarray:
    """xywh → xc,yc,w,h, truncated to int."""
    return np.array([bbox[0] + bbox[2] / 2, bbox[1] + bbox[3] / 2, bbox[2], bbox[3]]).astype("int")


def xywh_to_xyxy(bbox: np.ndarray) -> np.ndarray:
    out = np.asarray(bbox, dtype=np.float64).copy()
    out[..., 2] = out[..., 0] + out[..., 2]
    out[..., 3] = out[..., 1] + out[..., 3]
    return out


def crop_context_window(bbox: BBox, context: float) -> Tuple[np.ndarray, int]:
    """The integer window :func:`extend_bbox` selects for a search crop, and
    its side."""
    ctx = extend_bbox(np.asarray(bbox), context)
    return ctx, int(ctx[2])


def bbox_from_cxy_wh(position: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Centre + size → xywh, with x and y floored at 0."""
    return np.array(
        [
            max(0.0, position[0] - size[0] / 2),
            max(0.0, position[1] - size[1] / 2),
            float(size[0]),
            float(size[1]),
        ]
    )


def position_from_bbox(bbox: BBox) -> np.ndarray:
    """xywh → centre point."""
    x, y, w, h = bbox
    return np.array([x + w / 2, y + h / 2])


def get_side_with_context(bbox: BBox, context_amount: float) -> float:
    """SiamFC's context side: sqrt((w + p)(h + p)), p = c·(w + h), rounded
    (half to even) and at least 1."""
    w, h = bbox[2], bbox[3]
    wc = w + context_amount * (w + h)
    hc = h + context_amount * (w + h)
    return max(round(np.sqrt(wc * hc)), 1)


def get_points(bbox: BBox) -> np.ndarray:
    """A box's corners as (4, 1, 2) float64 points, ``cv2.transform``'s
    layout: top-left, bottom-left, bottom-right, top-right."""
    return (
        np.array(
            [
                [bbox[0], bbox[1]],
                [bbox[0], bbox[1] + bbox[3]],
                [bbox[0] + bbox[2], bbox[1] + bbox[3]],
                [bbox[0] + bbox[2], bbox[1]],
            ]
        )
        .reshape((-1, 1, 2))
        .astype("float64")
    )


def _fma(a: float, b: float, c: float) -> float:
    """a·b + c rounded once (Python 3.12 has no ``math.fma``)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _transform_points(pts: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.transform(pts, m)`` of (N, 1, 2) float64 points by a 2×3
    float64 map (see the module docstring)."""
    eps = np.finfo(np.float64).eps
    diag = abs(m[0, 1]) <= eps and abs(m[1, 0]) <= eps
    out = np.empty_like(pts)
    for i, (x, y) in enumerate(pts[:, 0].tolist()):
        for r, v in ((0, x), (1, y)):
            if diag:
                out[i, 0, r] = _fma(m[r, r], v, m[r, 2])
            else:
                out[i, 0, r] = _fma(m[r, 0], x, m[r, 1] * y) + m[r, 2]
    return out


def transform_bbox(bbox: BBox, mapping: np.ndarray, inverse: bool = False) -> np.ndarray:
    """A box through a 2×3 affine map (or its inverse), as the corners'
    ``cv2.transform``: the top-left and the bottom-right corner's offset,
    truncated to int."""
    mapping = np.asarray(mapping, np.float64)
    if inverse:
        full = np.concatenate([mapping, np.array([[0.0, 0.0, 1.0]])], axis=0)
        mapping = np.linalg.pinv(full)[:2]
    pts = _transform_points(get_points(bbox), mapping)
    x, y = pts[0, 0]
    w, h = pts[2, 0] - pts[0, 0]
    return np.array([x, y, w, h]).astype("int")


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
