"""Label-map and negative-crop utilities (numpy), the counterpart of
``feartracker_tpu/data/labels.py``: the same formulas and the same
``random.Random`` draws in the same order."""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np


def get_regression_weight_label(
    bbox, image_size: int = 256, map_size: int = 16, r_pos: int = 2, r_neg: int = 0
) -> np.ndarray:
    """Manhattan-distance weighting around the box centre on the score grid."""
    cx, cy = bbox[0] + bbox[2] // 2, bbox[1] + bbox[3] // 2
    sx = np.floor(float(cx / image_size * map_size))
    sy = np.floor(float(cy / image_size * map_size))
    x, y = np.meshgrid(np.arange(map_size) - sx, np.arange(map_size) - sy)
    dist = np.abs(x) + np.abs(y)
    return np.where(dist <= r_pos, 1.0, np.where(dist < r_neg, 0.5, 0.0)).astype(np.float32)


def get_max_side_near_bbox(bbox: np.ndarray, frame: np.ndarray) -> Tuple[np.ndarray, str]:
    """The largest region of ``frame`` beside the bbox, and its side's name."""
    sides = [
        frame[:, : bbox[0]],
        frame[:, bbox[0] + bbox[2] :],
        frame[: bbox[1], :],
        frame[bbox[1] + bbox[3] :],
    ]
    names = ["left", "right", "top", "bottom"]
    areas = [s.shape[0] * s.shape[1] for s in sides]
    i = int(np.argmax(areas))
    return sides[i], names[i]


def get_similar_random_crop(area: float, shape: Tuple[int, int], rng: random.Random = random) -> np.ndarray:
    """A random crop of roughly ``area`` pixels inside ``shape``."""
    crop_area = rng.normalvariate(area, area / 12)
    first = rng.normalvariate(crop_area**0.5, (crop_area**0.5) / 8)
    second = crop_area / max(first, 1e-6)
    if shape[0] > shape[1]:
        ch, cw = max(first, second), min(first, second)
    else:
        ch, cw = min(first, second), max(first, second)
    cw, ch = int(min(max(cw, 1), shape[1])), int(min(max(ch, 1), shape[0]))
    cx = rng.randint(0, max(shape[1] - cw, 0))
    cy = rng.randint(0, max(shape[0] - ch, 0))
    return np.array([cx, cy, cw, ch], dtype="int32")


def get_negative_crop(bbox: np.ndarray, image: np.ndarray, rng: random.Random = random) -> np.ndarray:
    """A crop beside the object, for negative mining."""
    side, name = get_max_side_near_bbox(bbox, image)
    neg = get_similar_random_crop(max(bbox[2] * bbox[3], 1), side.shape, rng)
    if name == "right":
        neg[0] += bbox[0] + bbox[2]
    elif name == "bottom":
        neg[1] += bbox[1] + bbox[3]
    return neg


def augment_context(
    context: np.ndarray,
    min_scale: float,
    max_scale: float,
    min_shift: float,
    max_shift: float,
    rng: random.Random = random,
) -> np.ndarray:
    """Random scale and shift of a context window."""
    xc = context[0] + context[2] / 2
    yc = context[1] + context[3] / 2
    w, h = context[2], context[3]
    side = (context[2] * context[3]) ** 0.5
    scale = rng.uniform(min_scale, max_scale) * rng.choice([-1.0, 1.0])
    shift = rng.uniform(min_shift, max_shift) * rng.choice([-1.0, 1.0])
    w_new, h_new = w + side * scale, h + side * scale
    xc_new, yc_new = xc + side * shift, yc + side * shift
    return np.array(
        [xc_new - w_new / 2, yc_new - h_new / 2, w_new, h_new]
    ).astype("int")
