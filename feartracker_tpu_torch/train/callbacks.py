"""Training callbacks, the counterpart of ``feartracker_tpu/train/callbacks.py``:
early stopping, and best/worst batch mining with image mosaics for the
event log. On the host, in numpy; ``cv2`` (which draws the mosaics) is
imported inside :func:`batch_mosaic` only: the card host has none, and the
loop mines no batches there (its device augmentations leave no host crops).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from feartracker_tpu_torch.core.grids import make_grid_np
from feartracker_tpu_torch.utils import constants as C


class EarlyStopping:
    """Stop after ``patience`` epochs without a better metric."""

    def __init__(self, patience: int = 20, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, metric: float) -> bool:
        """Feed an epoch metric; returns True when training should stop."""
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best)
            or (self.mode == "min" and metric < self.best)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience


def _denormalize(img: np.ndarray) -> np.ndarray:
    mean = np.asarray(C.IMAGENET_MEAN, np.float32) * 255.0
    std = np.asarray(C.IMAGENET_STD, np.float32) * 255.0
    return np.clip(img * std + mean, 0, 255).astype(np.uint8)


def batch_mosaic(
    batch: Dict[str, Any],
    outputs: Dict[str, np.ndarray],
    score: float,
    max_images: int = 8,
    score_size: int = 16,
    stride: int = 16,
    instance_size: int = 256,
) -> np.ndarray:
    """Template|search pairs of a host batch (numpy) with the predicted box
    (green) and the true box (red when absent, blue when present), one row
    each under a header with the batch's score → HWC uint8."""
    import cv2

    gx, gy = make_grid_np(score_size, stride, instance_size)
    cls = np.asarray(outputs[C.TARGET_CLASSIFICATION_KEY])[..., 0]
    reg = np.asarray(outputs[C.TARGET_REGRESSION_LABEL_KEY])
    rows: List[np.ndarray] = []
    n = min(len(cls), max_images)
    for i in range(n):
        r, c = np.unravel_index(cls[i].argmax(), cls[i].shape)
        x1 = gx[r, c] - reg[i, r, c, 0]
        y1 = gy[r, c] - reg[i, r, c, 1]
        x2 = gx[r, c] + reg[i, r, c, 2]
        y2 = gy[r, c] + reg[i, r, c, 3]
        search = _denormalize(np.asarray(batch[C.TRACKER_TARGET_SEARCH_IMAGE_KEY][i]))
        template = _denormalize(np.asarray(batch[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY][i]))
        search = cv2.rectangle(
            search.copy(), (int(x1), int(y1)), (int(x2), int(y2)), (0, 250, 0), 2
        )
        gt = np.asarray(batch[C.TRACKER_TARGET_BBOX_KEY][i]).astype(int)
        visible = float(np.asarray(batch[C.TARGET_VISIBILITY_KEY][i]).ravel()[0]) != 0.0
        gt_color = (250, 0, 0) if visible else (0, 0, 250)
        search = cv2.rectangle(search, (gt[0], gt[1]), (gt[0] + gt[2], gt[1] + gt[3]), gt_color, 2)
        th = cv2.copyMakeBorder(
            template, 0, search.shape[0] - template.shape[0], 0, 8, cv2.BORDER_CONSTANT, value=0
        )
        rows.append(np.concatenate([th, search], axis=1))
    mosaic = np.concatenate(rows, axis=0)
    header = np.zeros((24, mosaic.shape[1], 3), np.uint8)
    cv2.putText(header, f"batch score {score:.4f}", (4, 17), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    return np.concatenate([header, mosaic], axis=0)


class BestWorstMiner:
    """The best and the worst batch of an epoch by a monitored scalar, with
    their mosaics for the event log."""

    def __init__(self, metric_mode: str = "min", max_images: int = 8):
        self.metric_mode = metric_mode
        self.max_images = max_images
        self.reset()

    def reset(self) -> None:
        self.best_score: Optional[float] = None
        self.worst_score: Optional[float] = None
        self.best_mosaic: Optional[np.ndarray] = None
        self.worst_mosaic: Optional[np.ndarray] = None

    def update(self, score: float, batch: Dict[str, Any], outputs: Dict[str, Any]) -> None:
        # a NaN score ranks nothing, and a NaN box cannot be drawn
        if not np.isfinite(score) or not np.all(
            np.isfinite(np.asarray(outputs[C.TARGET_REGRESSION_LABEL_KEY]))
        ):
            return
        better = self.best_score is None or (
            score < self.best_score if self.metric_mode == "min" else score > self.best_score
        )
        worse = self.worst_score is None or (
            score > self.worst_score if self.metric_mode == "min" else score < self.worst_score
        )
        if better:
            self.best_score = score
            self.best_mosaic = batch_mosaic(batch, outputs, score, self.max_images)
        if worse:
            self.worst_score = score
            self.worst_mosaic = batch_mosaic(batch, outputs, score, self.max_images)
