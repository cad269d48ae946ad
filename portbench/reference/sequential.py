"""The sequential tracker's step in plain PyTorch and cv2: the benchmark's
judge of ``FEARTracker.update`` (``drivers/update_single.py``).

The reference tracker (PinataFarms/FEARTracker ``fear_tracker.py``) crops
with ``get_extended_crop``: the box grown by ``offset`` of each side and
truncated to int32 (``1.0 + offset + offset``, summed as the reference
sums it), the part inside the frame cut out, the rest padded with the init
frame's mean colour by ``cv2.copyMakeBorder``, resized by ``cv2.resize``
(INTER_LINEAR) into uint8. That is written out here with cv2, which the
program does not call (it runs its own exact twin on the device). The
network is ``fear.py``; the boxes of every score cell are ``tracker.py``'s
(each cell's box mapped into the frame by the window's scale with
round-half-even, clipped, at least 3 pixels a side), which is the
reference's ``rescale_crop_bbox`` and ``clamp_bbox``. Nothing here imports
the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import fear
from portbench.reference import tracker as ref


def context_window(box, offset: float) -> np.ndarray:
    """``extend_bbox``: xywh grown by ``offset`` a side, truncated to int32."""
    x, y, w, h = [float(v) for v in box]
    return np.array([x - w * offset, y - h * offset, w * (1.0 + offset + offset),
                     h * (1.0 + offset + offset)]).astype("int32")


def extended_crop(image: np.ndarray, box, size: int, offset: float, color) -> np.ndarray:
    """``get_extended_crop``'s uint8 crop of ``image`` (H, W, 3) with cv2."""
    import cv2

    context = context_window(box, offset)
    pad_left, pad_top = max(-int(context[0]), 0), max(-int(context[1]), 0)
    pad_right = max(int(context[0] + context[2]) - image.shape[1], 0)
    pad_bottom = max(int(context[1] + context[3]) - image.shape[0], 0)
    crop = image[context[1] + pad_top:context[1] + context[3] - pad_bottom,
                 context[0] + pad_left:context[0] + context[2] - pad_right]
    padded = cv2.copyMakeBorder(crop, pad_top, pad_bottom, pad_left, pad_right, cv2.BORDER_CONSTANT,
                                value=tuple(float(v) for v in color))
    return cv2.resize(padded, (size, size), interpolation=cv2.INTER_LINEAR)


def _features(W, trunk, crop: np.ndarray, device, prec) -> torch.Tensor:
    x = ref.normalize(torch.from_numpy(np.ascontiguousarray(crop)).to(device).float())[None]
    return fear.features(W, trunk, x, prec=prec)


def init_box(image: np.ndarray, box) -> np.ndarray:
    """``initialize``'s box: clipped into the frame, at least 3 pixels a side."""
    H, Wd = image.shape[:2]
    return ref.clamp_box(torch.as_tensor(np.asarray(box, np.float64))[None], H, Wd)[0].numpy()


def template(W, trunk, image: np.ndarray, box, geo: ref.Geometry, device, prec=fear.F32) -> torch.Tensor:
    color = np.mean(image, axis=(0, 1))
    crop = extended_crop(image, init_box(image, box), geo.template_size, geo.template_offset, color)
    return _features(W, trunk, crop, device, prec)


def step(W, trunk, towernum, tmpl: torch.Tensor, image: np.ndarray, prev, color, geo: ref.Geometry, device,
         prec=fear.F32) -> ref.Judged:
    """One update around the previous box ``prev`` → the judged score map
    and the frame box of every cell."""
    H, Wd = image.shape[:2]
    crop = extended_crop(image, prev, geo.instance_size, geo.search_context, color)
    reg, cls = fear.head(W, towernum, _features(W, trunk, crop, device, prec), tmpl, prec=prec)
    win = torch.as_tensor(context_window(prev, geo.search_context), dtype=torch.float32, device=device)[None]
    score = torch.sigmoid(cls[..., 0]).reshape(1, -1)
    boxes = ref.cell_boxes(reg, win, geo, H, Wd)
    top, arg = score.max(dim=1)
    smin = score.amin(dim=1)
    apce = (top - smin) ** 2 / (((score - smin[:, None]) ** 2).mean(dim=1) + 1e-12)
    return ref.Judged(score, boxes, top, boxes[0, arg], apce, win)
