"""The host tracker's context crop, the counterpart of
``feartracker_tpu/data/crops.py`` ``get_extended_crop``.

The window and padding geometry is numpy on the host, with the reference's
int semantics; the pad and the resize are the integer-exact cv2 twins of
:mod:`feartracker_tpu_torch.ops.resize`, on the image tensor's device. The
crop bytes equal the JAX package's cv2 crop on the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from feartracker_tpu_torch.core.geometry_np import ensure_bbox_boundaries, extend_bbox
from feartracker_tpu_torch.ops.resize import (
    mean_color,
    pad_color_u8,
    pad_constant_u8,
    resize_linear_u8,
)


def get_extended_crop(
    image: Union[np.ndarray, torch.Tensor],
    bbox: np.ndarray,
    crop_size: int,
    offset: float,
    padding_value: Optional[Union[np.ndarray, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Extend ``bbox`` by ``offset`` per side, pad out-of-frame regions with
    ``padding_value`` (the image's mean colour by default), resize to
    ``crop_size``².

    ``image`` is an (H, W, 3) uint8 tensor, whose device the crop runs on,
    or a numpy array (cropped on the CPU).
    ``padding_value`` is a float colour (numpy or tensor), or a (3,) uint8
    tensor already rounded as cv2 stores it (:func:`pad_color_u8`).

    Returns ``(crop (crop_size, crop_size, 3) uint8 tensor on the image's
    device, crop_bbox float64 (4,), context_window int32 (4,))``: the
    window is the frame-space region the crop covers.
    """
    if isinstance(image, np.ndarray):
        image = torch.from_numpy(np.ascontiguousarray(image))
    dev = image.device
    if padding_value is None:
        color = pad_color_u8(mean_color(image), dev)
    elif isinstance(padding_value, torch.Tensor) and padding_value.dtype == torch.uint8:
        color = padding_value.to(dev)
    else:
        color = pad_color_u8(padding_value, dev)
    img_h, img_w = image.shape[0], image.shape[1]
    context = extend_bbox(np.asarray(bbox), offset)
    pad_left, pad_top = max(-int(context[0]), 0), max(-int(context[1]), 0)
    pad_right = max(int(context[0] + context[2]) - img_w, 0)
    pad_bottom = max(int(context[1] + context[3]) - img_h, 0)

    crop = image[
        context[1] + pad_top : context[1] + context[3] - pad_bottom,
        context[0] + pad_left : context[0] + context[2] - pad_right,
    ]
    padded = pad_constant_u8(crop, pad_top, pad_bottom, pad_left, pad_right, color)
    padded_h, padded_w = padded.shape[0], padded.shape[1]
    padded_bbox = ensure_bbox_boundaries(
        np.array([bbox[0] - context[0], bbox[1] - context[1], bbox[2], bbox[3]]),
        img_shape=(padded_h, padded_w),
    )
    resized = resize_linear_u8(padded, (crop_size, crop_size))
    scale_x = crop_size / padded_w
    scale_y = crop_size / padded_h
    out_bbox = padded_bbox.astype(np.float64) * np.array([scale_x, scale_y, scale_x, scale_y])
    return resized, out_bbox, context
