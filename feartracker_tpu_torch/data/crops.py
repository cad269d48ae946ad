"""The host crop engine, the counterpart of ``feartracker_tpu/data/crops.py``:
the tracker's context crop (``get_extended_crop``) and the reference's
other crops (``rescale_crop``, ``get_crop_context``,
``get_subwindow_tracking``).

The window and padding geometry is numpy on the host, with the reference's
int semantics; the pad, the resize and the affine warp are the exact cv2
twins of :mod:`feartracker_tpu_torch.ops.resize`, on the image tensor's
device. The crop bytes equal the JAX package's cv2 crops on the CPU and on
the card. The last three take a numpy image and return numpy, as JAX's do,
or a tensor and return one on its device.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from feartracker_tpu_torch.core.geometry_np import (
    center_to_bbox,
    ensure_bbox_boundaries,
    extend_bbox,
    get_side_with_context,
    position_from_bbox,
    transform_bbox,
)
from feartracker_tpu_torch.ops.resize import (
    mean_color,
    pad_color_u8,
    pad_constant_u8,
    resize_linear_u8,
    warp_affine_linear_u8,
)


def _as_tensor(image) -> Tuple[torch.Tensor, bool]:
    if isinstance(image, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(image)), True
    return image, False


def rescale_crop(image, bbox: np.ndarray, out_size: int, padding=(0, 0, 0)):
    """The affine crop of ``bbox`` (xywh) to ``out_size``², out-of-frame
    taps in ``padding``, and its float64 2×3 mapping (frame → crop)."""
    a = (out_size - 1) / bbox[2]
    b = (out_size - 1) / bbox[3]
    mapping = np.array([[a, 0, -a * bbox[0]], [0, b, -b * bbox[1]]], np.float64)
    img, was_numpy = _as_tensor(image)
    crop = warp_affine_linear_u8(img, mapping, (out_size, out_size), padding)
    return (crop.cpu().numpy() if was_numpy else crop), mapping


def get_crop_context(image, bbox: np.ndarray, context_amount: float = 0.5, bbox_side_ratio: float = 0.25,
                     crop_size: int = 512, padding_value: Optional[np.ndarray] = None):
    """A centred context crop with a fixed box-to-crop side ratio →
    ``(crop, crop_bbox int (4,), mapping)``; ``padding_value`` defaults to
    the image's mean colour."""
    img, was_numpy = _as_tensor(image)
    if padding_value is None:
        padding_value = mean_color(img).cpu().numpy()
    side_size = int(crop_size * bbox_side_ratio)
    cx, cy = bbox[0] + bbox[2] / 2.0, bbox[1] + bbox[3] / 2.0
    s_z = get_side_with_context(bbox, context_amount)
    scale_z = side_size / s_z
    pad = (crop_size - side_size) / 2 / scale_z
    s_x = s_z + 2 * pad
    crop, mapping = rescale_crop(img, center_to_bbox([cx, cy, s_x, s_x]), crop_size,
                                 tuple(float(v) for v in np.asarray(padding_value).ravel()))
    return (crop.cpu().numpy() if was_numpy else crop), transform_bbox(bbox, mapping), mapping


def get_subwindow_tracking(frame, bbox: np.ndarray, template_size: int, original_sz: int, avg_chans: np.ndarray):
    """SiamFC's square subwindow of side ``original_sz`` around the box's
    centre, padded with ``avg_chans`` (stored into uint8 as numpy stores a
    float: truncated) and resized to ``template_size`` (cv2's bilinear
    resize) → ``(patch, crop_info)``."""
    img, was_numpy = _as_tensor(frame)
    position = position_from_bbox(bbox)
    sz = original_sz
    im_h, im_w = img.shape[:2]
    c = (original_sz + 1) / 2
    context_xmin = round(position[0] - c)
    context_xmax = context_xmin + sz - 1
    context_ymin = round(position[1] - c)
    context_ymax = context_ymin + sz - 1
    left_pad = int(max(0.0, -context_xmin))
    top_pad = int(max(0.0, -context_ymin))
    right_pad = int(max(0.0, context_xmax - im_w + 1))
    bottom_pad = int(max(0.0, context_ymax - im_h + 1))

    context_xmin += left_pad
    context_xmax += left_pad
    context_ymin += top_pad
    context_ymax += top_pad

    rows = slice(int(context_ymin), int(context_ymax + 1))
    cols = slice(int(context_xmin), int(context_xmax + 1))
    if any([top_pad, bottom_pad, left_pad, right_pad]):
        color = np.zeros(img.shape[2], np.uint8)
        color[...] = avg_chans
        te = torch.zeros((im_h + top_pad + bottom_pad, im_w + left_pad + right_pad, img.shape[2]), dtype=torch.uint8,
                         device=img.device)
        te[:, :] = torch.from_numpy(color).to(img.device)
        te[top_pad:top_pad + im_h, left_pad:left_pad + im_w] = img
        patch = te[rows, cols]
    else:
        patch = img[rows, cols]
    if template_size != original_sz:
        patch = resize_linear_u8(patch, (template_size, template_size))
    crop_info = {
        "crop_cords": [context_xmin, context_xmax, context_ymin, context_ymax],
        "pad_info": [top_pad, left_pad, im_h, im_w],
    }
    return (patch.cpu().numpy() if was_numpy else patch), crop_info


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
