"""Integer-exact uint8 image ops: cv2's ``resize(INTER_LINEAR)`` and
``copyMakeBorder(BORDER_CONSTANT)`` on (H, W, 3) uint8 tensors.

The host tracker's crop (``feartracker_tpu/data/crops.py:145-158``) and the
batched evaluation's letterbox (``evaluate/batched_eval.py:44``) are cv2
calls in the JAX package. cv2 resizes uint8 images in 11-bit fixed point;
this module repeats that arithmetic in integer tensor ops, so the bytes equal
cv2's, and the CPU and the card give the same bytes.

Per axis, with ``scale = 1 / (dst / src)`` in float64:

* ``f = float32((d + 0.5)·scale − 0.5)``, ``s = floor(f)``, ``f −= s``;
* coefficients ``round_half_even((1 − f)·2048)`` and
  ``round_half_even(f·2048)`` in float32;
* source indices ``clip(s)`` and ``clip(s + 1)`` into ``[0, src − 1]``;
* on x only, a border sample (``s < 0`` or ``s ≥ src − 1``) is clamped to
  ``f = 0`` at ``s = clip(s)``; on y only the indices are clipped.

Horizontal pass ``R = I[:, x0]·a0 + I[:, x1]·a1`` in int32; vertical pass
``((((R[y0] >> 4)·b0) >> 16) + (((R[y1] >> 4)·b1) >> 16) + 2) >> 2``,
clipped to [0, 255] (cv2's SIMD rounding, which its scalar tail repeats).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

_COEF_SCALE = 2048.0  # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _axis_coeffs(src: int, dst: int, clamp: bool, device) -> Tuple[torch.Tensor, ...]:
    """(i0, i1, c0, c1) for one axis: int64 source indices and int32
    fixed-point coefficients of the ``dst`` output samples."""
    scale = 1.0 / (dst / src)
    d = torch.arange(dst, dtype=torch.float64, device=device)
    f = ((d + 0.5) * scale - 0.5).to(torch.float32)
    s = torch.floor(f)
    f = f - s
    s = s.to(torch.int64)
    if clamp:
        border = (s < 0) | (s >= src - 1)
        f = torch.where(border, torch.zeros_like(f), f)
        s = s.clamp(0, src - 1)
    c0 = torch.round((1.0 - f) * _COEF_SCALE).to(torch.int32)
    c1 = torch.round(f * _COEF_SCALE).to(torch.int32)
    return s.clamp(0, src - 1), (s + 1).clamp(0, src - 1), c0, c1


def resize_linear_u8(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` of an
    (H, W, C) uint8 tensor, byte for byte; ``size`` is cv2's ``(w, h)``."""
    if image.dtype != torch.uint8 or image.dim() != 3:
        raise ValueError(f"resize_linear_u8: need an (H, W, C) uint8 tensor, got {image.dtype} "
                         f"{tuple(image.shape)}")
    dst_w, dst_h = int(size[0]), int(size[1])
    src_h, src_w = image.shape[0], image.shape[1]
    if min(dst_w, dst_h, src_h, src_w) < 1:
        raise ValueError(f"resize_linear_u8: empty source {tuple(image.shape)} or size {size}")
    if (dst_h, dst_w) == (src_h, src_w):
        return image.clone()
    dev = image.device
    x0, x1, a0, a1 = _axis_coeffs(src_w, dst_w, True, dev)
    y0, y1, b0, b1 = _axis_coeffs(src_h, dst_h, False, dev)
    img = image.to(torch.int32)
    a0, a1 = a0[None, :, None], a1[None, :, None]
    r0 = img[y0][:, x0] * a0 + img[y0][:, x1] * a1  # (dst_h, dst_w, C)
    r1 = img[y1][:, x0] * a0 + img[y1][:, x1] * a1
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16)
    return ((out + 2) >> 2).clamp(0, 255).to(torch.uint8)


def pad_color_u8(value: Union[np.ndarray, Sequence[float], torch.Tensor], device) -> torch.Tensor:
    """A constant border colour as cv2 stores it for a uint8 image: each
    channel rounded half to even and saturated to [0, 255] → (C,) uint8 on
    ``device``. A float tensor is converted on its own device."""
    if isinstance(value, torch.Tensor):
        return torch.round(value.double()).clamp(0, 255).to(torch.uint8).to(device)
    vals = np.clip(np.rint(np.asarray(value, np.float64).ravel()), 0, 255).astype(np.uint8)
    return torch.from_numpy(vals).to(device)


def mean_color(image: torch.Tensor) -> torch.Tensor:
    """``np.mean(image, axis=(0, 1))`` of an (H, W, C) uint8 tensor, float64
    on its device: an exact integer sum divided once, as numpy's float64
    mean of integers, so the rounding of :func:`pad_color_u8` agrees."""
    total = image.sum(dim=(0, 1), dtype=torch.int64)
    return total.double() / float(image.shape[0] * image.shape[1])


def pad_constant_u8(image: torch.Tensor, top: int, bottom: int, left: int, right: int,
                    color: torch.Tensor) -> torch.Tensor:
    """``cv2.copyMakeBorder(image, top, bottom, left, right,
    cv2.BORDER_CONSTANT, value)`` for an (H, W, C) uint8 tensor, where
    ``color`` is :func:`pad_color_u8` of ``value``."""
    if not (top or bottom or left or right):
        return image
    h, w, c = image.shape
    out = color.to(image.device).expand(h + top + bottom, w + left + right, c).clone()
    out[top:top + h, left:left + w] = image
    return out
