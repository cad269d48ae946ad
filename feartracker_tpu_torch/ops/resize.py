"""Exact uint8 image ops: cv2's ``resize(INTER_LINEAR)``,
``copyMakeBorder(BORDER_CONSTANT)`` and ``warpAffine(INTER_LINEAR,
BORDER_CONSTANT)`` on (H, W, 3) uint8 tensors.

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

``warp_affine_linear_u8`` repeats OpenCV 4.11+'s float32 warp kernel
(``warpAffineLinearInvoker_8UC3``, its AVX2 build, which cv2 dispatches to
on x86 hosts with AVX2), not the older 10-bit fixed-point one: held to
cv2 5.0 byte for byte in ``tests/test_torch_geometry_host.py`` on
axis-aligned maps (the crops' maps; a map that rotates or shears raises). The inverse map ``M`` is
cv2's ``invertAffineTransform`` in float64, then float32. Per output pixel
(x, y):

* ``sy = f32(f32(y·M4) + M5)``; ``sx = fma(M0, x, M2)`` in the vector body
  and ``f32(f32(x·M0) + M2)`` in the scalar tail, the last ``W mod 16``
  columns (16 pixels a vector step);
* ``i = floor(s)``, ``a = s − i``; the four taps are image pixels, or the
  border colour (rounded half to even, saturated) where outside;
* ``v0 = fma(a, p01 − p00, p00)``, ``v1 = fma(a, p11 − p10, p10)``,
  ``v = fma(b, v1 − v0, v0)``, rounded half to even.

The fused multiply-adds are exact: computed in float64 and rounded
once to float32, with the one case float64 can round wrongly (a result
exactly halfway between two floats) settled by the float64 sum's error.
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


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` of float32 tensors: a·b + c rounded once."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64  # exact: 24 + 24 bits
    s = p + c64
    z = s - p
    err = (p - (s - z)) + (c64 - z)  # s + err == p + c exactly (TwoSum)
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    tie = (s != rd) & (s == (rd + other.double()) * 0.5)
    toward = (err != 0) & ((err > 0) == (other > r))
    return torch.where(tie & toward, other, r)


def _invert_affine(m: Sequence[Sequence[float]]) -> np.ndarray:
    """cv2's ``invertAffineTransform`` of a 2×3 map, flat, float64."""
    M = np.asarray(m, np.float64).reshape(6).copy()
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    A11, A22 = M[4] * D, M[0] * D
    M[0] = A11
    M[1] *= -D
    M[3] *= -D
    M[4] = A22
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return M


def warp_affine_linear_u8(image: torch.Tensor, m: Sequence[Sequence[float]], size: Tuple[int, int],
                          border: Union[np.ndarray, Sequence[float]] = (0.0, 0.0, 0.0)) -> torch.Tensor:
    """``cv2.warpAffine(image, m, size, flags=cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_CONSTANT, borderValue=border)`` of an (H, W, C)
    uint8 tensor, byte for byte (see the module docstring), on the image's
    device; ``m`` maps source to destination and must not rotate or shear;
    ``size`` is cv2's ``(w, h)``."""
    if image.dtype != torch.uint8 or image.dim() != 3:
        raise ValueError(f"warp_affine_linear_u8: need an (H, W, C) uint8 tensor, got {image.dtype} "
                         f"{tuple(image.shape)}")
    fwd = np.asarray(m, np.float64).reshape(2, 3)
    if fwd[0, 1] != 0 or fwd[1, 0] != 0:
        raise ValueError(f"warp_affine_linear_u8: the map {fwd.tolist()} rotates or shears; only axis-aligned "
                         "maps are held to cv2's bytes")
    dst_w, dst_h = int(size[0]), int(size[1])
    H, W, C = image.shape
    dev = image.device
    M = torch.tensor(_invert_affine(fwd).astype(np.float32), device=dev)
    xs = torch.arange(dst_w, device=dev, dtype=torch.float32)
    ys = torch.arange(dst_h, device=dev, dtype=torch.float32)
    sy = ys * M[4] + M[5]
    tail0 = dst_w // 16 * 16  # the vector body covers whole steps of 16 columns
    sx = torch.where(xs >= tail0, xs * M[0] + M[2], _fma_f32(M[0].expand_as(xs), xs, M[2].expand_as(xs)))
    ix, iy = torch.floor(sx), torch.floor(sy)
    a, b = (sx - ix)[None, :, None], (sy - iy)[:, None, None]
    ix, iy = ix.long(), iy.long()
    cval = pad_color_u8(border, dev).float()[:C]
    img = image.float()

    def taps(rows, cols):
        inside = (((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))[None, :])[..., None]
        got = img[rows.clamp(0, H - 1)][:, cols.clamp(0, W - 1)]
        return torch.where(inside, got, cval)

    p00, p01 = taps(iy, ix), taps(iy, ix + 1)
    p10, p11 = taps(iy + 1, ix), taps(iy + 1, ix + 1)
    a, b = a.expand_as(p00), b.expand_as(p00)
    v0 = _fma_f32(a, p01 - p00, p00)
    v1 = _fma_f32(a, p11 - p10, p10)
    v = _fma_f32(b, v1 - v0, v0)
    return torch.round(v).clamp(0, 255).to(torch.uint8)
