"""Device crop engine: crop + pad + resize + normalize, batched over streams.

The counterpart of ``feartracker_tpu/ops/crop.py`` with the stream axis
written out (the JAX package ``vmap``s per-frame functions). Semantics are
the same: the source window is the truncated integer context window; samples
outside the frame read the per-stream pad color; the resize uses cv2's
INTER_LINEAR grid ``src = (dst + 0.5)·scale − 0.5`` clamped into the window.
``F.grid_sample`` has neither that clamp nor the pad-color mix, so the
resampling is written out: as a gather (:func:`crop_resize`) or as two
batched contractions (:func:`crop_resize_mm`). ``ScanTracker``'s default
route is neither: K3 (``ops/cuda/crop.py``, ``csrc/crop.cu``) crops, pads,
normalizes and casts in one launch, and its plain twin is
:func:`crop_resize` followed by :func:`normalize_imagenet` and the cast.
``crop_resize_mm`` stays the route of ``crop_impl="mm"``, of
``FEARTracker``'s ``native_preprocess`` crop and of training's affine crop.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from feartracker_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


def _src_grid(origin: torch.Tensor, size: torch.Tensor, out_size: int) -> torch.Tensor:
    """(S,) window origin/size → (S, out_size) clamped cv2 sample positions."""
    d = (torch.arange(out_size, dtype=torch.float32, device=origin.device) + 0.5) / out_size
    src = origin[:, None] + d[None, :] * size[:, None] - 0.5
    return torch.minimum(torch.maximum(src, origin[:, None]), (origin + size - 1.0)[:, None])


def crop_resize(
    frames: torch.Tensor,
    windows: torch.Tensor,
    out_size: int,
    pad_value: torch.Tensor,
) -> torch.Tensor:
    """Bilinear-sample an ``out_size``² crop of each window by gather.

    Args:
      frames: (S, H, W, C) float32 or uint8 frames (only the gathered taps
        are widened to float32).
      windows: (S, 4) float32 [x, y, w, h] integer-valued windows (may extend
        past the frame).
      pad_value: (S, C) fill color for out-of-frame samples.
    Returns:
      (S, out_size, out_size, C) float32.
    """
    S, H, W, C = frames.shape
    src_x = _src_grid(windows[:, 0], windows[:, 2], out_size)
    src_y = _src_grid(windows[:, 1], windows[:, 3], out_size)
    x0f, y0f = torch.floor(src_x), torch.floor(src_y)
    fx = (src_x - x0f)[:, None, :, None]  # (S, 1, out, 1)
    fy = (src_y - y0f)[:, :, None, None]  # (S, out, 1, 1)
    x0, y0 = x0f.long(), y0f.long()
    sidx = torch.arange(S, device=frames.device)[:, None, None]
    pad = pad_value[:, None, None, :]

    def sample(yi, xi):
        inside = ((yi >= 0) & (yi < H))[:, :, None] & ((xi >= 0) & (xi < W))[:, None, :]
        vals = frames[sidx, yi.clamp(0, H - 1)[:, :, None], xi.clamp(0, W - 1)[:, None, :]].float()
        return torch.where(inside[..., None], vals, pad)

    top = sample(y0, x0) * (1.0 - fx) + sample(y0, x0 + 1) * fx
    bot = sample(y0 + 1, x0) * (1.0 - fx) + sample(y0 + 1, x0 + 1) * fx
    return top * (1.0 - fy) + bot * fy


def _interp_matrix(
    origin: torch.Tensor, size: torch.Tensor, src_len: int, out_size: int, dtype,
    grid: str = "resize",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched rows of the 1-D bilinear operator for one axis.

    Returns (R (S, out_size, src_len), wsum (S, out_size)): ``R @ src`` resizes
    the axis with out-of-range samples dropped (weight 0); ``wsum`` is the
    retained weight per output element, used to mix the pad color back in.

    ``grid``: "resize" is cv2's INTER_LINEAR grid, clamped into the window
    (the trackers' crop); "affine" is ``cv2.warpAffine`` with scale
    (out−1)/size, ``src = origin + dst·size/(out−1)``, unclamped, as the
    training crop (``BBoxCropWithOffsets``) samples.
    """
    if grid == "affine":
        d = torch.arange(out_size, dtype=torch.float32, device=origin.device)
        src = origin[:, None] + d[None, :] * size[:, None] / (out_size - 1)
    elif grid == "resize":
        src = _src_grid(origin, size, out_size)
    else:
        raise ValueError(f"unknown grid {grid!r}")
    s0f = torch.floor(src)
    f = src - s0f
    s0 = s0f.long()
    w0 = torch.where((s0 >= 0) & (s0 < src_len), 1.0 - f, torch.zeros_like(f))
    w1 = torch.where((s0 + 1 >= 0) & (s0 + 1 < src_len), f, torch.zeros_like(f))
    idx = torch.arange(src_len, device=origin.device)
    R = (w0[..., None] * (s0[..., None] == idx) + w1[..., None] * (s0[..., None] + 1 == idx))
    return R.to(dtype), (w0 + w1).float()


def crop_resize_mm(
    frames: torch.Tensor,
    windows: torch.Tensor,
    out_size: int,
    pad_value: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    grid: str = "resize",
) -> torch.Tensor:
    """Separable-matmul form of :func:`crop_resize`: ``R_y @ frame @ R_xᵀ``
    per stream, as two batched contractions; the pad color is mixed back in
    with the retained-weight outer product. ``frames`` may be uint8.
    ``grid`` picks the sample grid (:func:`_interp_matrix`)."""
    S, H, W, C = frames.shape
    Ry, wy = _interp_matrix(windows[:, 1], windows[:, 3], H, out_size, compute_dtype, grid)
    Rx, wx = _interp_matrix(windows[:, 0], windows[:, 2], W, out_size, compute_dtype, grid)
    f = frames.to(compute_dtype)
    tmp = torch.bmm(Ry, f.reshape(S, H, W * C)).reshape(S, out_size, W, C)
    out = torch.einsum("spw,sowc->sopc", Rx, tmp).float()
    wmap = (wy[:, :, None] * wx[:, None, :])[..., None]
    return out + (1.0 - wmap) * pad_value[:, None, None, :]


@lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) × 255 on ``device``, copied there once: a copy from host
    memory in the per-frame loop would make the host wait for the card.
    Made outside inference mode, so the cached pair serves any caller."""
    with torch.inference_mode(False):
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32) * 255.0
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32) * 255.0
        return mean.to(device), std.to(device)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """[0,255] float pixels (..., 3) → ImageNet-normalized."""
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


def extended_crop_window(bbox: torch.Tensor, offset) -> torch.Tensor:
    """(S, 4) xywh → (S, 4) context window grown by ``offset`` (a float or an
    (S,) tensor) per side, truncated to integers."""
    x, y, w, h = bbox.unbind(-1)
    out = torch.stack([x - w * offset, y - h * offset,
                       w * (1.0 + 2 * offset), h * (1.0 + 2 * offset)], dim=-1)
    return torch.trunc(out)


def crop_bbox_in_window(bbox: torch.Tensor, window: torch.Tensor, out_size: int) -> torch.Tensor:
    """Where each (S, 4) ``bbox`` lands inside its resized crop (crop pixels)."""
    scale_x = out_size / window[:, 2]
    scale_y = out_size / window[:, 3]
    x = (bbox[:, 0] - window[:, 0]) * scale_x
    y = (bbox[:, 1] - window[:, 1]) * scale_y
    return torch.stack([x, y, bbox[:, 2] * scale_x, bbox[:, 3] * scale_y], dim=-1)
