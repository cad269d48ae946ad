"""OSTrack's crop window and centre decode (``lib/test/tracker/ostrack.py``,
``lib/train/data/processing_utils.py:sample_target``,
``lib/utils/box_ops.py:clip_box``, ``lib/test/utils/hann.py``), batched over
streams on the tracker's device.

OSTrack computes its geometry in Python floats; here it runs in float64 on
the device, from the float32 box the tracker carries, and the new box is
rounded to float32 once, as the state stores it. Nothing waits for the host.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import torch


def square_window(bbox: torch.Tensor, factor: float) -> torch.Tensor:
    """``sample_target``'s window: (S, 4) xywh → (S, 4) float32
    ``[x1, y1, side, side]`` with ``side = ceil(sqrt(w·h)·factor)`` and
    ``x1 = round(x + 0.5·w − side·0.5)`` (round half to even, as Python's
    ``round``), in float64."""
    x, y, w, h = bbox.double().unbind(-1)
    side = torch.ceil(torch.sqrt(w * h) * factor)
    x1 = torch.round(x + 0.5 * w - side * 0.5)
    y1 = torch.round(y + 0.5 * h - side * 0.5)
    return torch.stack([x1, y1, side, side], dim=-1).float()


def sample_frames(frames: torch.Tensor) -> torch.Tensor:
    """The frames as ``sample_target`` reads them: (S, H, W, 3) → a view
    without the last row and column. Where the window passes the frame's
    right edge, ``sample_target`` pads ``x2 − W + 1`` columns and crops up to
    column ``W − 2``, so column ``W − 1`` reads the pad colour (and the last
    row likewise); it is read nowhere else."""
    return frames[:, :-1, :-1]


@lru_cache(maxsize=8)
def hann2d(n: int, device: torch.device) -> torch.Tensor:
    """``hann2d((n, n), centered=True)``: the outer product of
    ``0.5·(1 − cos(2πk/(n+1)))``, k = 1..n, float32 (n, n) on ``device``,
    copied there once (a copy from host memory inside a step would wait for
    the card, and is illegal in a graph capture). Made outside inference
    mode, so the cached window serves any caller."""
    with torch.inference_mode(False):
        k = torch.arange(1, n + 1, dtype=torch.float32)
        w = 0.5 * (1 - torch.cos((2 * math.pi / (n + 1)) * k))
        return (w[:, None] * w[None, :]).to(device)


def centre_decode(score: torch.Tensor, size: torch.Tensor, offset: torch.Tensor, window: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cal_bbox`` on the Hann-windowed response: score (S, n, n), size and
    offset (S, 2, n, n), the (n, n) window → (the box in the search crop as
    ``(cx, cy, w, h)`` over the crop's side, (S, 4) float32; the unwindowed
    score at the chosen cell, (S,))."""
    S, n = score.shape[0], score.shape[-1]
    idx = (window * score).reshape(S, n * n).argmax(dim=1)
    at = idx[:, None, None].expand(S, 2, 1)
    sz = size.reshape(S, 2, n * n).gather(2, at)[..., 0]
    off = offset.reshape(S, 2, n * n).gather(2, at)[..., 0]
    cx = ((idx % n).float() + off[:, 0]) / n
    cy = (torch.div(idx, n, rounding_mode="floor").float() + off[:, 1]) / n
    conf = score.reshape(S, n * n).gather(1, idx[:, None])[:, 0]
    return torch.stack([cx, cy, sz[:, 0], sz[:, 1]], dim=-1), conf


def map_box_back(pred: torch.Tensor, prev: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """``map_box_back``: the crop box (cx, cy, w, h over the side) → frame
    xywh around the previous box's centre, float64. ``pred · search_size /
    resize_factor`` is ``pred · side``."""
    p = pred.double() * side.double()[:, None]
    px, py, pw, ph = prev.double().unbind(-1)
    half = 0.5 * side.double()
    cx = p[:, 0] + (px + 0.5 * pw - half)
    cy = p[:, 1] + (py + 0.5 * ph - half)
    return torch.stack([cx - 0.5 * p[:, 2], cy - 0.5 * p[:, 3], p[:, 2], p[:, 3]], dim=-1)


def clip_box(box: torch.Tensor, H: int, W: int, margin: float) -> torch.Tensor:
    """``clip_box(box, H, W, margin)`` on (S, 4) xywh, in the box's dtype."""
    x1, y1, w, h = box.unbind(-1)
    x2, y2 = x1 + w, y1 + h
    x1 = x1.clamp(min=0).clamp(max=W - margin)
    x2 = x2.clamp(min=margin).clamp(max=W)
    y1 = y1.clamp(min=0).clamp(max=H - margin)
    y2 = y2.clamp(min=margin).clamp(max=H)
    return torch.stack([x1, y1, (x2 - x1).clamp(min=margin), (y2 - y1).clamp(min=margin)], dim=-1)
