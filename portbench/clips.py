"""The benchmark's traffic generator: seeded synthetic videos, made on the device in a few large calls.

Every stream gets its own clip: a smooth random background with fine grain,
and a textured rectangle that moves on a closed Lissajous path, so that a
clip of ``period`` frames can be replayed in a loop without a jump. The
path moves the object by at most ``max_step`` pixels a frame on each axis.
The seed changes the pixels, the sizes and the paths, never the shapes of
the work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Clips(NamedTuple):
    frames: torch.Tensor  # (period, S, H, W, 3) uint8
    boxes: torch.Tensor  # (period, S, 4) xywh float32, the object's true box


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))


def make_clips(S: int, period: int, frame_hw, seed: int, device, max_step: float = 8.0,
               obj_side=(40, 96)) -> Clips:
    H, W = frame_hw
    g = generator(seed, device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    coarse = F.interpolate(rand(S, 3, max(H // 16, 2), max(W // 16, 2)), size=(H, W), mode="bilinear",
                           align_corners=False)
    background = (coarse * 190.0 + rand(S, 3, H, W) * 60.0).permute(0, 2, 3, 1)  # (S, H, W, 3)
    lo, hi = obj_side
    side = min(hi, H // 3, W // 3)
    ow = torch.floor(lo + (min(hi, side) - lo) * rand(S)).clamp(min=8)
    oh = torch.floor(lo + (min(hi, side) - lo) * rand(S)).clamp(min=8)
    texture = F.interpolate(rand(S, 3, 6, 6), size=(side, side), mode="nearest") * 255.0
    texture = texture.permute(0, 2, 3, 1)  # (S, side, side, 3)
    # a closed path: x moves once round, y twice, each within max_step a frame
    w_ = 2.0 * math.pi / period
    ax = torch.minimum((W - ow) / 2 - 4, torch.tensor(0.9 * max_step / w_, device=device)) * (0.5 + 0.5 * rand(S))
    ay = torch.minimum((H - oh) / 2 - 4, torch.tensor(0.9 * max_step / (2 * w_), device=device)) * (0.5 + 0.5 * rand(S))
    cx = W / 2 + (W / 2 - ow / 2 - ax - 2).clamp(min=0) * (2 * rand(S) - 1)
    cy = H / 2 + (H / 2 - oh / 2 - ay - 2).clamp(min=0) * (2 * rand(S) - 1)
    phase = 2 * math.pi * rand(S, 2)
    t = torch.arange(period, dtype=torch.float32, device=device)[:, None]
    x0 = torch.round(cx + ax * torch.sin(w_ * t + phase[:, 0]) - ow / 2)  # (period, S)
    y0 = torch.round(cy + ay * torch.sin(2 * w_ * t + phase[:, 1]) - oh / 2)

    ys = torch.arange(H, device=device)[None, :, None]
    xs = torch.arange(W, device=device)[None, None, :]
    s_idx = torch.arange(S, device=device)[:, None, None]
    frames = torch.empty((period, S, H, W, 3), dtype=torch.uint8, device=device)
    for f in range(period):
        dy = ys - y0[f].long()[:, None, None]
        dx = xs - x0[f].long()[:, None, None]
        inside = (dy >= 0) & (dy < oh[:, None, None]) & (dx >= 0) & (dx < ow[:, None, None])
        obj = texture[s_idx, dy.clamp(0, side - 1), dx.clamp(0, side - 1)]
        frames[f] = torch.where(inside[..., None], obj, background).clamp(0, 255).to(torch.uint8)
    boxes = torch.stack([x0, y0, ow.expand_as(x0), oh.expand_as(y0)], dim=-1)
    return Clips(frames, boxes.float())
