"""The tracking step in plain PyTorch, the benchmark's judge of the
tracker's boxes: crop and normalise, trunk, neck, head (``fear.py``), the
decode of the score map into frame boxes, and the dual template's
feature-gated refresh.

A tracker carries its boxes from frame to frame, so the reference follows
the trajectory that the program reports: at each frame it crops around the
program's previous box and judges the program's new box and confidence
against its own score map. Every formula is written out from the tracker's
description (SiamFC-style context windows truncated to integers, cv2's
INTER_LINEAR sample grid clamped into the window, ImageNet normalisation,
the FEAR box coder on a 16x16 grid of stride 16).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from portbench.reference import fear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MIN_SIDE = 3.0
# sigmoid scores within this of the best are near ties, which rounding may
# order either way: a box may come from any of them. The program's widest
# box gap reads the same with any band from 0.03 to 0.12, and a wider band
# lets a lower precision's boxes pass as ties
NEAR_TIE = 0.03


class Geometry(NamedTuple):
    template_size: int = 128
    instance_size: int = 256
    score_size: int = 16
    total_stride: int = 16
    template_offset: float = 0.2
    search_context: float = 2.0
    confidence_threshold: float = 0.7


def context_window(box: torch.Tensor, offset) -> torch.Tensor:
    """(S, 4) xywh → the window grown by ``offset`` of each side, truncated."""
    x, y, w, h = box.unbind(-1)
    return torch.trunc(torch.stack([x - w * offset, y - h * offset, w * (1 + 2 * offset), h * (1 + 2 * offset)], -1))


def crop(frames: torch.Tensor, windows: torch.Tensor, out: int, pad: torch.Tensor) -> torch.Tensor:
    """Bilinear ``out``² crops of uint8 frames (S, H, W, 3): sample
    ``(d + 0.5)·size/out − 0.5`` from the window's origin, clamped into the
    window; a sample outside the frame reads the stream's pad colour."""
    S, H, W, _ = frames.shape
    d = (torch.arange(out, dtype=torch.float32, device=frames.device) + 0.5) / out

    def grid(o, n):
        src = o[:, None] + d[None] * n[:, None] - 0.5
        return torch.minimum(torch.maximum(src, o[:, None]), (o + n - 1.0)[:, None])

    sx, sy = grid(windows[:, 0], windows[:, 2]), grid(windows[:, 1], windows[:, 3])
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[:, None, :, None], (sy - y0)[:, :, None, None]
    x0, y0 = x0.long(), y0.long()
    s = torch.arange(S, device=frames.device)[:, None, None]

    def tap(yi, xi):
        inside = ((yi >= 0) & (yi < H))[:, :, None] & ((xi >= 0) & (xi < W))[:, None, :]
        v = frames[s, yi.clamp(0, H - 1)[:, :, None], xi.clamp(0, W - 1)[:, None, :]].float()
        return torch.where(inside[..., None], v, pad[:, None, None, :])

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=x.device) * 255.0
    return (x - mean) / std


def clamp_box(box: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Clip xywh into the frame (truncating), then give each side at least
    ``MIN_SIDE`` pixels, moved back inside where it would leave."""
    x1 = box[:, 0].clamp(0, W)
    y1 = box[:, 1].clamp(0, H)
    x2 = (x1 + box[:, 2]).clamp(0, W)
    y2 = (y1 + box[:, 3]).clamp(0, H)
    x, y, w, h = torch.trunc(torch.stack([x1, y1, x2 - x1, y2 - y1], -1)).unbind(-1)
    small_w, small_h = w < MIN_SIDE, h < MIN_SIDE
    x = torch.where(small_w, x - torch.clamp(x + MIN_SIDE - W, min=0.0), x)
    w = torch.where(small_w, torch.full_like(w, MIN_SIDE), w)
    y = torch.where(small_h, y - torch.clamp(y + MIN_SIDE - H, min=0.0), y)
    h = torch.where(small_h, torch.full_like(h, MIN_SIDE), h)
    return torch.stack([x, y, w, h], -1)


def cell_boxes(reg: torch.Tensor, windows: torch.Tensor, geo: Geometry, H: int, W: int) -> torch.Tensor:
    """The frame box that each score cell decodes to: (S, cells, 4). A
    cell's LTRB offsets around its grid point give a box in the search crop,
    mapped into the frame by the window's scale with round-half-even and
    clamped."""
    n = geo.score_size
    idx = (torch.arange(n, dtype=torch.float32, device=reg.device) - float(n // 2)) * geo.total_stride
    gy, gx = torch.meshgrid(idx + geo.instance_size // 2, idx + geo.instance_size // 2, indexing="ij")
    r = reg.reshape(reg.shape[0], n * n, 4)
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
    x1, y1 = gx - r[..., 0], gy - r[..., 1]
    w, h = (gx + r[..., 2]) - x1, (gy + r[..., 3]) - y1
    ws = (windows[:, 2] / geo.instance_size)[:, None]
    hs = (windows[:, 3] / geo.instance_size)[:, None]
    fx = torch.round(x1 * ws + windows[:, 0:1])
    fy = torch.round(y1 * hs + windows[:, 1:2])
    fw = torch.clamp(torch.round(w * ws), min=MIN_SIDE)
    fh = torch.clamp(torch.round(h * hs), min=MIN_SIDE)
    S = reg.shape[0]
    boxes = torch.stack([fx, fy, fw, fh], -1).reshape(S * n * n, 4)
    return clamp_box(boxes, H, W).reshape(S, n * n, 4)


class Template(NamedTuple):
    feats: torch.Tensor  # (S, 8, 8, 256)
    mean_color: torch.Tensor  # (S, 3)
    box: torch.Tensor  # (S, 4) the init box, clamped


def template(W, trunk, frames0: torch.Tensor, boxes: torch.Tensor, geo: Geometry,
             prec: fear.Precision = fear.F32) -> Template:
    H, Wd = frames0.shape[1:3]
    box = clamp_box(boxes.float(), H, Wd)
    mean_color = frames0.float().mean(dim=(1, 2))
    return Template(encode(W, trunk, frames0, box, mean_color, geo, prec), mean_color, box)


def encode(W, trunk, frames, box, mean_color, geo: Geometry, prec=fear.F32) -> torch.Tensor:
    """Template features of the crop around ``box``."""
    win = context_window(box, geo.template_offset)
    return fear.features(W, trunk, normalize(crop(frames, win, geo.template_size, mean_color)), prec=prec)


class Judged(NamedTuple):
    score: torch.Tensor  # (S, cells) sigmoid scores
    boxes: torch.Tensor  # (S, cells, 4) the frame box of each cell
    top: torch.Tensor  # (S,) the best score
    top_box: torch.Tensor  # (S, 4) the box of the first best cell
    apce: torch.Tensor  # (S,)
    window: torch.Tensor  # (S, 4) the search window the frame was cropped from


def step(W, trunk, towernum, tmpl: Template, frames, prev_box, context, geo: Geometry,
         update: Optional[torch.Tensor] = None, prec: fear.Precision = fear.F32) -> Judged:
    """One frame for every stream, around ``prev_box`` at ``context`` (a
    float, or (S,) per stream)."""
    H, Wd = frames.shape[1:3]
    win = context_window(prev_box, context)
    search = fear.features(W, trunk, normalize(crop(frames, win, geo.instance_size, tmpl.mean_color)), prec=prec)
    reg, cls = fear.head(W, towernum, search, tmpl.feats, update, prec=prec)
    score = torch.sigmoid(cls[..., 0]).reshape(cls.shape[0], -1)
    boxes = cell_boxes(reg, win, geo, H, Wd)
    top, arg = score.max(dim=1)
    smin = score.amin(dim=1)
    apce = (top - smin) ** 2 / (((score - smin[:, None]) ** 2).mean(dim=1) + 1e-12)
    top_box = boxes[torch.arange(boxes.shape[0], device=boxes.device), arg]
    return Judged(score, boxes, top, top_box, apce, win)


def gaps(j: Judged, box: torch.Tensor, conf: torch.Tensor, instance_size: int = 256) -> Dict[str, torch.Tensor]:
    """Per stream: ``conf_gap``, how far the reported confidence lies from the
    reference's best score; ``box_px``, the L-inf distance from the reported
    box to the nearest box of a cell that scores within ``NEAR_TIE`` of the
    best (a near tie may pick either cell). The distance is in frame pixels
    over the window's scale where the window is larger than the search crop
    (pixels of the crop, so that a stream whose window spans the frame weighs
    no more than one that spans its object), in frame pixels where it is
    smaller (a box rounds to whole frame pixels)."""
    near = j.score >= (j.top - NEAR_TIE)[:, None]
    scale = torch.clamp(j.window[:, 2:] / instance_size, min=1.0).repeat(1, 2)[:, None, :]  # x, y, w, h
    dist = ((j.boxes - box[:, None, :]).abs() / scale).amax(dim=-1)
    dist = torch.where(near, dist, torch.full_like(dist, float("inf")))
    return {"conf_gap": (conf - j.top).abs(), "box_px": dist.amin(dim=1)}


def _cosine(a, b):
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-8)


def gate_rate(G: Dict[str, torch.Tensor], j: Judged, cand, static, dyn, box, prev_box) -> torch.Tensor:
    """The feature gate's update probability from the frame's observables:
    confidence, log1p(APCE)/4, the candidate's cosine to the static and the
    dynamic template, half the log area ratio (clipped to ±1) and the centre
    shift over the previous side (clipped to 2), through a tanh MLP."""
    area = torch.clamp(box[:, 2] * box[:, 3], min=1.0)
    prev_area = torch.clamp(prev_box[:, 2] * prev_box[:, 3], min=1.0)
    ratio = torch.clamp(0.5 * torch.log(area / prev_area), -1.0, 1.0)
    shift = (box[:, :2] + box[:, 2:] * 0.5) - (prev_box[:, :2] + prev_box[:, 2:] * 0.5)
    shift = torch.clamp(shift.norm(dim=-1) / torch.sqrt(prev_area), 0.0, 2.0)
    obs = torch.stack([j.top, torch.log1p(j.apce) / 4.0, _cosine(cand, static), _cosine(cand, dyn), ratio, shift], -1)
    h = torch.tanh(obs @ G["w1"] + G["b1"])
    return torch.sigmoid((h @ G["w2"] + G["b2"])[:, 0])
