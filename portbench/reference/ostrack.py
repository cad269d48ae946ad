"""OSTrack-256 with candidate elimination in plain PyTorch: the benchmark's
reference for the one-stream tracker (``drivers/track_onestream.py``).

Written from OSTrack's description and code (github.com/botaoye/OSTrack):
``lib/models/ostrack/vit_ce.py`` (patch embedding of both crops, their own
positions, the joint blocks, the final LayerNorm and the scatter back),
``lib/models/layers/attn_blocks.py`` (``CEBlock``: attention, then candidate
elimination, then the MLP; ``candidate_elimination``: the template centre's
attention over the search keys averaged over the heads, ``torch.sort``
descending, the first ``ceil(0.7·n)`` kept), ``lib/models/layers/attn.py``
(the full attention matrix), ``lib/models/layers/head.py``
(``CenterPredictor``, BatchNorm in eval mode), ``lib/utils/ce_utils.py``
(``CTR_POINT``) and ``lib/test/tracker/ostrack.py`` with
``processing_utils.sample_target`` and ``box_ops.clip_box`` (the window,
the Hann-windowed decode, ``map_box_back``, the clip). Batched over S
streams, float32, over a flat dict keyed as OSTrack's checkpoints are.
TF32 is off for every product (``fear.full_float32``). Nothing here
imports the program under test.

Departures, each where it is made: the crop pads and resizes in float where
``sample_target`` rounds cv2's resize to uint8 (the program and the FEAR
reference make the same choice); the CE row is indexed by the centre token
where OSTrack masks it out of the template rows (the same row); a step may
follow a given tracker's kept sets instead of its own, to judge each
transition from that tracker's state; the geometry is float64 tensors where
OSTrack uses Python floats.

``prec`` (``fear.Precision``) rounds the operands of every product, the
attention's included: float32 leaves them alone, ``fp8`` is the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import fear
from portbench.reference.tracker import normalize

# windowed responses within this of the best are near ties, which rounding may
# order either way: a box may come from any of them
NEAR_TIE = 0.03
_CTR_POINT = {7: 3, 8: 3, 12: 5, 14: 6}
BRANCHES = (("ctr", 1), ("size", 2), ("offset", 2))


class Sizes(NamedTuple):
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: int
    patch_size: int
    template_size: int
    search_size: int
    template_factor: float
    search_factor: float
    ce_loc: Sequence[int]
    ce_keep_ratio: Sequence[float]
    head_channels: int
    clip_margin: float
    ln_eps: float
    bn_eps: float

    @classmethod
    def of(cls, cfg: Dict) -> "Sizes":
        return cls(**{k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]) for k in cls._fields})

    @property
    def lens_z(self) -> int:
        return (self.template_size // self.patch_size) ** 2

    @property
    def lens_x(self) -> int:
        return (self.search_size // self.patch_size) ** 2

    @property
    def grid(self) -> int:
        return self.search_size // self.patch_size

    @property
    def ctr(self) -> int:
        n = self.template_size // self.patch_size
        return _CTR_POINT[n] * n + _CTR_POINT[n]

    @property
    def kept(self) -> List[int]:
        n, out = self.lens_x, []
        for r in self.ce_keep_ratio:
            n = math.ceil(r * n)
            out.append(n)
        return out


def shapes(sz: Sizes) -> Dict[str, Sequence[int]]:
    """The checkpoint's tensors that a step reads, by name."""
    C, p, H = sz.embed_dim, sz.patch_size, sz.mlp_ratio * sz.embed_dim
    out = {"backbone.patch_embed.proj.weight": (C, 3, p, p), "backbone.patch_embed.proj.bias": (C,),
           "backbone.pos_embed_z": (1, sz.lens_z, C), "backbone.pos_embed_x": (1, sz.lens_x, C),
           "backbone.norm.weight": (C,), "backbone.norm.bias": (C,)}
    for i in range(sz.depth):
        b = f"backbone.blocks.{i}."
        for name, shape in (("norm1", (C,)), ("norm2", (C,))):
            out[b + name + ".weight"], out[b + name + ".bias"] = shape, shape
        for name, o, n in (("attn.qkv", 3 * C, C), ("attn.proj", C, C), ("mlp.fc1", H, C), ("mlp.fc2", C, H)):
            out[b + name + ".weight"], out[b + name + ".bias"] = (o, n), (o,)
    ch = sz.head_channels
    widths = (C, ch, ch // 2, ch // 4, ch // 8)
    for br, n_out in BRANCHES:
        for i in range(4):
            h = f"box_head.conv{i + 1}_{br}."
            out[h + "0.weight"], out[h + "0.bias"] = (widths[i + 1], widths[i], 3, 3), (widths[i + 1],)
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[h + "1." + leaf] = (widths[i + 1],)
        out[f"box_head.conv5_{br}.weight"], out[f"box_head.conv5_{br}.bias"] = (n_out, ch // 8, 1, 1), (n_out,)
    return out


# -- sample_target ------------------------------------------------------------------


def window(box: torch.Tensor, factor: float):
    """``sample_target``'s square window of (S, 4) xywh boxes → (x1, y1,
    side), float64 (S,) each."""
    x, y, w, h = box.double().unbind(-1)
    side = torch.ceil(torch.sqrt(w * h) * factor)
    return torch.round(x + 0.5 * w - side * 0.5), torch.round(y + 0.5 * h - side * 0.5), side


def crop(frames: torch.Tensor, x1, y1, side, out: int) -> torch.Tensor:
    """``sample_target``'s crop in float: the window padded with zeros,
    resized on cv2's INTER_LINEAR grid (``(d + 0.5)·side/out − 0.5``,
    clamped into the window) → (S, out, out, 3) in [0, 255]. Where the
    window passes the frame's right or bottom edge, ``sample_target`` pads
    ``x2 − W + 1`` columns and keeps up to column ``W − 2``: the frame's last
    column and row read as padding."""
    S, H, W, _ = frames.shape
    d = torch.arange(out, dtype=torch.float64, device=frames.device) + 0.5

    def axis(o, n):
        src = (d[None] * (n / out)[:, None] - 0.5).clamp(min=0.0)
        src = torch.minimum(src, (n - 1)[:, None])
        i0 = torch.floor(src)
        return (o[:, None] + i0).long(), (src - i0).float()

    xi, fx = axis(x1, side)
    yi, fy = axis(y1, side)
    s = torch.arange(S, device=frames.device)[:, None, None]

    def tap(ys, xs):
        inside = ((ys >= 0) & (ys < H - 1))[:, :, None] & ((xs >= 0) & (xs < W - 1))[:, None, :]
        v = frames[s, ys.clamp(0, H - 1)[:, :, None], xs.clamp(0, W - 1)[:, None, :]].float()
        return torch.where(inside[..., None], v, torch.zeros_like(v))

    fx, fy = fx[:, None, :, None], fy[:, :, None, None]
    top = tap(yi, xi) * (1 - fx) + tap(yi, xi + 1) * fx
    bottom = tap(yi + 1, xi) * (1 - fx) + tap(yi + 1, xi + 1) * fx
    return top * (1 - fy) + bottom * fy


# -- the network ----------------------------------------------------------------------


def _ln(W, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], eps)


def _linear(W, name, x, prec):
    return F.linear(prec(x), prec(W[name + ".weight"]), W[name + ".bias"])


def patch_embed(W, sz: Sizes, crops: torch.Tensor, prec=fear.F32) -> torch.Tensor:
    """Normalized NHWC crops → (S, n, C) patch tokens (``PatchEmbed``)."""
    x = F.conv2d(prec(crops.permute(0, 3, 1, 2)), prec(W["backbone.patch_embed.proj.weight"]),
                 W["backbone.patch_embed.proj.bias"], stride=sz.patch_size)
    return x.flatten(2).transpose(1, 2)


def template(W, sz: Sizes, frames0: torch.Tensor, box0: torch.Tensor, prec=fear.F32) -> torch.Tensor:
    """``initialize``: the template crop's tokens with their positions, (S, 64, C)."""
    x1, y1, side = window(box0, sz.template_factor)
    crops = normalize(crop(frames0, x1, y1, side, sz.template_size))
    with fear.full_float32():
        return patch_embed(W, sz, crops, prec) + W["backbone.pos_embed_z"]


def _follow(index: torch.Tensor, want: torch.Tensor) -> Optional[torch.Tensor]:
    """The positions in the current search tokens (global indices ``index``,
    (S, n)) of the global indices ``want`` (S, k); None where one is absent
    or repeated."""
    eq = index[:, None, :] == want[:, :, None]
    if not bool((eq.sum(-1) == 1).all()) or not bool((eq.any(1).sum(1) == want.shape[1]).all()):
        return None
    return eq.float().argmax(-1)


class Forward(NamedTuple):
    score: torch.Tensor  # (S, n, n)
    size: torch.Tensor  # (S, 2, n, n)
    offset: torch.Tensor  # (S, 2, n, n)
    kept: List[torch.Tensor]  # the global indices kept at each CE layer, (S, k)
    ce_gap: torch.Tensor  # (S,) over the CE layers


def forward(W, sz: Sizes, z: torch.Tensor, crops: torch.Tensor, kept: Optional[List[torch.Tensor]] = None,
            prec=fear.F32) -> Forward:
    """The joint blocks with CE and the centre head on normalized search
    crops (S, 256, 256, 3) against template tokens ``z``. With ``kept`` (a
    tracker's global indices at each CE layer) each CE layer keeps those
    tokens, and ``ce_gap`` reads how far they are from this forward's own
    choice: the highest score of a dropped token less the lowest score of a
    kept one, over the range of the scores (0 for the top-k); infinite for a
    set of the wrong size, with repeats, or holding a token already gone."""
    S, C, heads, lz, eps = z.shape[0], sz.embed_dim, sz.num_heads, sz.lens_z, sz.ln_eps
    x = torch.cat([z, patch_embed(W, sz, crops, prec) + W["backbone.pos_embed_x"]], dim=1)
    index = torch.arange(sz.lens_x, device=x.device).expand(S, -1)
    ce = dict(zip(sz.ce_loc, sz.kept))
    used, gap = [], torch.zeros(S, device=x.device)
    for i in range(sz.depth):
        b = f"backbone.blocks.{i}."
        N = x.shape[1]
        qkv = _linear(W, b + "attn.qkv", _ln(W, b + "norm1", x, eps), prec)
        q, k, v = qkv.reshape(S, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        attn = ((prec(q) @ prec(k).transpose(-2, -1)) * (C // heads) ** -0.5).softmax(dim=-1)
        o = (prec(attn) @ prec(v)).transpose(1, 2).reshape(S, N, C)
        x = x + _linear(W, b + "attn.proj", o, prec)
        if i in ce:
            scores = attn[:, :, sz.ctr, lz:].mean(dim=1)  # (S, n): the centre's row, search columns
            top = torch.sort(scores, dim=1, descending=True).indices[:, :ce[i]]
            if kept is not None:
                pos = _follow(index, kept[len(used)].long()) if kept[len(used)].shape[1] == ce[i] else None
                if pos is None:
                    gap = torch.full_like(gap, float("inf"))
                else:
                    top = pos
                    mask = torch.zeros_like(scores, dtype=torch.bool).scatter_(1, top, True)
                    hi = scores.masked_fill(mask, float("-inf")).amax(1)
                    lo = scores.masked_fill(~mask, float("inf")).amin(1)
                    rng = (scores.amax(1) - scores.amin(1)).clamp(min=1e-30)
                    gap = torch.maximum(gap, ((hi - lo) / rng).clamp(min=0))
            x = torch.cat([x[:, :lz], x[:, lz:].gather(1, top[..., None].expand(-1, -1, C))], dim=1)
            index = index.gather(1, top)
            used.append(index)
        h = F.gelu(_linear(W, b + "mlp.fc1", _ln(W, b + "norm2", x, eps), prec))
        x = x + _linear(W, b + "mlp.fc2", h, prec)
    x = _ln(W, "backbone.norm", x, eps)[:, lz:]
    feats = torch.zeros((S, sz.lens_x, C), device=x.device).scatter_(1, index[..., None].expand(-1, -1, C), x)
    feats = feats.transpose(1, 2).reshape(S, C, sz.grid, sz.grid)
    maps = {}
    for br, _ in BRANCHES:
        y = feats
        for j in range(1, 5):
            h = f"box_head.conv{j}_{br}."
            y = F.conv2d(prec(y), prec(W[h + "0.weight"]), W[h + "0.bias"], padding=1)
            y = F.relu(F.batch_norm(y, W[h + "1.running_mean"], W[h + "1.running_var"], W[h + "1.weight"],
                                    W[h + "1.bias"], False, 0.0, sz.bn_eps))
        maps[br] = F.conv2d(prec(y), prec(W[f"box_head.conv5_{br}.weight"]), W[f"box_head.conv5_{br}.bias"])
    score = maps["ctr"].sigmoid().clamp(1e-4, 1 - 1e-4)[:, 0]
    return Forward(score, maps["size"].sigmoid().clamp(1e-4, 1 - 1e-4), maps["offset"], used, gap)


# -- the tracker's step ---------------------------------------------------------------


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    w = 0.5 * (1 - torch.cos((2 * math.pi / (n + 1)) * k))
    return w[:, None] * w[None, :]


def clip_box(x1, y1, w, h, H: int, W: int, m: float) -> torch.Tensor:
    x2, y2 = x1 + w, y1 + h
    x1, y1 = x1.clamp(0, W - m), y1.clamp(0, H - m)
    x2, y2 = x2.clamp(m, W), y2.clamp(m, H)
    return torch.stack([x1, y1, (x2 - x1).clamp(min=m), (y2 - y1).clamp(min=m)], dim=-1)


class Judged(NamedTuple):
    score: torch.Tensor  # (S, cells) unwindowed scores
    response: torch.Tensor  # (S, cells) the Hann-windowed scores
    boxes: torch.Tensor  # (S, cells, 4) the frame box each cell decodes to, float64
    top_box: torch.Tensor  # (S, 4) the box of the first best response
    top_conf: torch.Tensor  # (S,) the score there
    side: torch.Tensor  # (S,) the search window's side
    kept: List[torch.Tensor]
    ce_gap: torch.Tensor  # (S,)


def step(W, sz: Sizes, z: torch.Tensor, frames: torch.Tensor, prev: torch.Tensor,
         kept: Optional[List[torch.Tensor]] = None, prec=fear.F32) -> Judged:
    """One frame of every stream around the previous boxes ``prev``, with
    TF32 off."""
    S, H, Wd = frames.shape[0], frames.shape[1], frames.shape[2]
    x1, y1, side = window(prev, sz.search_factor)
    with fear.full_float32():
        f = forward(W, sz, z, normalize(crop(frames, x1, y1, side, sz.search_size)), kept, prec)
    n = sz.grid
    score = f.score.reshape(S, n * n)
    response = (hann(n, frames.device) * f.score).reshape(S, n * n)
    cells = torch.arange(n * n, device=frames.device)
    cx = ((cells % n).double()[None] + f.offset[:, 0].reshape(S, -1).double()) / n * side[:, None]
    cy = ((cells // n).double()[None] + f.offset[:, 1].reshape(S, -1).double()) / n * side[:, None]
    w = f.size[:, 0].reshape(S, -1).double() * side[:, None]
    h = f.size[:, 1].reshape(S, -1).double() * side[:, None]
    px, py, pw, ph = prev.double().unbind(-1)
    cx = cx + (px + 0.5 * pw - 0.5 * side)[:, None]
    cy = cy + (py + 0.5 * ph - 0.5 * side)[:, None]
    boxes = clip_box(cx - 0.5 * w, cy - 0.5 * h, w, h, H, Wd, sz.clip_margin)
    arg = response.argmax(dim=1)
    rows = torch.arange(S, device=frames.device)
    return Judged(score, response, boxes, boxes[rows, arg], score[rows, arg], side, f.kept, f.ce_gap)


def gaps(j: Judged, box: torch.Tensor, conf: torch.Tensor, search_size: int) -> Dict[str, torch.Tensor]:
    """Per stream: ``box_px``, the L∞ distance from the reported box to the
    nearest box of a cell whose windowed response lies within ``NEAR_TIE``
    of the best (in pixels of the search crop where the window is wider than
    the crop, else of the frame); ``conf_gap``, the nearest such cell's score
    to the reported confidence."""
    near = j.response >= (j.response.amax(dim=1) - NEAR_TIE)[:, None]
    scale = torch.clamp(j.side / search_size, min=1.0)[:, None]
    dist = ((j.boxes - box.double()[:, None, :]).abs().amax(dim=-1) / scale).float()
    inf = torch.full_like(dist, float("inf"))
    cdist = (j.score - conf.float()[:, None]).abs()
    return {"box_px": torch.where(near, dist, inf).amin(dim=1), "conf_gap": torch.where(near, cdist, inf).amin(dim=1)}
