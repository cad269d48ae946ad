"""OSTrack-256 with candidate elimination in plain float32 PyTorch: the
tier-1 tests' reference for ``feartracker_tpu_torch/models/ostrack.py`` and
OSTrack's path through ``ScanTracker``.

Transcribed from github.com/botaoye/OSTrack, function for function:
``lib/models/ostrack/vit_ce.py`` (``forward_features``),
``lib/models/layers/attn_blocks.py`` (``CEBlock``, ``candidate_elimination``),
``lib/models/layers/attn.py`` (``Attention``, the full attention matrix),
``lib/models/layers/head.py`` (``CenterPredictor``),
``lib/utils/ce_utils.py`` (``generate_mask_cond``, ``CTR_POINT``),
``lib/train/data/processing_utils.py`` (``sample_target``),
``lib/test/utils/hann.py`` and ``lib/test/tracker/ostrack.py``
(``track``, ``map_box_back``) with ``lib/utils/box_ops.py`` (``clip_box``).
Weights are a flat dict keyed as OSTrack's checkpoints are. Nothing here
imports the port.

Departures, each written where it is made:

* the crop: ``sample_target`` resizes with ``cv2.resize`` into uint8;
  :func:`sample_target_float` pads the same window with the same zeros and
  resizes with cv2's INTER_LINEAR sample grid in float, unrounded (the
  port's crop kernel and the FEAR reference make the same choice).
  :func:`sample_target` is the cv2 transcription, for the geometry tests;
* ``forward_features`` also returns the global indices kept at each CE
  layer (OSTrack keeps only the removed ones) and each CE layer's scores,
  which the tests compare; given ``follow`` (a tracker's kept indices at
  each CE layer) it keeps those tokens instead of its own top-k, so that a
  lower-precision tracker's later layers are judged from its own state;
* the tracker takes its previous box as an argument, so that it can follow
  another tracker's trajectory.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class Sizes(NamedTuple):
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    template_size: int = 128
    search_size: int = 256
    template_factor: float = 2.0
    search_factor: float = 4.0
    ce_loc: Sequence[int] = (3, 6, 9)
    ce_keep_ratio: Sequence[float] = (0.7, 0.7, 0.7)
    clip_margin: int = 10


# -- lib/train/data/processing_utils.py ---------------------------------------


def sample_target(im: np.ndarray, target_bb, search_area_factor: float, output_sz: int):
    """``sample_target`` line by line (no mask) → (crop uint8, resize_factor,
    (x1, y1, crop_sz))."""
    import cv2

    x, y, w, h = [float(v) for v in target_bb]
    crop_sz = math.ceil(math.sqrt(w * h) * search_area_factor)
    if crop_sz < 1:
        raise Exception("Too small bounding box.")
    x1 = round(x + 0.5 * w - crop_sz * 0.5)
    x2 = x1 + crop_sz
    y1 = round(y + 0.5 * h - crop_sz * 0.5)
    y2 = y1 + crop_sz
    x1_pad = max(0, -x1)
    x2_pad = max(x2 - im.shape[1] + 1, 0)
    y1_pad = max(0, -y1)
    y2_pad = max(y2 - im.shape[0] + 1, 0)
    im_crop = im[y1 + y1_pad:y2 - y2_pad, x1 + x1_pad:x2 - x2_pad, :]
    im_crop_padded = cv2.copyMakeBorder(im_crop, y1_pad, y2_pad, x1_pad, x2_pad, cv2.BORDER_CONSTANT)
    resize_factor = output_sz / crop_sz
    im_crop_padded = cv2.resize(im_crop_padded, (output_sz, output_sz))
    return im_crop_padded, resize_factor, (x1, y1, crop_sz)


def _resize_float(img: torch.Tensor, out: int) -> torch.Tensor:
    """cv2's INTER_LINEAR sample grid in float: ``(d + 0.5)·n/out − 0.5``,
    clamped into the image, its two taps a side; (n, n, 3) → (out, out, 3)."""
    n = img.shape[0]
    d = (torch.arange(out, dtype=torch.float64) + 0.5) * (n / out) - 0.5
    src = d.clamp(0, n - 1).float()
    i0 = torch.floor(src).long()
    f = src - i0
    i1 = (i0 + 1).clamp(max=n - 1)
    rows = img[i0] * (1 - f)[:, None, None] + img[i1] * f[:, None, None]
    return rows[:, i0] * (1 - f)[None, :, None] + rows[:, i1] * f[None, :, None]


def sample_target_float(im: torch.Tensor, target_bb, search_area_factor: float, output_sz: int):
    """``sample_target``'s window, crop and zero padding, resized in float
    (the departure above) → (crop float32 (out, out, 3) in [0, 255], crop_sz)."""
    x, y, w, h = [float(v) for v in target_bb]
    crop_sz = math.ceil(math.sqrt(w * h) * search_area_factor)
    x1 = round(x + 0.5 * w - crop_sz * 0.5)
    x2 = x1 + crop_sz
    y1 = round(y + 0.5 * h - crop_sz * 0.5)
    y2 = y1 + crop_sz
    x1_pad = max(0, -x1)
    x2_pad = max(x2 - im.shape[1] + 1, 0)
    y1_pad = max(0, -y1)
    y2_pad = max(y2 - im.shape[0] + 1, 0)
    im_crop = im[y1 + y1_pad:y2 - y2_pad, x1 + x1_pad:x2 - x2_pad, :].float()
    padded = torch.zeros((crop_sz, crop_sz, 3))
    padded[y1_pad:crop_sz - y2_pad, x1_pad:crop_sz - x2_pad] = im_crop
    return _resize_float(padded, output_sz), crop_sz


def normalize(crop: torch.Tensor) -> torch.Tensor:
    """``Preprocessor.process``: (out, out, 3) [0, 255] → (1, 3, out, out)."""
    t = crop.permute(2, 0, 1)[None] / 255.0
    return (t - torch.tensor(MEAN).view(1, 3, 1, 1)) / torch.tensor(STD).view(1, 3, 1, 1)


# -- the network ------------------------------------------------------------------


def patch_embed(W: Dict, x: torch.Tensor, p: int) -> torch.Tensor:
    x = F.conv2d(x, W["backbone.patch_embed.proj.weight"], W["backbone.patch_embed.proj.bias"], stride=p)
    return x.flatten(2).transpose(1, 2)


def _ln(W: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], 1e-6)


def attention(W: Dict, pre: str, x: torch.Tensor, num_heads: int):
    """``Attention.forward(x, mask=None, return_attention=True)``."""
    B, N, C = x.shape
    qkv = F.linear(x, W[pre + "qkv.weight"], W[pre + "qkv.bias"])
    qkv = qkv.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q @ k.transpose(-2, -1)) * (C // num_heads) ** -0.5
    attn = attn.softmax(dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(B, N, C)
    return F.linear(x, W[pre + "proj.weight"], W[pre + "proj.bias"]), attn


def candidate_elimination(attn, tokens, lens_t, keep_ratio, global_index, box_mask_z, follow=None):
    """``candidate_elimination`` as OSTrack writes it; ``follow`` (B, k)
    global indices replace the sort's top-k, and the scores that ranked the
    tokens come back fourth (the departures above)."""
    lens_s = attn.shape[-1] - lens_t
    bs, hn, _, _ = attn.shape
    lens_keep = math.ceil(keep_ratio * lens_s)
    if lens_keep == lens_s:
        return tokens, global_index, None, None
    attn_t = attn[:, :, :lens_t, lens_t:]
    if box_mask_z is not None:
        box_mask_z = box_mask_z.unsqueeze(1).unsqueeze(-1).expand(-1, attn_t.shape[1], -1, attn_t.shape[-1])
        attn_t = attn_t[box_mask_z]
        attn_t = attn_t.view(bs, hn, -1, lens_s)
        attn_t = attn_t.mean(dim=2).mean(dim=1)
    else:
        attn_t = attn_t.mean(dim=2).mean(dim=1)
    sorted_attn, indices = torch.sort(attn_t, dim=1, descending=True)
    if follow is not None:
        at = (global_index[:, None, :] == follow[:, :, None].to(global_index.dtype)).float().argmax(-1)
        rest = torch.ones_like(attn_t, dtype=torch.bool).scatter_(1, at, False)
        indices = torch.cat([at, torch.nonzero(rest)[:, 1].view(bs, -1)], dim=1)
    topk_idx = indices[:, :lens_keep]
    non_topk_idx = indices[:, lens_keep:]
    keep_index = global_index.gather(dim=1, index=topk_idx)
    removed_index = global_index.gather(dim=1, index=non_topk_idx)
    tokens_t = tokens[:, :lens_t]
    tokens_s = tokens[:, lens_t:]
    B, L, C = tokens_s.shape
    attentive_tokens = tokens_s.gather(dim=1, index=topk_idx.unsqueeze(-1).expand(B, -1, C))
    tokens_new = torch.cat([tokens_t, attentive_tokens], dim=1)
    return tokens_new, keep_index, removed_index, attn_t


def ce_block(W: Dict, i: int, x, global_index_template, global_index_search, num_heads, keep_ratio_search,
             ce_template_mask, follow=None):
    """``CEBlock.forward`` (no drop path), and CE's scores."""
    pre = f"backbone.blocks.{i}."
    x_attn, attn = attention(W, pre + "attn.", _ln(W, pre + "norm1", x), num_heads)
    x = x + x_attn
    lens_t = global_index_template.shape[1]
    removed_index_search = scores = None
    if keep_ratio_search < 1:
        x, global_index_search, removed_index_search, scores = candidate_elimination(
            attn, x, lens_t, keep_ratio_search, global_index_search, ce_template_mask, follow)
    h = F.gelu(F.linear(_ln(W, pre + "norm2", x), W[pre + "mlp.fc1.weight"], W[pre + "mlp.fc1.bias"]))
    x = x + F.linear(h, W[pre + "mlp.fc2.weight"], W[pre + "mlp.fc2.bias"])
    return x, global_index_template, global_index_search, removed_index_search, attn, scores


def generate_mask_cond(sz: Sizes, bs: int) -> torch.Tensor:
    """``generate_mask_cond`` with ``CE_TEMPLATE_RANGE: CTR_POINT``."""
    n = sz.template_size // sz.patch_size
    index = {8: slice(3, 4), 12: slice(5, 6), 7: slice(3, 4), 14: slice(6, 7)}[n]
    box_mask_z = torch.zeros([bs, n, n])
    box_mask_z[:, index, index] = 1
    return box_mask_z.flatten(1).to(torch.bool)


def forward_features(W: Dict, sz: Sizes, z: torch.Tensor, x: torch.Tensor, ce_template_mask, follow=None):
    """``VisionTransformerCE.forward_features`` → (tokens, the attention
    matrix of the last block, the removed indices by CE layer, and the
    kept ones and the scores that ranked them, which OSTrack does not
    return)."""
    B = x.shape[0]
    x = patch_embed(W, x, sz.patch_size)
    z = patch_embed(W, z, sz.patch_size)
    z = z + W["backbone.pos_embed_z"]
    x = x + W["backbone.pos_embed_x"]
    x = torch.cat((z, x), dim=1)
    lens_z, lens_x = W["backbone.pos_embed_z"].shape[1], W["backbone.pos_embed_x"].shape[1]
    global_index_t = torch.linspace(0, lens_z - 1, lens_z).repeat(B, 1)
    global_index_s = torch.linspace(0, lens_x - 1, lens_x).repeat(B, 1)
    removed_indexes_s: List[torch.Tensor] = []
    kept: List[torch.Tensor] = []
    scores: List[torch.Tensor] = []
    ratios = dict(zip(sz.ce_loc, sz.ce_keep_ratio))
    for i in range(sz.depth):
        x, global_index_t, global_index_s, removed_index_s, attn, scores_i = ce_block(
            W, i, x, global_index_t, global_index_s, sz.num_heads, ratios.get(i, 1.0), ce_template_mask,
            None if follow is None or i not in ratios else follow[len(kept)])
        if i in ratios:
            removed_indexes_s.append(removed_index_s)
            kept.append(global_index_s)
            scores.append(scores_i)
    x = _ln(W, "backbone.norm", x)
    lens_x_new = global_index_s.shape[1]
    lens_z_new = global_index_t.shape[1]
    z = x[:, :lens_z_new]
    x = x[:, lens_z_new:]
    if removed_indexes_s and removed_indexes_s[0] is not None:
        removed_indexes_cat = torch.cat(removed_indexes_s, dim=1)
        pruned_lens_x = lens_x - lens_x_new
        pad_x = torch.zeros([B, pruned_lens_x, x.shape[2]])
        x = torch.cat([x, pad_x], dim=1)
        index_all = torch.cat([global_index_s, removed_indexes_cat], dim=1)
        C = x.shape[-1]
        x = torch.zeros_like(x).scatter_(dim=1, index=index_all.unsqueeze(-1).expand(B, -1, C).to(torch.int64), src=x)
    x = torch.cat([z, x], dim=1)
    return x, attn, removed_indexes_s, kept, scores


def _bn(W: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    rm, rv = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    return F.batch_norm(x, rm, rv, W[f"{name}.weight"], W[f"{name}.bias"], False, 0.0, 1e-5)


def get_score_map(W: Dict, x: torch.Tensor):
    """``CenterPredictor.get_score_map``: (B, C, n, n) → (score, size, offset)."""
    def branch(b):
        y = x
        for i in range(1, 5):
            name = f"box_head.conv{i}_{b}"
            y = F.relu(_bn(W, f"{name}.1", F.conv2d(y, W[f"{name}.0.weight"], W[f"{name}.0.bias"], padding=1)))
        return F.conv2d(y, W[f"box_head.conv5_{b}.weight"], W[f"box_head.conv5_{b}.bias"])

    def _sigmoid(t):
        return torch.clamp(t.sigmoid(), min=1e-4, max=1 - 1e-4)

    return _sigmoid(branch("ctr")), _sigmoid(branch("size")), branch("offset")


def cal_bbox(score_map_ctr, size_map, offset_map, feat_sz: int):
    """``CenterPredictor.cal_bbox(..., return_score=True)``."""
    max_score, idx = torch.max(score_map_ctr.flatten(1), dim=1, keepdim=True)
    idx_y = torch.div(idx, feat_sz, rounding_mode="floor")
    idx_x = idx % feat_sz
    idx = idx.unsqueeze(1).expand(idx.shape[0], 2, 1)
    size = size_map.flatten(2).gather(dim=2, index=idx)
    offset = offset_map.flatten(2).gather(dim=2, index=idx).squeeze(-1)
    bbox = torch.cat([(idx_x.to(torch.float) + offset[:, :1]) / feat_sz,
                      (idx_y.to(torch.float) + offset[:, 1:]) / feat_sz, size.squeeze(-1)], dim=1)
    return bbox, max_score


def ostrack_forward(W: Dict, sz: Sizes, template: torch.Tensor, search: torch.Tensor, follow=None):
    """``OSTrack.forward`` with the centre head → its ``out`` dict, plus
    ``kept`` (the global indices kept at each CE layer, int64) and
    ``scores`` (each CE layer's ranking scores of the search tokens then
    present)."""
    B = search.shape[0]
    x, attn, removed, kept, scores = forward_features(W, sz, template, search, generate_mask_cond(sz, B), follow)
    feat_len_s = (sz.search_size // sz.patch_size) ** 2
    n = sz.search_size // sz.patch_size
    enc_opt = x[:, -feat_len_s:]
    opt = enc_opt.unsqueeze(-1).permute((0, 3, 2, 1)).contiguous()
    bs, Nq, C, HW = opt.size()
    opt_feat = opt.view(-1, C, n, n)
    score_map_ctr, size_map, offset_map = get_score_map(W, opt_feat)
    return {"score_map": score_map_ctr, "size_map": size_map, "offset_map": offset_map, "attn": attn,
            "backbone_feat": opt_feat, "kept": [k.long() for k in kept], "scores": scores}


# -- lib/test ---------------------------------------------------------------------------


def hann1d(sz: int, centered=True) -> torch.Tensor:
    return 0.5 * (1 - torch.cos((2 * math.pi / (sz + 1)) * torch.arange(1, sz + 1).float()))


def hann2d(sz: int) -> torch.Tensor:
    return hann1d(sz).reshape(1, 1, -1, 1) * hann1d(sz).reshape(1, 1, 1, -1)


def map_box_back(state, pred_box: list, resize_factor: float, search_size: int):
    cx_prev, cy_prev = state[0] + 0.5 * state[2], state[1] + 0.5 * state[3]
    cx, cy, w, h = pred_box
    half_side = 0.5 * search_size / resize_factor
    cx_real = cx + (cx_prev - half_side)
    cy_real = cy + (cy_prev - half_side)
    return [cx_real - 0.5 * w, cy_real - 0.5 * h, w, h]


def clip_box(box: list, H, W, margin=0):
    x1, y1, w, h = box
    x2, y2 = x1 + w, y1 + h
    x1 = min(max(0, x1), W - margin)
    x2 = min(max(margin, x2), W)
    y1 = min(max(0, y1), H - margin)
    y2 = min(max(margin, y2), H)
    w = max(margin, x2 - x1)
    h = max(margin, y2 - y1)
    return [x1, y1, w, h]


def initialize(W: Dict, sz: Sizes, image: torch.Tensor, init_bbox) -> torch.Tensor:
    """``OSTrack.initialize``: the normalized template crop (1, 3, 128, 128)."""
    crop, _ = sample_target_float(image, init_bbox, sz.template_factor, sz.template_size)
    return normalize(crop)


def track(W: Dict, sz: Sizes, template: torch.Tensor, image: torch.Tensor, state) -> Dict:
    """``OSTrack.track`` from the previous box ``state`` → the new box, the
    score at the chosen cell (the port's confidence), the maps, the
    windowed response and the kept indices."""
    H, Wd, _ = image.shape
    crop, crop_sz = sample_target_float(image, state, sz.search_factor, sz.search_size)
    resize_factor = sz.search_size / crop_sz
    out = ostrack_forward(W, sz, template, normalize(crop))
    n = sz.search_size // sz.patch_size
    response = hann2d(n) * out["score_map"]
    pred_boxes, _ = cal_bbox(response, out["size_map"], out["offset_map"], n)
    pred_box = (pred_boxes.view(-1, 4).mean(dim=0) * sz.search_size / resize_factor).tolist()
    box = clip_box(map_box_back(state, pred_box, resize_factor, sz.search_size), H, Wd, margin=sz.clip_margin)
    idx = int(response.flatten(1).argmax(1))
    return dict(out, box=box, response=response, confidence=float(out["score_map"].flatten()[idx]))
