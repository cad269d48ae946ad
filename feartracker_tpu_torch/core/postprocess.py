"""Score-map postprocessing: scale/ratio penalty, cosine-window mixing and
size smoothing, batched over streams.

:func:`postprocess` is the plain PyTorch twin of the fused CUDA decode kernel
(:mod:`feartracker_tpu_torch.ops.cuda.decode`), which the tracker runs for
CUDA tensors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from feartracker_tpu_torch.core import box_coder as bc


class PostprocessConfig(NamedTuple):
    """Decode constants (same defaults as the JAX package)."""

    penalty_k: float = 0.062
    window_influence: float = 0.38
    lr: float = 0.765
    windowing: str = "cosine"
    score_size: int = 16
    total_stride: int = 16
    instance_size: int = 256
    smooth: bool = False

    @property
    def box_spec(self) -> bc.BoxCoderSpec:
        return bc.BoxCoderSpec(self.score_size, self.total_stride, self.instance_size)


@lru_cache(maxsize=4)
def _window_np(windowing: str, score_size: int) -> np.ndarray:
    """Hanning outer-product window."""
    if windowing == "cosine":
        return np.outer(np.hanning(score_size), np.hanning(score_size)).astype(np.float32)
    return np.ones((score_size, score_size), np.float32)


def tracking_window(cfg: PostprocessConfig, device=None) -> torch.Tensor:
    return torch.from_numpy(_window_np(cfg.windowing, cfg.score_size)).to(device)


def _limit(r: torch.Tensor) -> torch.Tensor:
    return torch.maximum(r, 1.0 / r)


def _squared_size(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    pad = (w + h) * 0.5
    return torch.sqrt((w + pad) * (h + pad))


def penalty_scores(
    cls_score: torch.Tensor,
    regression_map: torch.Tensor,
    prev_size: torch.Tensor,
    cfg: PostprocessConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale/ratio-penalized, window-mixed score map.

    Args:
      cls_score: (B, H, W) sigmoid classification scores.
      regression_map: (B, H, W, 4) LTRB offsets.
      prev_size: (B, 2) previous (w, h) in search-crop pixels.
    Returns:
      (pscore (B, H, W), penalty (B, H, W)).
    """
    loc = bc.pred_locations(regression_map, cfg.box_spec)
    pw = loc[..., 2] - loc[..., 0]
    ph = loc[..., 3] - loc[..., 1]
    prev_w = prev_size[:, 0, None, None]
    prev_h = prev_size[:, 1, None, None]

    s_c = _limit(_squared_size(pw, ph) / _squared_size(prev_w, prev_h))
    r_c = _limit((prev_w / prev_h) / (pw / ph))
    penalty = torch.exp(-(r_c * s_c - 1.0) * cfg.penalty_k)
    pscore = penalty * cls_score
    window = tracking_window(cfg, cls_score.device)
    pscore = pscore * (1.0 - cfg.window_influence) + window * cfg.window_influence
    return pscore, penalty


def smooth_size(pred_size: torch.Tensor, prev_size: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """SiamFC-style exponential size smoothing: ``pred_size`` and
    ``prev_size`` are (..., 2) (w, h); ``lr`` is (...,)."""
    lr = lr[..., None]
    scaled = pred_size * lr
    kept = prev_size * (1.0 - lr)
    return kept + lr * (scaled + kept)


def apce(score: torch.Tensor) -> torch.Tensor:
    """Average peak-to-correlation energy ``(max−min)² / mean((v−min)²)`` of
    a (B, H, W) score map → (B,) float32; a per-frame diagnostic."""
    smin = score.amin(dim=(1, 2))
    smax = score.amax(dim=(1, 2))
    energy = ((score - smin[:, None, None]) ** 2).mean(dim=(1, 2))
    return (smax - smin) ** 2 / (energy + 1e-12)


class PostprocessResult(NamedTuple):
    bbox: torch.Tensor  # (B, 4) xywh in search-crop pixels
    confidence: torch.Tensor  # (B,) raw sigmoid cls score at the chosen cell
    pred_coords: torch.Tensor  # (B, 2) int32 (row, col)


def postprocess(
    cls_logits: torch.Tensor,
    regression_map: torch.Tensor,
    cfg: PostprocessConfig,
    prev_size: Optional[torch.Tensor] = None,
) -> PostprocessResult:
    """Full decode: sigmoid → (optional) penalty/window → argmax box →
    (optional) size smoothing. ``cls_logits`` is (B, H, W[, 1]),
    ``regression_map`` (B, H, W, 4), ``prev_size`` (B, 2) when smoothing."""
    if cls_logits.dim() == 4:
        cls_logits = cls_logits[..., 0]
    cls_score = torch.sigmoid(cls_logits.float())
    regression_map = regression_map.float()

    if cfg.smooth:
        if prev_size is None:
            raise ValueError("smooth postprocess needs prev_size")
        pscore, penalty = penalty_scores(cls_score, regression_map, prev_size, cfg)
    else:
        pscore, penalty = cls_score, None

    dec = bc.decode(regression_map, pscore, cfg.box_spec, use_sigmoid=False)
    rows = torch.arange(cls_score.shape[0], device=cls_score.device)
    r, c = dec.pred_coords[:, 0].long(), dec.pred_coords[:, 1].long()
    confidence = cls_score[rows, r, c]

    bbox = dec.bbox
    if cfg.smooth:
        lr = penalty[rows, r, c] * confidence * cfg.lr
        wh = smooth_size(bbox[:, 2:], prev_size, lr)
        bbox = torch.cat([bbox[:, :2], wh], dim=-1)

    return PostprocessResult(bbox=bbox, confidence=confidence, pred_coords=dec.pred_coords)
