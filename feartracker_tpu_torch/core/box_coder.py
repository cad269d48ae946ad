"""FEAR box coding on the stride-16 score grid: xywh boxes ↔ (regression
map, classification label). Maps are channel-last ``(B, H, W, C)``, as in the
JAX package."""

from __future__ import annotations

from typing import NamedTuple

import torch

from feartracker_tpu_torch.core.grids import make_grid


class EncodeResult(NamedTuple):
    regression_map: torch.Tensor  # (B, H, W, 4) LTRB offsets
    classification_label: torch.Tensor  # (B, H, W, 1) {0, 1}


class DecodeResult(NamedTuple):
    bbox: torch.Tensor  # (B, 4) xywh in search-crop pixels
    pred_coords: torch.Tensor  # (B, 2) int32 (row, col) of the argmax cell
    peak_score: torch.Tensor  # (B,) score at the argmax cell


class BoxCoderSpec(NamedTuple):
    score_size: int = 16
    total_stride: int = 16
    instance_size: int = 256


def encode(bboxes: torch.Tensor, spec: BoxCoderSpec = BoxCoderSpec()) -> EncodeResult:
    """xywh boxes ``(B, 4)`` → LTRB offset maps and inside-box labels (a
    cell is positive iff min(LTRB) > 0)."""
    grid_x, grid_y = make_grid(spec.score_size, spec.total_stride, spec.instance_size, bboxes.device)
    b = bboxes[:, :, None, None]  # (B, 4, 1, 1)
    left = grid_x - b[:, 0]
    top = grid_y - b[:, 1]
    right = b[:, 0] + b[:, 2] - grid_x
    bottom = b[:, 1] + b[:, 3] - grid_y
    reg = torch.stack((left, top, right, bottom), dim=-1).float()  # (B, H, W, 4)
    cls = (torch.amin(reg, dim=-1, keepdim=True) > 0).float()  # (B, H, W, 1)
    return EncodeResult(regression_map=reg, classification_label=cls)


def get_box_coder(tracker_config: dict, tracker_name: str = "fear"):
    """The grid geometry of a tracker config; ``None`` for any tracker but
    "fear", as in the JAX package."""
    if tracker_name == "fear":
        return BoxCoderSpec(
            score_size=int(tracker_config.get("score_size", 16)),
            total_stride=int(tracker_config.get("total_stride", 16)),
            instance_size=int(tracker_config.get("instance_size", 256)),
        )
    return None


def pred_locations(regression_map: torch.Tensor, spec: BoxCoderSpec = BoxCoderSpec()) -> torch.Tensor:
    """LTRB offset map (B,H,W,4) → xyxy corner map (B,H,W,4)."""
    grid_x, grid_y = make_grid(spec.score_size, spec.total_stride, spec.instance_size,
                               regression_map.device)
    x1 = grid_x - regression_map[..., 0]
    y1 = grid_y - regression_map[..., 1]
    x2 = grid_x + regression_map[..., 2]
    y2 = grid_y + regression_map[..., 3]
    return torch.stack((x1, y1, x2, y2), dim=-1)


def decode(
    regression_map: torch.Tensor,
    classification_map: torch.Tensor,
    spec: BoxCoderSpec = BoxCoderSpec(),
    use_sigmoid: bool = True,
) -> DecodeResult:
    """Pick the argmax score cell (row-major first match, as ``torch.argmax``
    and ``jnp.argmax`` both do) and read its box."""
    if classification_map.dim() == 4:
        classification_map = classification_map[..., 0]
    if use_sigmoid:
        classification_map = torch.sigmoid(classification_map.float())

    B, H, W = classification_map.shape
    flat = classification_map.reshape(B, H * W)
    idx = torch.argmax(flat, dim=-1)
    coords = torch.stack([idx // W, idx % W], dim=-1).to(torch.int32)

    rows = torch.arange(B, device=flat.device)
    sel = pred_locations(regression_map, spec).reshape(B, H * W, 4)[rows, idx]
    bbox = torch.stack(
        [sel[:, 0], sel[:, 1], sel[:, 2] - sel[:, 0], sel[:, 3] - sel[:, 1]], dim=-1
    )
    return DecodeResult(bbox=bbox, pred_coords=coords, peak_score=flat[rows, idx])
