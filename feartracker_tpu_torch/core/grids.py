"""Score-map coordinate grids: cell (i, j) of the score map maps to pixel
``(idx - score_size // 2) * stride + instance_size // 2`` of the search crop."""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=8)
def make_grid_np(score_size: int, total_stride: int, instance_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(grid_x, grid_y), each (score_size, score_size) float32, host numpy."""
    idx = np.arange(score_size, dtype=np.float32) - np.floor(float(score_size // 2))
    x, y = np.meshgrid(idx, idx)
    grid_x = x * total_stride + instance_size // 2
    grid_y = y * total_stride + instance_size // 2
    return grid_x.astype(np.float32), grid_y.astype(np.float32)


def make_grid(score_size: int, total_stride: int, instance_size: int,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grid_x, grid_y) as float32 tensors on ``device``."""
    gx, gy = make_grid_np(score_size, total_stride, instance_size)
    return torch.from_numpy(gx).to(device), torch.from_numpy(gy).to(device)
