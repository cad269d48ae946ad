"""Tracker configuration (same defaults as ``feartracker_tpu/tracker/config.py``)."""

from __future__ import annotations

from typing import NamedTuple

from feartracker_tpu_torch.core.postprocess import PostprocessConfig


class TrackerConfig(NamedTuple):
    penalty_k: float = 0.062
    window_influence: float = 0.38
    lr: float = 0.765
    windowing: str = "cosine"
    total_stride: int = 16
    score_size: int = 16
    template_bbox_offset: float = 0.2
    search_context: float = 2.0
    instance_size: int = 256
    template_size: int = 128
    smooth: bool = False
    confidence_threshold: float = 0.7

    @property
    def postprocess(self) -> PostprocessConfig:
        return PostprocessConfig(
            penalty_k=self.penalty_k,
            window_influence=self.window_influence,
            lr=self.lr,
            windowing=self.windowing,
            score_size=self.score_size,
            total_stride=self.total_stride,
            instance_size=self.instance_size,
            smooth=self.smooth,
        )
