"""Training and validation metrics as functions on tensors, and a dense
dataset-aware accumulator: the counterpart of
``feartracker_tpu/train/metrics.py``."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch


def box_iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of xywh boxes, standard convention (no +1)."""
    ax1, ay1 = a[..., 0], a[..., 1]
    ax2, ay2 = ax1 + a[..., 2], ay1 + a[..., 3]
    bx1, by1 = b[..., 0], b[..., 1]
    bx2, by2 = bx1 + b[..., 2], by1 + b[..., 3]
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / torch.clamp(union, min=1e-9)


def failure_rate(ious: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of samples with IoU == 0."""
    fail = (ious == 0).float()
    if mask is None:
        return torch.mean(fail)
    m = mask.float()
    return torch.sum(fail * m) / torch.clamp(torch.sum(m), min=1.0)


class DatasetAwareSums(NamedTuple):
    """Dense per-dataset accumulator: one sum reduces it."""

    value_sum: torch.Tensor  # (num_datasets,)
    count: torch.Tensor  # (num_datasets,)

    @classmethod
    def zeros(cls, num_datasets: int, device=None) -> "DatasetAwareSums":
        return cls(torch.zeros(num_datasets, device=device), torch.zeros(num_datasets, device=device))

    def update(self, dataset_ids: torch.Tensor, values: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> "DatasetAwareSums":
        """Accumulate ``values`` (B,) into their datasets' buckets
        (``dataset_ids`` (B,) int), where ``mask`` (B,) allows."""
        n = self.value_sum.shape[0]
        onehot = (dataset_ids[:, None] == torch.arange(n, device=dataset_ids.device)[None, :]).float()
        if mask is not None:
            onehot = onehot * mask.float()[:, None]
        return DatasetAwareSums(
            value_sum=self.value_sum + onehot.t() @ values.float(),
            count=self.count + torch.sum(onehot, dim=0),
        )

    def compute(self, names: Sequence[str], metric_name: str = "box_iou") -> Dict[str, float]:
        means = self.value_sum / torch.clamp(self.count, min=1.0)
        return {
            f"{name}_{metric_name}": float(means[i])
            for i, name in enumerate(names)
            if float(self.count[i]) > 0
        }
