"""Parameter and MAC counts, the counterpart of
``feartracker_tpu/evaluate/flops.py``.

The JAX package reads XLA's cost analysis of the compiled ``track``; here
``torch.utils.flop_counter.FlopCounterMode`` counts one plain ``track``
call on the CPU: search (1, 256, 256, 3) + template features (1, 8, 8, 256),
as the reference's profile of ``model.track``. The counter counts the
products (convolutions, matmuls, the correlation's bmm) and no elementwise
operations, where XLA also counts the adds, BatchNorms and activations.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm running statistics are buffers, as
    Flax keeps them outside ``params``)."""
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def track_cost(model: nn.Module, search_size: int = 256, feat_size: int = 8,
               channels: int = 256) -> Dict[str, float]:
    """FLOPs (2 per multiply-add) and MACs of one ``model.track`` call, and
    the model's parameter count."""
    model = model.eval().cpu()
    search = torch.zeros((1, search_size, search_size, 3))
    feats = torch.zeros((1, feat_size, feat_size, channels))
    with FlopCounterMode(display=False) as counter:
        model.track(search, feats)
    flops = float(counter.get_total_flops())
    return {"flops": flops, "macs": flops / 2.0, "params": float(count_params(model))}
