"""The work of one frame of the one-stream tracker (OSTrack-256 CE), counted
from shapes at CE's token counts, whatever implements it: the products of
the benchmark's reference step (``reference/ostrack.py``) at batch 1 on meta
tensors, by ``torch.utils.flop_counter``'s formulas, and the search crop's
bilinear taps. The attention's share (the two batched products of each
block: scores and the weighted sum) is read from the same count."""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts.products import crop_flops
from portbench.reference import ostrack


@lru_cache(maxsize=4)
def _count(sz: ostrack.Sizes) -> Tuple[int, int]:
    W = {k: torch.empty(s, device="meta") for k, s in ostrack.shapes(sz).items()}
    with FlopCounterMode(display=False) as counter:
        z = torch.empty((1, sz.lens_z, sz.embed_dim), device="meta")
        x = torch.empty((1, sz.search_size, sz.search_size, 3), device="meta")
        ostrack.forward(W, sz, z, x)
    by_op = counter.get_flop_counts()["Global"]
    attention = sum(v for op, v in by_op.items() if "bmm" in str(op))
    return int(counter.get_total_flops()) + crop_flops(sz.search_size), int(attention)


def frame_products(cfg: Dict) -> int:
    """Products of one tracked frame of one stream: the search crop's taps,
    the patch embedding, the joint blocks at 320, 244, 190 and 153 tokens,
    the head; the template's tokens are the state's."""
    return _count(ostrack.Sizes.of(cfg))[0]


def attention_flops(cfg: Dict) -> int:
    """The attention's products a frame of one stream: 4·N²·C a block."""
    return _count(ostrack.Sizes.of(cfg))[1]
