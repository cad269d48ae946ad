"""The work a step needs, counted from shapes, whatever implements it.

Frozen copies of the program's arithmetic, kept here so that a later change
to the program cannot move the yardstick:

* :func:`ir_block_bound` is ``feartracker_tpu_torch/evaluate/profiling.py:
  ir_block_bound``: one fused inverted-residual block's least time on the
  H100, its bytes moved once over HBM, its 1x1 products over the tensor
  cores and its depthwise products over the CUDA cores;
* :func:`crop_flops` is ``feartracker_tpu_torch/tools/roofline.py:
  crop_flops``: a bilinear crop needs four taps a value, a multiply-add each;
* the model's products are counted as ``tools/roofline.py:ProductCounter``
  counts them, by ``torch.utils.flop_counter``'s formulas, here over the
  benchmark's plain reference at batch 1 on meta tensors (no data, no
  device).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts.h100 import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S
from portbench.reference import fear


def ir_block_bound(S: int, h: int, cin: int, spec: Sequence[int], dtype: str = "bfloat16"):
    """(least seconds, its larger term, every term) of one fused block
    (expansion, kernel, stride, out channels) on x (S, h, h, cin)."""
    e, k, stride, cout = spec
    ce, ho = cin * e, h // stride
    itemsize = 4 if dtype == "float32" else 2
    nbytes = (S * (h * h * cin + ho * ho * cout) + ce * (cin + cout)) * itemsize + (k * k * ce + 2 * ce + cout) * 4
    products = 2 * S * (h * h * cin * ce + ho * ho * ce * cout)
    depthwise = 2 * S * ho * ho * ce * k * k
    terms = {"bytes": nbytes / HBM_BYTES_PER_S}
    if dtype == "float32":
        terms["fmas"] = (products + depthwise) / F32_FLOPS
    else:
        terms["products"] = products / BF16_FLOPS
        terms["depthwise"] = depthwise / F32_FLOPS
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def k2_least_s(cfg: Dict, S: int, size: int) -> float:
    """K2's least time for one pass of the trunk over S crops of ``size``²:
    the sum of :func:`ir_block_bound` over the blocks with expansion > 1."""
    h, cin, total = size // 2, cfg["stem_channels"], 0.0
    for spec in cfg["trunk"]:
        if spec[0] != 1:
            total += ir_block_bound(S, h, cin, spec, cfg["dtype"])[0]
        h, cin = h // spec[2], spec[3]
    return total


def crop_flops(out_size: int, channels: int = 3) -> int:
    return 2 * 4 * out_size * out_size * channels


def meta_weights(cfg: Dict, flat_shapes: Dict[str, Sequence[int]]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(tuple(s), device="meta") for k, s in flat_shapes.items()}


def frame_products(cfg: Dict, W: Dict[str, torch.Tensor]) -> int:
    """Products of one tracked frame of one stream: the search crop's taps,
    the trunk and neck at the search size, and the head against a cached
    template."""
    s, t = cfg["instance_size"], cfg["template_size"] // (cfg["instance_size"] // cfg["score_size"])
    with FlopCounterMode(display=False) as counter:
        x = torch.empty((1, s, s, 3), device="meta")
        z = torch.empty((1, t, t, cfg["adjust_channels"]), device="meta")
        fear.head(W, cfg["towernum"], fear.features(W, cfg["trunk"], x), z)
    return int(counter.get_total_flops()) + crop_flops(s)


def template_products(cfg: Dict, W: Dict[str, torch.Tensor]) -> int:
    """Products of one template encode (the crop's taps, trunk and neck)."""
    t = cfg["template_size"]
    with FlopCounterMode(display=False) as counter:
        fear.features(W, cfg["trunk"], torch.empty((1, t, t, 3), device="meta"))
    return int(counter.get_total_flops()) + crop_flops(t)
