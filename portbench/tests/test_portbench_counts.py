"""The yardstick's arithmetic against figures worked out by hand."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.counts import h100, products


def cfg(name):
    return json.load(open(os.path.join(harness.BENCH_DIR, "configs", f"{name}.json")))


def meta(name):
    with np.load(os.path.join(harness.ROOT, cfg(name)["weights"])) as z:
        return {k: torch.empty(z[k].shape, device="meta") for k in z.files}


def test_one_k2_block_by_hand():
    # FEAR-XS block 1 at S=128: x (128, 128, 128, 16), expansion 6, 3x3, stride 2, out 24
    least, by, terms = products.ir_block_bound(128, 128, 16, (6, 3, 2, 24))
    nbytes = (128 * (128 * 128 * 16 + 64 * 64 * 24) + 96 * (16 + 24)) * 2 + (9 * 96 + 2 * 96 + 24) * 4
    assert terms["bytes"] == pytest.approx(nbytes / 3.35e12)
    assert terms["products"] == pytest.approx(2 * 128 * (128 * 128 * 16 * 96 + 64 * 64 * 96 * 24) / 989e12)
    assert terms["depthwise"] == pytest.approx(2 * 128 * 64 * 64 * 96 * 9 / 67e12)
    assert by == "bytes" and least == terms["bytes"]


def test_peaks():
    assert (h100.BF16_FLOPS, h100.F32_FLOPS, h100.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)


def test_fear_xs_frame():
    # 0.9228 GFLOP of the model at a 256² search (trunk, neck, head) and the
    # crop's 4 taps x 2 FLOPs x 256² x 3
    n = products.frame_products(cfg("fear_xs"), meta("fear_xs"))
    assert products.crop_flops(256) == 2 * 4 * 256 * 256 * 3 == 1_572_864
    assert n == 924_360_704
    assert (n - products.crop_flops(256)) / 1e9 == pytest.approx(0.923, abs=5e-4)


def test_k2_least_time_sums_the_expanding_blocks():
    c = cfg("fear_xs")
    h, cin, total = 128, 16, 0.0
    for spec in c["trunk"]:
        if spec[0] != 1:
            total += products.ir_block_bound(128, h, cin, spec)[0]
        h, cin = h // spec[2], spec[3]
    assert products.k2_least_s(c, 128, 256) == pytest.approx(total)
    assert sum(1 for s in c["trunk"] if s[0] != 1) == 13
