"""FBNet-style backbone (``torch.nn``, NHWC at the module boundary), the
counterpart of ``feartracker_tpu/models/fbnet.py``.

The trunk tables are copies of the JAX package's (a test holds them equal):
a 3×3/s2 stem to 16 channels, then MobileNetV2 inverted-residual blocks —
optional 1×1 expand (+BN+ReLU) → k×k depthwise (+BN+ReLU) → 1×1 linear
project (+BN), residual when stride 1 and channels match.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn

from feartracker_tpu_torch.models.blocks import ConvBNAct


class IRBlockSpec(NamedTuple):
    expansion: int
    kernel: int
    stride: int
    out_channels: int


FEAR_XS_TRUNK: Tuple[IRBlockSpec, ...] = (
    IRBlockSpec(1, 3, 1, 16),
    IRBlockSpec(6, 3, 2, 24),
    IRBlockSpec(1, 3, 1, 24),
    IRBlockSpec(1, 3, 1, 24),
    IRBlockSpec(6, 5, 2, 32),
    IRBlockSpec(3, 5, 1, 32),
    IRBlockSpec(6, 5, 1, 32),
    IRBlockSpec(6, 3, 1, 32),
    IRBlockSpec(6, 5, 2, 64),
    IRBlockSpec(3, 5, 1, 64),
    IRBlockSpec(6, 5, 1, 64),
    IRBlockSpec(6, 5, 1, 64),
    IRBlockSpec(6, 5, 1, 112),
    IRBlockSpec(6, 5, 1, 112),
    IRBlockSpec(6, 5, 1, 112),
    IRBlockSpec(3, 5, 1, 112),
)

# a 3-block stride-8 trunk for small tests
TINY_TRUNK: Tuple[IRBlockSpec, ...] = (
    IRBlockSpec(1, 3, 1, 8),
    IRBlockSpec(2, 3, 2, 12),
    IRBlockSpec(2, 5, 2, 16),
)

FEAR_M_TRUNK: Tuple[IRBlockSpec, ...] = (
    IRBlockSpec(1, 3, 1, 24),
    IRBlockSpec(6, 3, 2, 36),
    IRBlockSpec(3, 3, 1, 36),
    IRBlockSpec(3, 3, 1, 36),
    IRBlockSpec(6, 5, 2, 48),
    IRBlockSpec(3, 5, 1, 48),
    IRBlockSpec(6, 5, 1, 48),
    IRBlockSpec(6, 3, 1, 48),
    IRBlockSpec(6, 5, 2, 96),
    IRBlockSpec(3, 5, 1, 96),
    IRBlockSpec(6, 5, 1, 96),
    IRBlockSpec(6, 5, 1, 96),
    IRBlockSpec(6, 5, 1, 96),
    IRBlockSpec(6, 5, 1, 168),
    IRBlockSpec(6, 5, 1, 168),
    IRBlockSpec(6, 5, 1, 168),
    IRBlockSpec(3, 5, 1, 168),
)

FEAR_L_TRUNK: Tuple[IRBlockSpec, ...] = (
    IRBlockSpec(1, 3, 1, 32),
    IRBlockSpec(6, 3, 2, 48),
    IRBlockSpec(3, 3, 1, 48),
    IRBlockSpec(3, 3, 1, 48),
    IRBlockSpec(6, 5, 2, 64),
    IRBlockSpec(6, 5, 1, 64),
    IRBlockSpec(6, 5, 1, 64),
    IRBlockSpec(6, 3, 1, 64),
    IRBlockSpec(6, 5, 2, 128),
    IRBlockSpec(6, 5, 1, 128),
    IRBlockSpec(6, 5, 1, 128),
    IRBlockSpec(6, 5, 1, 128),
    IRBlockSpec(6, 5, 1, 128),
    IRBlockSpec(6, 5, 1, 128),
    IRBlockSpec(6, 5, 1, 224),
    IRBlockSpec(6, 5, 1, 224),
    IRBlockSpec(6, 5, 1, 224),
    IRBlockSpec(3, 5, 1, 224),
)

TRUNKS = {
    "fear_xs": FEAR_XS_TRUNK,
    "fear_tiny": TINY_TRUNK,
    "fear_m": FEAR_M_TRUNK,
    "fear_l": FEAR_L_TRUNK,
}


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, spec: IRBlockSpec):
        super().__init__()
        self.spec = spec
        self.residual = spec.stride == 1 and in_ch == spec.out_channels
        ce = in_ch * spec.expansion
        if spec.expansion != 1:
            self.expand = ConvBNAct(in_ch, ce, kernel=1)
        self.dw = ConvBNAct(ce, ce, kernel=spec.kernel, stride=spec.stride,
                            padding=spec.kernel // 2, groups=ce)
        self.project = ConvBNAct(ce, spec.out_channels, kernel=1, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        if self.spec.expansion != 1:
            x = self.expand(x)
        x = self.project(self.dw(x))
        return x + inp if self.residual else x


class FBNetTrunk(nn.Module):
    """Stem + inverted-residual trunk (output stride 2·∏ strides)."""

    def __init__(self, blocks: Sequence[IRBlockSpec] = FEAR_XS_TRUNK, stem_channels: int = 16):
        super().__init__()
        self.specs = tuple(blocks)
        self.stem = ConvBNAct(3, stem_channels, kernel=3, stride=2, padding=1)
        ch = stem_channels
        for i, spec in enumerate(self.specs):
            self.add_module(f"block{i}", InvertedResidual(ch, spec))
            ch = spec.out_channels
        self.out_channels = ch

    @property
    def stride(self) -> int:
        s = 2
        for spec in self.specs:
            s *= spec.stride
        return s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(len(self.specs)):
            x = getattr(self, f"block{i}")(x)
        return x
