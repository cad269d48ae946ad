"""Model building blocks (``torch.nn``), counterparts of
``feartracker_tpu/models/blocks.py``.

Every module takes and returns NHWC tensors, the JAX package's layout.
Inside, ``x.permute(0, 3, 1, 2)`` is a channels-last-strided NCHW view that
the convolutions take without a copy, and the result is permuted back, so the
layout costs nothing. Submodules are named as in Flax, so that a weight's
Flax path maps one to one onto its state-dict key
(:func:`feartracker_tpu_torch.convert.load.load_fear_net`).

Padding is explicit and symmetric (torch's ``padding=p``), which is what the
JAX blocks pin, stride 2 included. BatchNorm: eps 1e-5; in eval mode it is
torch's; in train mode it is Flax's (:class:`FlaxBatchNorm2d`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


FLAX_BN_MOMENTUM = 0.9


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode computes what Flax's
    ``nn.BatchNorm(momentum=0.9)`` does:

    * batch statistics in float32 or wider whatever the input's dtype (float64
      stays float64), and the running variance moved with the *biased* batch
      variance (torch's own BatchNorm moves it with the unbiased one, N/(N−1)
      larger);
    * running statistics ``0.9·ra + 0.1·batch``;
    * the normalization ``(x − mean)·rsqrt(var + eps)·scale + bias`` in that
      dtype, cast back to the input's dtype (bfloat16 under autocast).

    The normalization and its gradient are one fused library call (cuDNN's
    on the card); the running statistics are a separate reduction outside
    the graph. Eval mode is torch's, unchanged: inference and
    ``fold_fear_net`` read the same parameters and buffers as before.

    ``sync_bn`` (set by :func:`set_sync_bn`) makes train mode Flax's
    ``BatchNorm(axis_name=…)`` across the default process group when it has
    more than one process: the statistics are computed as Flax's
    ``_compute_stats`` does (:meth:`_forward_sync`). With one process, or
    without a group, the module runs the single-device path above.
    """

    sync_bn = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.sync_bn and dist.is_initialized() and dist.get_world_size() > 1:
            return self._forward_sync(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            m = FLAX_BN_MOMENTUM
            self.running_mean.mul_(m).add_(mean.to(self.running_mean.dtype), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.to(self.running_var.dtype), alpha=1.0 - m)
        y = torch.batch_norm(xf, self.weight, self.bias, None, None, True, 0.0, self.eps,
                             torch.backends.cudnn.enabled)
        return y.to(x.dtype)

    def _forward_sync(self, x: torch.Tensor) -> torch.Tensor:
        """Flax's statistics across processes, step for step: the local
        means of x and x² in at least float32, stacked and averaged over the
        group in one differentiable all-reduce, the "fast variance"
        ``max(0, E[x²] − E[x]²)``, the normalization in Flax's order, and the
        running statistics moved 0.9/0.1 with that biased variance."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        local = torch.stack([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        mean, mean2 = all_reduce_mean(local)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            m = FLAX_BN_MOMENTUM
            self.running_mean.mul_(m).add_(mean.to(self.running_mean.dtype), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.to(self.running_var.dtype), alpha=1.0 - m)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class _AllReduceMean(torch.autograd.Function):
    """The mean of a tensor over the default process group. Its backward is
    the same mean of the cotangents: the transpose of JAX's ``pmean`` under
    ``shard_map``, so that a gradient that flows through the shared
    statistics sums every process's share."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y / dist.get_world_size()

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g / dist.get_world_size()


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable mean of ``x`` over the default process group."""
    return _AllReduceMean.apply(x)


def set_sync_bn(model: nn.Module, enabled: bool = True) -> nn.Module:
    """Turn the cross-process statistics of every train-mode
    :class:`FlaxBatchNorm2d` of ``model`` on or off (JAX: the model's
    ``bn_axis_name``)."""
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.sync_bn = enabled
    return model


def _bn(features: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(features, eps=BN_EPS, momentum=0.1)


class SepConv(nn.Module):
    """Depthwise k×k + pointwise 1×1."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, padding: int = 0,
                 use_bias: bool = True):
        super().__init__()
        self.dw = nn.Conv2d(in_ch, in_ch, kernel, padding=padding, groups=in_ch, bias=use_bias)
        self.pw = nn.Conv2d(in_ch, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.pw(self.dw(to_nchw(x))))


class ConvBNAct(nn.Module):
    """conv (no bias) → BN → (optional) ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, padding, groups=groups, bias=False)
        self.bn = _bn(features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(to_nchw(x)))
        if self.relu:
            y = F.relu(y)
        return to_nhwc(y)


class AdjustLayer(nn.Module):
    """Neck: 1×1 conv + BN, no activation."""

    def __init__(self, in_ch: int, features: int = 256):
        super().__init__()
        self.downsample = ConvBNAct(in_ch, features, kernel=1, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.downsample(x)


class SepConvBNReLU(nn.Module):
    """SepConv → BN → ReLU, the repeated unit of the encode/corr/tower stacks."""

    def __init__(self, in_ch: int, features: int, use_bias: bool = True):
        super().__init__()
        self.sep = SepConv(in_ch, features, kernel=3, padding=1, use_bias=use_bias)
        self.bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_nhwc(F.relu(self.bn(to_nchw(self.sep(x)))))


def flatten_template(z: torch.Tensor) -> torch.Tensor:
    """Template features (B, Ht, Wt, C) → (B, Ht·Wt, C), row-major over (h, w)."""
    B, H, W, C = z.shape
    return z.reshape(B, H * W, C)


def pixelwise_correlation(z_flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Every template cell dotted with every search position over channels:
    z_flat (B, Kt, C), x (B, H, W, C) → (B, H, W, Kt); channel k is template
    cell k in row-major order. A batched matmul (no kernel in JAX either)."""
    B, H, W, C = x.shape
    out = torch.bmm(x.reshape(B, H * W, C), z_flat.transpose(1, 2))
    return out.reshape(B, H, W, -1)


class MobileCorrelation(nn.Module):
    """Correlation volume concat ``[x, corr]`` + SepConv re-encode."""

    def __init__(self, in_ch: int, template_cells: int, features: int = 256):
        super().__init__()
        self.enc = SepConvBNReLU(in_ch + template_cells, features, use_bias=True)

    def forward(self, z_flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        s = pixelwise_correlation(z_flat, x)
        return self.enc(torch.cat([x, s], dim=-1))


class BoxTower(nn.Module):
    """Dual-branch (cls/reg) correlation head. ``update`` is the dual-template
    hook: the classification branch correlates against it when given."""

    def __init__(self, in_ch: int, features: int = 256, towernum: int = 2,
                 template_cells: int = 64):
        super().__init__()
        self.towernum = towernum
        # the template passes through as-is; the search is re-encoded
        # (SepConv without bias here)
        self.cls_encode = SepConvBNReLU(in_ch, features, use_bias=False)
        self.reg_encode = SepConvBNReLU(in_ch, features, use_bias=False)
        self.cls_dw = MobileCorrelation(features, template_cells, features)
        self.reg_dw = MobileCorrelation(features, template_cells, features)
        for i in range(towernum):
            self.add_module(f"bbox_tower{i}", SepConvBNReLU(features, features))
        for i in range(towernum):
            self.add_module(f"cls_tower{i}", SepConvBNReLU(features, features))
        self.bbox_pred = SepConv(features, 4, kernel=3, padding=1)
        self.cls_pred = SepConv(features, 1, kernel=3, padding=1)
        self.adjust = nn.Parameter(torch.full((1,), 0.1))
        self.bias = nn.Parameter(torch.ones(1, 1, 1, 4))
        self.cls_scale = nn.Parameter(torch.full((1,), 0.1))

    def forward(self, search: torch.Tensor, kernel: torch.Tensor,
                update: Optional[torch.Tensor] = None):
        cls_z = flatten_template(kernel if update is None else update)
        reg_z = flatten_template(kernel)
        cls_dw = self.cls_dw(cls_z, self.cls_encode(search))
        reg_dw = self.reg_dw(reg_z, self.reg_encode(search))

        x_reg = reg_dw
        for i in range(self.towernum):
            x_reg = getattr(self, f"bbox_tower{i}")(x_reg)
        c = cls_dw
        for i in range(self.towernum):
            c = getattr(self, f"cls_tower{i}")(c)

        # reg head: exp(adjust · pred + bias); cls head: cls_scale · pred
        bbox = torch.exp(self.adjust * self.bbox_pred(x_reg) + self.bias)
        cls = self.cls_scale * self.cls_pred(c)
        return bbox, cls
