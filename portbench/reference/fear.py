"""FEAR in plain PyTorch: the benchmark's reference for the tracker.

The network is written from the published description (FBNet trunk of
inverted-residual blocks, a 1x1 neck, the BoxTower head of the FEAR paper)
as functions over a flat dict of weights keyed as the released checkpoints
are (``params/encoder/block3/dw/conv/kernel``, ``batch_stats/.../mean``).
Maps are NHWC at every boundary; convolutions run through ``F.conv2d`` in
NCHW. Nothing here imports the program under test.

``Precision`` rounds the operands of every convolution and matrix product:
``float32`` leaves them alone (the reference), ``fp8`` rounds each to
float8 e4m3 with a per-tensor scale (the control: the step below the
bfloat16 the configurations state).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0


class Precision:
    """Rounding of the operands of products: ``float32`` (none) or ``fp8``."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())  # rounded forward, identity gradient


F32 = Precision("float32")


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN's convolutions and for matrix products."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv(x, kernel, bias=None, stride=1, padding=0, groups=1, prec: Precision = F32):
    """NHWC ``x`` by an HWIO ``kernel`` (the checkpoints' layout)."""
    w = kernel.permute(3, 2, 0, 1)
    y = F.conv2d(_nchw(prec(x)), prec(w), None, stride, padding, 1, groups)
    y = _nhwc(y)
    return y if bias is None else y + bias


def batch_norm(W, name, x):
    """Eval mode: the running statistics of the checkpoint."""
    scale, bias = W[f"params/{name}/scale"], W[f"params/{name}/bias"]
    mean, var = W[f"batch_stats/{name}/mean"], W[f"batch_stats/{name}/var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias


def conv_bn(W, name, x, prec, stride=1, padding=0, groups=1, relu=True):
    y = batch_norm(W, f"{name}/bn", conv(x, W[f"params/{name}/conv/kernel"], None, stride, padding, groups, prec))
    return F.relu(y) if relu else y


def features(W, trunk: Sequence[Sequence[int]], x, prec: Precision = F32):
    """Trunk + neck: ImageNet-normalised NHWC crops → (N, h, w, 256)."""
    x = conv_bn(W, "encoder/stem", x, prec, stride=2, padding=1)
    for i, (e, k, s, c) in enumerate(trunk):
        inp, name = x, f"encoder/block{i}"
        if e != 1:
            x = conv_bn(W, f"{name}/expand", x, prec)
        x = conv_bn(W, f"{name}/dw", x, prec, stride=s, padding=k // 2, groups=x.shape[-1])
        x = conv_bn(W, f"{name}/project", x, prec, relu=False)
        if s == 1 and inp.shape[-1] == c:
            x = x + inp
    return conv_bn(W, "neck/downsample", x, prec, relu=False)


def _sep(W, name, x, prec, bias=True):
    b = (lambda n: W[f"params/{name}/{n}/bias"]) if bias else (lambda n: None)
    x = conv(x, W[f"params/{name}/dw/kernel"], b("dw"), padding=1, groups=x.shape[-1], prec=prec)
    return conv(x, W[f"params/{name}/pw/kernel"], b("pw"), prec=prec)


def _sep_bn_relu(W, name, x, prec, bias=True):
    return F.relu(batch_norm(W, f"{name}/bn", _sep(W, f"{name}/sep", x, prec, bias)))


def _correlate(W, name, z, x, prec):
    """Every template cell dotted with every search position, concatenated
    to the search features and re-encoded."""
    N, H, Wd, C = x.shape
    zf = z.reshape(N, -1, C)
    corr = torch.bmm(prec(x.reshape(N, H * Wd, C)), prec(zf).transpose(1, 2)).reshape(N, H, Wd, -1)
    return _sep_bn_relu(W, f"{name}/enc", torch.cat([x, corr], dim=-1), prec)


def head(W, towernum: int, search, template, update=None, prec: Precision = F32):
    """The BoxTower: (LTRB regression (N, 16, 16, 4), classification logits
    (N, 16, 16, 1)). ``update`` (the dual template) feeds the classification
    branch's correlation in place of ``template``."""
    p = "connect_model"
    cls_z = template if update is None else update
    c = _correlate(W, f"{p}/cls_dw", cls_z, _sep_bn_relu(W, f"{p}/cls_encode", search, prec, bias=False), prec)
    r = _correlate(W, f"{p}/reg_dw", template, _sep_bn_relu(W, f"{p}/reg_encode", search, prec, bias=False), prec)
    for i in range(towernum):
        r = _sep_bn_relu(W, f"{p}/bbox_tower{i}", r, prec)
    for i in range(towernum):
        c = _sep_bn_relu(W, f"{p}/cls_tower{i}", c, prec)
    reg = torch.exp(W[f"params/{p}/adjust"] * _sep(W, f"{p}/bbox_pred", r, prec) + W[f"params/{p}/bias"])
    cls = W[f"params/{p}/cls_scale"] * _sep(W, f"{p}/cls_pred", c, prec)
    return reg, cls
