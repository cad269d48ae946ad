"""CoreML-recovered FEAR-XS weights → the flat variables dict, the
counterpart of ``feartracker_tpu/convert/fear_weights.py``.

The reference's CoreML export (``Tracker.mlmodel``) stores BN-folded convs,
so every conv here receives its kernel and bias and every BatchNorm is an
exact identity (scale 1, bias 0, mean 0, var 1 − eps, so that
sqrt(var + eps) == 1). The trunk's convs and the bias-less SepConvs carry
no bias of their own: the exporter's folded bias rides on the identity BN's
beta, which is the same arithmetic. The head's output affines were folded
too: ``exp(adjust·x + bias)`` → adjust 1, bias 0; ``0.1·cls`` → cls_scale 1.

The convs come in the graph's trace order; the mapping walks it
structurally and checks every shape, so a wrong graph fails loudly. The
result is the JAX importer's tree with '/'-joined keys, HWIO kernels
included, which :func:`feartracker_tpu_torch.convert.load.load_fear_net`
takes like any other source.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from feartracker_tpu_torch.convert.coreml import ConvParams, conv_layers, parse_mlmodel
from feartracker_tpu_torch.convert.load import flatten_variables
from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK

BN_EPS = 1e-5


def _kernel_hwio(c: ConvParams) -> np.ndarray:
    """OIHW → HWIO (a depthwise (C,1,kh,kw) → (kh,kw,1,C)), as the JAX tree
    holds kernels; ``load_fear_net`` transposes them back."""
    return np.ascontiguousarray(c.weights.transpose(2, 3, 1, 0)).astype(np.float32)


def _identity_bn(channels: int):
    params = {"scale": np.ones((channels,), np.float32), "bias": np.zeros((channels,), np.float32)}
    stats = {"mean": np.zeros((channels,), np.float32), "var": np.full((channels,), 1.0 - BN_EPS, np.float32)}
    return params, stats


class _ConvStream:
    def __init__(self, convs: List[ConvParams]):
        self.convs = convs
        self.idx = 0

    def take(self, out_channels: int, kernel: int, groups: int = 1) -> ConvParams:
        if self.idx >= len(self.convs):
            raise ValueError(f"graph exhausted after {self.idx} convs: wrong .mlmodel for this loader? "
                             "(it needs the full Tracker graph, not TrackerInit)")
        c = self.convs[self.idx]
        if (c.out_channels, c.kernel_size[0], c.groups) != (out_channels, kernel, groups):
            raise ValueError(f"conv #{self.idx}: expected (out={out_channels}, k={kernel}, g={groups}), "
                             f"got (out={c.out_channels}, k={c.kernel_size[0]}, g={c.groups})")
        self.idx += 1
        return c


def _conv_bn(stream: _ConvStream, out: int, kernel: int, groups: int = 1):
    """One ConvBNAct: the folded conv and an identity BN carrying its bias."""
    c = stream.take(out, kernel, groups)
    bn_p, bn_s = _identity_bn(out)
    if c.bias is not None:
        bn_p["bias"] = c.bias.astype(np.float32)
    return {"conv": {"kernel": _kernel_hwio(c)}, "bn": bn_p}, {"bn": bn_s}


def _sep_conv(stream: _ConvStream, in_ch: int, out: int, kernel: int = 3):
    dw = stream.take(in_ch, kernel, groups=in_ch)
    pw = stream.take(out, 1, groups=1)
    params = {"dw": {"kernel": _kernel_hwio(dw)}, "pw": {"kernel": _kernel_hwio(pw)}}
    if dw.bias is not None:
        params["dw"]["bias"] = dw.bias.astype(np.float32)
    if pw.bias is not None:
        params["pw"]["bias"] = pw.bias.astype(np.float32)
    return params


def _sep_bn_relu(stream: _ConvStream, in_ch: int, out: int, kernel: int = 3, use_bias: bool = True):
    """SepConv + BN + ReLU. Where the reference's SepConv had no bias (the
    encode blocks), the exporter still folded BN into the pointwise bias:
    the identity BN's beta carries it."""
    sep = _sep_conv(stream, in_ch, out, kernel)
    bn_p, bn_s = _identity_bn(out)
    if not use_bias:
        pw_bias = sep["pw"].pop("bias", None)
        sep["dw"].pop("bias", None)
        if pw_bias is not None:
            bn_p["bias"] = pw_bias
    return {"sep": sep, "bn": bn_p}, {"bn": bn_s}


def _trunk_and_neck(stream: _ConvStream, adjust_channels: int = 256):
    enc_params: Dict[str, dict] = {}
    enc_stats: Dict[str, dict] = {}
    enc_params["stem"], enc_stats["stem"] = _conv_bn(stream, 16, 3)
    in_ch = 16
    for i, spec in enumerate(FEAR_XS_TRUNK):
        bp: Dict[str, dict] = {}
        bs: Dict[str, dict] = {}
        ch = in_ch
        if spec.expansion != 1:
            ch = in_ch * spec.expansion
            bp["expand"], bs["expand"] = _conv_bn(stream, ch, 1)
        bp["dw"], bs["dw"] = _conv_bn(stream, ch, spec.kernel, groups=ch)
        bp["project"], bs["project"] = _conv_bn(stream, spec.out_channels, 1)
        enc_params[f"block{i}"], enc_stats[f"block{i}"] = bp, bs
        in_ch = spec.out_channels
    neck_p, neck_s = _conv_bn(stream, adjust_channels, 1)
    return enc_params, enc_stats, {"downsample": neck_p}, {"downsample": neck_s}


def load_fear_xs(tracker_path: str, channels: int = 256, towernum: int = 2) -> Dict[str, np.ndarray]:
    """The flat variables dict (``{"params/...", "batch_stats/..."}``) of
    FEAR-XS from the Tracker ``.mlmodel``, which holds the trunk, neck and
    head."""
    tracker = parse_mlmodel(tracker_path)
    stream = _ConvStream([layer.conv for layer in conv_layers(tracker["layers"])])
    enc_p, enc_s, neck_p, neck_s = _trunk_and_neck(stream, channels)

    head_p: Dict[str, dict] = {}
    head_s: Dict[str, dict] = {}
    corr_ch = channels + 64  # the correlation volume adds the template's 8·8 cells
    for name in ("cls_encode", "reg_encode"):
        head_p[name], head_s[name] = _sep_bn_relu(stream, channels, channels, use_bias=False)
    for name in ("cls_dw", "reg_dw"):
        p, s = _sep_bn_relu(stream, corr_ch, channels)
        head_p[name], head_s[name] = {"enc": p}, {"enc": s}
    for i in range(towernum):
        head_p[f"bbox_tower{i}"], head_s[f"bbox_tower{i}"] = _sep_bn_relu(stream, channels, channels)
    head_p["bbox_pred"] = _sep_conv(stream, channels, 4)
    for i in range(towernum):
        head_p[f"cls_tower{i}"], head_s[f"cls_tower{i}"] = _sep_bn_relu(stream, channels, channels)
    head_p["cls_pred"] = _sep_conv(stream, channels, 1)
    if stream.idx != len(stream.convs):
        raise ValueError(f"unconsumed convs: {stream.idx} of {len(stream.convs)}")

    # the output affines were folded into the convs by the exporter
    head_p["adjust"] = np.ones((1,), np.float32)
    head_p["bias"] = np.zeros((1, 1, 1, 4), np.float32)
    head_p["cls_scale"] = np.ones((1,), np.float32)
    return flatten_variables({
        "params": {"encoder": enc_p, "neck": neck_p, "connect_model": head_p,
                   "template_gate": np.zeros((1,), np.float32)},
        "batch_stats": {"encoder": enc_s, "neck": neck_s, "connect_model": head_s},
    })
