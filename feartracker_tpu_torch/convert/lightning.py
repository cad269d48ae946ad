"""Reference PyTorch-Lightning checkpoint → the flat variables dict, the
counterpart of ``feartracker_tpu/convert/lightning.py``.

Maps a reference training checkpoint (``FEARLightningModel`` ``.ckpt``)
onto the JAX package's variables tree with '/'-joined keys, real BatchNorm
parameters and running statistics included (the CoreML export has them
folded). The mapping is structural: a state dict keeps module definition
order, so convs and BNs are taken as ordered streams with shape checks and
an architecture mismatch raises ``ValueError``. The reference's name
prefixes (``connect_model.cls_encode....``) locate the head's blocks.
Kernels go to HWIO, as in the JAX tree; ``load_fear_net`` transposes them
back to OIHW.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch

from feartracker_tpu_torch.convert.load import flatten_variables
from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK

# Lightning's hyper-parameter dict (a dict subclass) under the names its
# releases pickle it as
LIGHTNING_DICTS = ("pytorch_lightning.utilities.parsing.AttributeDict",
                   "lightning.fabric.utilities.data.AttributeDict",
                   "lightning_fabric.utilities.data.AttributeDict")


def _kernel_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32)


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise ValueError(f"Lightning state dict: {message} (architecture mismatch: wrong towernum/channels?)")


class _Stream:
    """Ordered (name, array) stream with typed takes."""

    def __init__(self, items: List[Tuple[str, np.ndarray]]):
        self.items = items
        self.i = 0

    def assert_consumed(self, what: str) -> None:
        _check(self.i == len(self.items), f"{what}: {len(self.items) - self.i} unconsumed tensors starting at "
                                          f"{self.peek_name()!r}")

    def peek_name(self) -> str:
        return self.items[self.i][0] if self.i < len(self.items) else "<end>"

    def _next(self, what: str) -> Tuple[str, np.ndarray]:
        _check(self.i < len(self.items), f"expected {what}, the stream ended")
        self.i += 1
        return self.items[self.i - 1]

    def take_conv(self, out_ch: int, kernel: int, bias: bool = False):
        name, w = self._next("a conv")
        _check(name.endswith(".weight") and w.ndim == 4, f"expected a conv at {name}")
        _check(w.shape[0] == out_ch and w.shape[2] == kernel, f"conv {name}: got {w.shape}, want out={out_ch} "
                                                               f"k={kernel}")
        params = {"kernel": _kernel_hwio(w)}
        if bias:
            bname, b = self._next("a conv bias")
            _check(bname.endswith(".bias") and b.ndim == 1, f"expected a conv bias at {bname}")
            params["bias"] = b.astype(np.float32)
        return params

    def take_bn(self, ch: int):
        _check(self.i + 4 <= len(self.items), f"expected a BatchNorm at {self.peek_name()!r}")
        names = [self.items[self.i + k][0] for k in range(4)]
        vals = [self.items[self.i + k][1] for k in range(4)]
        _check(names[0].endswith(".weight") and vals[0].ndim == 1 and vals[0].shape[0] == ch, f"BN {names}")
        _check(names[1].endswith(".bias"), f"BN {names}")
        _check("running_mean" in names[2] and "running_var" in names[3], f"BN {names}")
        self.i += 4
        if self.i < len(self.items) and "num_batches_tracked" in self.items[self.i][0]:
            self.i += 1
        return (
            {"scale": vals[0].astype(np.float32), "bias": vals[1].astype(np.float32)},
            {"mean": vals[2].astype(np.float32), "var": vals[3].astype(np.float32)},
        )


def _conv_bn(stream: _Stream, out: int, kernel: int):
    conv = stream.take_conv(out, kernel, bias=False)
    bn_p, bn_s = stream.take_bn(out)
    return {"conv": conv, "bn": bn_p}, {"bn": bn_s}


def _sep_bn(stream: _Stream, in_ch: int, out: int, use_bias: bool):
    dw = stream.take_conv(in_ch, 3, bias=use_bias)
    pw = stream.take_conv(out, 1, bias=use_bias)
    bn_p, bn_s = stream.take_bn(out)
    return {"sep": {"dw": dw, "pw": pw}, "bn": bn_p}, {"bn": bn_s}


def lightning_to_variables(state_dict: Dict[str, np.ndarray], channels: int = 256,
                           towernum: int = 2) -> Dict[str, np.ndarray]:
    """A reference state dict (``model.`` prefix removed, numpy values) →
    the flat variables dict."""
    enc_items = [(k, v) for k, v in state_dict.items() if k.startswith("encoder.")]
    neck_items = [(k, v) for k, v in state_dict.items() if k.startswith("neck.")]
    head_items = [(k, v) for k, v in state_dict.items() if k.startswith("connect_model.")]

    # encoder: the stem and the 16 blocks, ordered conv/BN pairs; trailing
    # stages the tracker does not use are ignored
    s = _Stream(enc_items)
    enc_p: Dict[str, dict] = {}
    enc_s: Dict[str, dict] = {}
    enc_p["stem"], enc_s["stem"] = _conv_bn(s, 16, 3)
    in_ch = 16
    for i, spec in enumerate(FEAR_XS_TRUNK):
        bp: Dict[str, dict] = {}
        bs: Dict[str, dict] = {}
        ch = in_ch
        if spec.expansion != 1:
            ch = in_ch * spec.expansion
            bp["expand"], bs["expand"] = _conv_bn(s, ch, 1)
        bp["dw"], bs["dw"] = _conv_bn(s, ch, spec.kernel)
        bp["project"], bs["project"] = _conv_bn(s, spec.out_channels, 1)
        enc_p[f"block{i}"], enc_s[f"block{i}"] = bp, bs
        in_ch = spec.out_channels

    s = _Stream(neck_items)
    neck_p, neck_s = _conv_bn(s, channels, 1)
    s.assert_consumed("neck")

    def sub(prefix):
        return _Stream([(k, v) for k, v in head_items if k.startswith(prefix)])

    head_p: Dict[str, dict] = {}
    head_s: Dict[str, dict] = {}
    for name in ("cls_encode", "reg_encode"):
        st = sub(f"connect_model.{name}.")
        head_p[name], head_s[name] = _sep_bn(st, channels, channels, use_bias=False)
        st.assert_consumed(name)
    for name in ("cls_dw", "reg_dw"):
        st = sub(f"connect_model.{name}.")
        p, stt = _sep_bn(st, channels + 64, channels, use_bias=True)
        st.assert_consumed(name)
        head_p[name], head_s[name] = {"enc": p}, {"enc": stt}
    for tower in ("bbox_tower", "cls_tower"):
        st = sub(f"connect_model.{tower}.")
        for i in range(towernum):
            head_p[f"{tower}{i}"], head_s[f"{tower}{i}"] = _sep_bn(st, channels, channels, use_bias=True)
        st.assert_consumed(f"{tower} (towernum={towernum})")
    for pred, out_ch in (("bbox_pred", 4), ("cls_pred", 1)):
        st = sub(f"connect_model.{pred}.")
        dw = st.take_conv(channels, 3, bias=True)
        pw = st.take_conv(out_ch, 1, bias=True)
        st.assert_consumed(pred)
        head_p[pred] = {"dw": dw, "pw": pw}

    head_p["adjust"] = np.asarray(state_dict["connect_model.adjust"], np.float32).reshape(1)
    head_p["bias"] = np.asarray(state_dict["connect_model.bias"], np.float32).reshape(1, 1, 1, 4)
    head_p["cls_scale"] = np.full((1,), 0.1, np.float32)  # the reference's literal 0.1·cls
    return flatten_variables({
        "params": {"encoder": enc_p, "neck": {"downsample": neck_p}, "connect_model": head_p,
                   "template_gate": np.zeros((1,), np.float32)},
        "batch_stats": {"encoder": enc_s, "neck": {"downsample": neck_s}, "connect_model": head_s},
    })


def load_lightning_state_dict(path: str, trust_pickle: bool = False) -> Dict[str, np.ndarray]:
    """The model's state dict of a reference Lightning ``.ckpt`` as numpy,
    the ``model.`` prefix split off at its first dot (the reference's
    ``lstrip("model")`` also ate leading 'm', 'o', 'd', 'e', 'l' of the
    names).

    The checkpoint is read with ``torch.load(weights_only=True)``: tensors,
    containers and plain values, plus Lightning's ``AttributeDict`` of
    hyper-parameters (read back as a dict). One that holds any other object
    raises ``ValueError`` unless ``trust_pickle`` is set, which unpickles it
    in full and so runs whatever code it names: set it only for checkpoints
    you trust."""
    try:
        with torch.serialization.safe_globals([(dict, name) for name in LIGHTNING_DICTS]):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trust_pickle:
            raise ValueError(
                f"{path} holds objects other than tensors and plain values, so it is not unpickled ({e}). If you "
                "trust it, unpickle it in full: --trust_checkpoint, or trust_pickle=True") from e
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in state_dict.items():
        prefix, _, rest = k.partition(".")
        if prefix == "model" and rest:
            out[rest] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def load_from_lightning(path: str, channels: int = 256, towernum: int = 2,
                        trust_pickle: bool = False) -> Dict[str, np.ndarray]:
    """A ``.ckpt`` path → the flat variables dict."""
    return lightning_to_variables(load_lightning_state_dict(path, trust_pickle), channels, towernum)
