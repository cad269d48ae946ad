"""CoreML ``.mlmodel`` reader: recover the trained FEAR-XS layers + weights.
The port's own copy of ``feartracker_tpu/convert/coreml.py``.

The reference repo ships its released FEAR-XS-NoEmbs weights only inside two
CoreML graphs (ref: evaluate/FEARDemo/FEARDemo/TrackerInit.mlmodel — template
128² → features (1,256,8,8); Tracker.mlmodel — search 256² + features →
(bbox, cls) maps; produced by evaluate/coreml_convert.py:13-57). This module
parses them with the schema-free wire reader and assigns meaning using
CoreML's public NeuralNetwork field numbers.

Notes discovered from the files themselves (and used by the weight mapping):
  * spec v4; weights are FP16 (``WeightParams.float16Value``), layout OIHW.
  * BatchNorm was folded into conv weight+bias by the coremltools conversion,
    so every conv carries a bias and no BN layers exist.
  * ``exp(adjust·x + bias)`` of the reference BoxTower (blocks.py:187-188) was
    folded into the final reg conv; the exp layer is a plain unary EXP.
  * ImageNet normalization = ImageScaler bias (−mean·255) + a ``scale_layer``
    multiplying by 1/(255·std) (evaluate/coreml_utils.py:61-135).
  * conv padding is explicit ValidPadding border amounts — torch-style
    symmetric (k//2), NOT XLA 'SAME' (asymmetric for stride 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from feartracker_tpu_torch.convert import protowire as pw

# NeuralNetworkLayer oneof field numbers observed in the FEAR exports.
LAYER_CONV = 100
LAYER_ACTIVATION = 130
LAYER_SOFTMAX = 210
LAYER_UNARY = 220
LAYER_ADD = 230
LAYER_SCALE = 245
LAYER_CONCAT = 320
LAYER_TRANSPOSE = 985
LAYER_BATCHED_MATMUL = 1045
LAYER_RESHAPE_STATIC = 1140

LAYER_TYPE_NAMES = {
    LAYER_CONV: "conv",
    LAYER_ACTIVATION: "relu",
    LAYER_UNARY: "unary",
    LAYER_ADD: "add",
    LAYER_SCALE: "scale",
    LAYER_CONCAT: "concat",
    LAYER_TRANSPOSE: "transpose",
    LAYER_BATCHED_MATMUL: "batched_matmul",
    LAYER_RESHAPE_STATIC: "reshape",
}


@dataclass
class ConvParams:
    out_channels: int
    kernel_channels: int  # in_channels / groups
    groups: int
    kernel_size: Tuple[int, int]
    stride: Tuple[int, int]
    dilation: Tuple[int, int]
    pad: Tuple[int, int, int, int]  # (top, bottom, left, right)
    weights: np.ndarray  # (O, I/g, kH, kW) float32
    bias: Optional[np.ndarray]  # (O,) float32


@dataclass
class Layer:
    name: str
    kind: str
    inputs: List[str]
    outputs: List[str]
    conv: Optional[ConvParams] = None
    # generic attrs for non-conv layers
    attrs: Dict[str, object] = field(default_factory=dict)


def _weight_array(wp_fields: List[pw.Field]) -> np.ndarray:
    """WeightParams: floatValue=1 (packed f32), float16Value=2 (bytes)."""
    f32 = pw.first(wp_fields, 1)
    if f32 is not None:
        return np.asarray(pw.floats_le(f32.data), dtype=np.float32)
    f16 = pw.first(wp_fields, 2)
    if f16 is not None:
        return np.frombuffer(f16.data, dtype=np.float16).astype(np.float32)
    raise ValueError("WeightParams with no float payload")


def _uints(f: pw.Field) -> List[int]:
    if f.data is not None:
        return pw.packed_uint64(f.data)
    return [f.varint]


def _parse_conv(tf: pw.Field) -> ConvParams:
    sub = tf.as_message()
    out_c = kin = groups = 1
    ksize: List[int] = []
    stride: List[int] = []
    dil: List[int] = []
    pad = (0, 0, 0, 0)
    weights = bias = None
    for f in sub:
        if f.number == 1:
            out_c = f.varint
        elif f.number == 2:
            kin = f.varint
        elif f.number == 10:
            groups = f.varint
        elif f.number == 20:
            ksize += _uints(f)
        elif f.number == 30:
            stride += _uints(f)
        elif f.number == 40:
            dil += _uints(f)
        elif f.number == 50:  # ValidPadding{ paddingAmounts: BorderAmounts }
            ba = pw.first(f.as_message(), 1)
            amounts = []
            if ba is not None:
                # BorderAmounts.borderAmounts: repeated EdgeSizes{start=1,end=2}
                for edge in pw.all_of(ba.as_message(), 10):
                    es = edge.as_message()
                    s = pw.first(es, 1)
                    e = pw.first(es, 2)
                    amounts.append((s.varint if s else 0, e.varint if e else 0))
            while len(amounts) < 2:
                amounts.append((0, 0))
            pad = (amounts[0][0], amounts[0][1], amounts[1][0], amounts[1][1])
        elif f.number == 51:  # SamePadding — not produced by this exporter
            pad = ("same",) * 4  # type: ignore[assignment]
        elif f.number == 90:
            weights = _weight_array(f.as_message())
        elif f.number == 91:
            bias = _weight_array(f.as_message())
    ksize = ksize or [3, 3]
    stride = stride or [1, 1]
    dil = dil or [1, 1]
    w = weights.reshape(out_c, kin, ksize[0], ksize[1])
    return ConvParams(
        out_channels=out_c,
        kernel_channels=kin,
        groups=groups,
        kernel_size=(ksize[0], ksize[1]),
        stride=(stride[0], stride[1]),
        dilation=(dil[0], dil[1]),
        pad=pad,
        weights=w,
        bias=bias,
    )


def _parse_generic(kind: str, tf: pw.Field) -> Dict[str, object]:
    attrs: Dict[str, object] = {}
    sub = tf.as_message()
    if kind == "reshape":
        f = pw.first(sub, 1)
        shape = [v if v < 2**63 else v - 2**64 for v in pw.packed_uint64(f.data)]
        attrs["target_shape"] = shape
    elif kind == "transpose":
        attrs["axes"] = pw.packed_uint64(pw.first(sub, 1).data)
    elif kind == "unary":
        # UnaryFunctionLayerParams: type=1, alpha=2, epsilon=3, shift=4, scale=5
        import struct

        for f in sub:
            if f.number == 1:
                attrs["type"] = f.varint  # 4 == EXP
            elif f.fixed is not None and len(f.fixed) == 4:
                attrs[{2: "alpha", 3: "epsilon", 4: "shift", 5: "scale"}.get(f.number, f.number)] = struct.unpack("<f", f.fixed)[0]
    elif kind == "scale":
        shape = pw.packed_uint64(pw.first(sub, 1).data)
        attrs["shape_scale"] = shape
        attrs["scale"] = _weight_array(pw.first(sub, 2).as_message())
    return attrs


def parse_mlmodel(path: str) -> Dict[str, object]:
    """Parse an .mlmodel into {'layers': [Layer], 'preprocessing': {...},
    'inputs': [...], 'outputs': [...]}."""
    with open(path, "rb") as fh:
        buf = fh.read()
    top = pw.parse(buf)
    nn_field = pw.first(top, 500)
    if nn_field is None:
        raise ValueError(f"{path}: no neuralNetwork (field 500) found")
    nn = nn_field.as_message()

    layers: List[Layer] = []
    for lf in pw.all_of(nn, 1):
        sub = lf.as_message()
        name = pw.first(sub, 1).as_string()
        inputs = [x.as_string() for x in pw.all_of(sub, 2)]
        outputs = [x.as_string() for x in pw.all_of(sub, 3)]
        tf = next(f for f in sub if f.number >= 100)
        kind = LAYER_TYPE_NAMES.get(tf.number, f"type{tf.number}")
        layer = Layer(name=name, kind=kind, inputs=inputs, outputs=outputs)
        if tf.number == LAYER_CONV:
            layer.conv = _parse_conv(tf)
        elif tf.number == LAYER_ACTIVATION:
            inner = [g.number for g in tf.as_message()]
            layer.kind = {10: "relu", 5: "linear_activation"}.get(inner[0] if inner else 10, "relu")
        else:
            layer.attrs = _parse_generic(layer.kind, tf)
        layers.append(layer)

    # image preprocessing: NeuralNetwork.preprocessing (field 2):
    # NeuralNetworkPreprocessing{featureName=1, scaler=10{channelScale=10,
    # blueBias=20, greenBias=21, redBias=22}}
    import struct

    preproc: Dict[str, Dict[str, float]] = {}
    for f in pw.all_of(nn, 2):
        sub = f.as_message()
        feat = pw.first(sub, 1)
        scaler = pw.first(sub, 10)
        if scaler is None:
            continue
        vals = {}
        for g in scaler.as_message():
            if g.fixed is not None and len(g.fixed) == 4:
                key = {10: "channel_scale", 20: "blue_bias", 21: "green_bias", 22: "red_bias"}.get(g.number)
                if key:
                    vals[key] = struct.unpack("<f", g.fixed)[0]
        preproc[feat.as_string() if feat else "image"] = vals

    return {"layers": layers, "preprocessing": preproc}


def conv_layers(layers: List[Layer]) -> List[Layer]:
    return [l for l in layers if l.kind == "conv"]
