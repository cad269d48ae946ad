"""The port's weight importers against the JAX package's, on the CPU.

* ``protowire`` / ``coreml`` on synthetic buffers, as
  ``tests/test_remaining_surfaces.py`` holds JAX's.
* A small synthetic FEAR-XS ``Tracker.mlmodel`` (the FEAR-XS trunk, a
  16-channel neck and head, one tower), written by the protobuf encoder
  below, through JAX's and the port's ``load_fear_xs``: the same flat dict
  bit for bit (FP16 weights included), and the same parsed layers.
* The synthetic reference state dict of ``tests/test_lightning_import.py``
  through both ``lightning_to_variables``: the same flat dict bit for bit,
  then one full-width FEARNet forward of each within atol 1e-5 (the port
  runs torch's convolutions, JAX XLA's); the same through a ``.ckpt`` on
  disk; the wrong-architecture refusal.
* A ``.ckpt`` is read weights-only: Lightning's hyper-parameter dict
  loads, any other object is refused unless the caller opts in.
* ``load_variables`` dispatches as JAX's does (a directory, an Orbax
  checkpoint, is ``tests/test_torch_orbax.py``'s); the default weights lie
  inside the checkout unless ``$FEAR_WEIGHTS`` names others.
"""

import json
import os
import struct
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.convert import coreml as jcoreml
from feartracker_tpu.convert import fear_weights as jfear_weights
from feartracker_tpu.convert import lightning as jlightning
from feartracker_tpu.convert import load as jload
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu_torch.convert import coreml, fear_weights, lightning
from feartracker_tpu_torch.convert import load as L
from feartracker_tpu_torch.convert import protowire as pw
from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from test_lightning_import import _synthetic_reference_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_flat(got, want):
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:6]
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


# -- protobuf encoder for the synthetic .mlmodel ---------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _fv(num, v):
    return _varint(num << 3) + _varint(v)


def _fb(num, data):
    return _varint(num << 3 | 2) + _varint(len(data)) + data


def _ff(num, x):
    return _varint(num << 3 | 5) + struct.pack("<f", x)


def _packed(num, vals):
    return _fb(num, b"".join(_varint(v) for v in vals))


def _weights(arr, f16: bool):
    if f16:
        return _fb(2, arr.astype(np.float16).tobytes())
    return _fb(1, arr.astype("<f4").tobytes())


def _layer(name, body_field, body, inp="x", out="y"):
    return _fb(1, _fb(1, name.encode()) + _fb(2, inp.encode()) + _fb(3, out.encode()) + _fb(body_field, body))


class _Graph:
    """Conv layers in the trace order of the FEAR-XS Tracker graph, seeded
    weights at fan-in scale, FP16 kernels and FP16 or float32 biases (a few
    trunk convs without one), with other layer kinds in between."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.layers = []

    def conv(self, out, kin, k, groups=1, stride=1, trunk=False):
        w = self.rng.randn(out, kin, k, k) / np.sqrt(kin * k * k)
        pad = k // 2
        edge = _fb(10, _fv(1, pad) + _fv(2, pad))
        body = (_fv(1, out) + _fv(2, kin) + _fv(10, groups) + _packed(20, [k, k]) + _packed(30, [stride, stride])
                + _packed(40, [1, 1]) + _fb(50, _fb(1, edge + edge)) + _fb(90, _weights(w, True)))
        r = self.rng.rand()
        if r < 0.8 or not trunk:
            body += _fb(91, _weights(self.rng.randn(out) * 0.1, f16=r < 0.5))
        self.layers.append(_layer(f"conv{len(self.layers)}", 100, body))
        if self.rng.rand() < 0.3:
            self.layers.append(_layer(f"relu{len(self.layers)}", 130, _fb(10, b"")))

    def sep(self, cin, out):
        self.conv(cin, 1, 3, groups=cin)
        self.conv(out, cin, 1)

    def others(self):
        unary = _fv(1, 4) + _ff(2, 1.0) + _ff(5, 1.0)
        scale = _packed(1, [3]) + _fb(2, _weights(np.array([0.5, 0.25, 0.125]), False))
        self.layers += [
            _layer("exp", 220, unary),
            _layer("scale", 245, scale),
            _layer("reshape", 1140, _packed(1, [1, -1, 4])),
            _layer("transpose", 985, _packed(1, [0, 2, 1, 3])),
            _layer("add", 230, b""),
        ]


def _write_mlmodel(path, channels: int, towernum: int, seed: int = 0):
    g = _Graph(seed)
    g.conv(16, 3, 3, stride=2, trunk=True)
    cin = 16
    for spec in FEAR_XS_TRUNK:
        ce = cin * spec.expansion
        if spec.expansion != 1:
            g.conv(ce, cin, 1, trunk=True)
        g.conv(ce, 1, spec.kernel, groups=ce, stride=spec.stride, trunk=True)
        g.conv(spec.out_channels, ce, 1, trunk=True)
        cin = spec.out_channels
    g.conv(channels, cin, 1)
    for _ in range(2):  # cls_encode, reg_encode
        g.sep(channels, channels)
    for _ in range(2):  # cls_dw, reg_dw on [x, corr]
        g.sep(channels + 64, channels)
    for _ in range(towernum):
        g.sep(channels, channels)
    g.sep(channels, 4)
    g.others()
    for _ in range(towernum):
        g.sep(channels, channels)
    g.sep(channels, 1)
    scaler = _ff(10, 1 / 255.0) + _ff(20, -0.406) + _ff(21, -0.456) + _ff(22, -0.485)
    preproc = _fb(2, _fb(1, b"image") + _fb(10, scaler))
    with open(path, "wb") as fh:
        fh.write(_fv(1, 4) + _fb(500, b"".join(g.layers) + preproc))


@pytest.fixture(scope="module")
def mlmodel(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mlmodel") / "Tracker.mlmodel")
    _write_mlmodel(path, channels=16, towernum=1)
    return path


# -- protowire / coreml ------------------------------------------------------------


def test_protowire_truncated_buffer_and_bad_wire_type():
    buf = bytes([0x0A, 0xFF, 0x01]) + b"xy"
    fields = pw.parse(buf)  # a payload promising more bytes than exist is sliced short
    assert fields[0].number == 1 and fields[0].data == b"xy"
    with pytest.raises(ValueError):
        pw.parse(bytes([0x0B]))  # wire type 3 (group) is unsupported
    with pytest.raises(ValueError, match="varint too long"):
        pw.parse(bytes([0x08]) + b"\xff" * 11)


def test_protowire_values():
    fields = pw.parse(_fv(3, 300) + _ff(4, 1.5) + _packed(5, [1, 2**40]) + _fb(6, b"abc"))
    assert pw.first(fields, 3).varint == 300
    assert struct.unpack("<f", pw.first(fields, 4).fixed)[0] == 1.5
    assert pw.packed_uint64(pw.first(fields, 5).data) == [1, 2**40]
    assert pw.first(fields, 6).as_string() == "abc" and pw.first(fields, 9) is None
    assert [f.number for f in pw.all_of(fields + fields, 3)] == [3, 3]
    assert pw.floats_le(struct.pack("<2f", 0.5, -2.0) + b"\x00") == [0.5, -2.0]


def test_parse_mlmodel_rejects_non_nn(tmp_path):
    p = tmp_path / "x.mlmodel"
    p.write_bytes(bytes([0x08, 0x04]))
    with pytest.raises(ValueError, match="no neuralNetwork"):
        coreml.parse_mlmodel(str(p))


def test_parse_mlmodel_matches_jax(mlmodel):
    got, want = coreml.parse_mlmodel(mlmodel), jcoreml.parse_mlmodel(mlmodel)
    assert got["preprocessing"] == want["preprocessing"]
    assert got["preprocessing"]["image"]["channel_scale"] == pytest.approx(1 / 255.0)
    assert len(got["layers"]) == len(want["layers"])
    for a, b in zip(got["layers"], want["layers"]):
        assert (a.name, a.kind, a.inputs, a.outputs) == (b.name, b.kind, b.inputs, b.outputs)
        if a.conv is None:
            assert b.conv is None
            assert a.attrs.keys() == b.attrs.keys()
            for k in a.attrs:
                np.testing.assert_array_equal(a.attrs[k], b.attrs[k])
        else:
            for f in ("out_channels", "kernel_channels", "groups", "kernel_size", "stride", "dilation", "pad"):
                assert getattr(a.conv, f) == getattr(b.conv, f), f
            np.testing.assert_array_equal(a.conv.weights, b.conv.weights)
            assert (a.conv.bias is None) == (b.conv.bias is None)
    kinds = {layer.kind for layer in got["layers"]}
    assert {"conv", "relu", "unary", "scale", "reshape", "transpose", "add"} <= kinds
    reshape = next(layer for layer in got["layers"] if layer.kind == "reshape")
    assert reshape.attrs["target_shape"] == [1, -1, 4]


# -- the CoreML importer -------------------------------------------------------------


def test_load_fear_xs_equals_jax_bit_for_bit(mlmodel):
    got = fear_weights.load_fear_xs(mlmodel, channels=16, towernum=1)
    want = L.flatten_variables(jfear_weights.load_fear_xs(mlmodel, channels=16, towernum=1))
    _assert_same_flat(got, want)
    # it fills a port FEARNet through the one bridge, every key used
    model = L.load_fear_net(FEARNet(adjust_channels=16, towernum=1), got)
    assert model.connect_model.cls_scale.item() == 1.0


def test_load_fear_xs_refuses_the_wrong_graph(tmp_path, mlmodel):
    with pytest.raises(ValueError, match="unconsumed convs|expected"):
        fear_weights.load_fear_xs(mlmodel, channels=16, towernum=2)
    short = str(tmp_path / "short.mlmodel")
    with open(mlmodel, "rb") as fh:
        data = fh.read()
    nn = pw.first(pw.parse(data), 500).data
    layers = pw.all_of(pw.parse(nn), 1)
    with open(short, "wb") as fh:
        fh.write(_fb(500, b"".join(_fb(1, f.data) for f in layers[:20])))
    with pytest.raises(ValueError, match="graph exhausted"):
        fear_weights.load_fear_xs(short, channels=16, towernum=1)


# -- the Lightning importer ------------------------------------------------------------


@pytest.fixture(scope="module")
def state_dict():
    return _synthetic_reference_state_dict(np.random.RandomState(0))


def test_lightning_to_variables_equals_jax_and_runs_the_same(state_dict):
    got = lightning.lightning_to_variables(state_dict)
    want_nested = jlightning.lightning_to_variables(state_dict)
    _assert_same_flat(got, L.flatten_variables(want_nested))
    assert got["params/connect_model/cls_scale"].tolist() == [np.float32(0.1)]

    rng = np.random.RandomState(1)
    search = rng.randint(0, 255, (1, 256, 256, 3)).astype(np.float32) / 64.0 - 2.0
    feats = rng.randn(1, 8, 8, 256).astype(np.float32)
    jmodel = JFEARNet()
    jout = jmodel.apply(want_nested, jnp.asarray(search), jnp.asarray(feats), method=jmodel.track)
    model = L.load_fear_net(FEARNet(), got).eval()
    with torch.no_grad():
        out = model.track(torch.from_numpy(search), torch.from_numpy(feats))
    for key in ("TARGET_REGRESSION_LABEL_KEY", "TARGET_CLASSIFICATION_KEY"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), atol=1e-5, rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, state_dict):
    """A Lightning-shaped .ckpt: ``state_dict`` under ``model.`` names, plus
    keys of other modules."""
    path = str(tmp_path_factory.mktemp("ckpt") / "fear.ckpt")
    sd = {f"model.{k}": torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}
    sd["loss.weight"] = torch.ones(3)  # not the model's: dropped
    torch.save({"state_dict": sd, "epoch": 3}, path)
    return path


def test_lightning_ckpt_on_disk(ckpt, state_dict):
    """The .ckpt through ``load_variables`` equals JAX's
    ``load_from_lightning`` of the same file."""
    path = ckpt
    got = L.load_variables(path)
    _assert_same_flat(got, L.flatten_variables(jlightning.load_from_lightning(path)))
    # the prefix is split at its first dot: names that begin with the
    # letters of "model" keep them
    assert lightning.load_lightning_state_dict(path).keys() == state_dict.keys()


def _foreign_ckpt(tmp_path, state_dict, monkeypatch, module, name):
    """(path, cls): a .ckpt whose ``hyper_parameters`` is a dict subclass
    ``cls`` pickled as ``module.name``, a module that is then gone."""
    parts = [".".join(module.split(".")[:i]) for i in range(1, module.count(".") + 2)]
    for m in parts:
        monkeypatch.setitem(sys.modules, m, types.ModuleType(m))
    cls = type(name, (dict,), {"__module__": module})
    setattr(sys.modules[module], name, cls)
    path = str(tmp_path / f"{name}.ckpt")
    sd = {f"model.{k}": torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}
    torch.save({"state_dict": sd, "hyper_parameters": cls(lr=0.001)}, path)
    for m in parts:
        monkeypatch.delitem(sys.modules, m)
    return path, cls


@pytest.mark.parametrize("module", ["pytorch_lightning.utilities.parsing", "lightning.fabric.utilities.data"])
def test_ckpt_with_lightning_hyper_parameters_loads_weights_only(tmp_path, state_dict, monkeypatch, module):
    path, _ = _foreign_ckpt(tmp_path, state_dict, monkeypatch, module, "AttributeDict")
    _assert_same_flat(L.load_variables(path), lightning.lightning_to_variables(state_dict))


def test_ckpt_with_other_objects_needs_the_opt_in(tmp_path, state_dict, monkeypatch):
    from feartracker_tpu_torch.evaluate import cli

    path, cls = _foreign_ckpt(tmp_path, state_dict, monkeypatch, "reference_config", "Config")
    with pytest.raises(ValueError, match="--trust_checkpoint"):
        L.load_variables(path)
    with pytest.raises(ValueError, match="not unpickled"):
        cli.main(["--device", "cpu", "--weights_path", path, "macs"])
    # opted in, it is unpickled in full, which needs its class importable
    monkeypatch.setitem(sys.modules, "reference_config", types.ModuleType("reference_config"))
    sys.modules["reference_config"].Config = cls
    _assert_same_flat(L.load_variables(path, trust_pickle=True), lightning.lightning_to_variables(state_dict))


def test_eval_cli_takes_a_ckpt(ckpt, capsys):
    from feartracker_tpu_torch.evaluate import cli

    cli.main(["--device", "cpu", "--weights_path", ckpt, "macs"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["params"] == 1_361_324  # FEAR-XS's count, as from fear_xs.npz


def test_lightning_rejects_wrong_architecture(state_dict):
    sd = dict(state_dict)
    sd["neck.downsample.0.weight"] = np.random.RandomState(1).randn(128, 112, 1, 1).astype(np.float32)
    with pytest.raises(ValueError, match="conv neck.downsample.0.weight"):
        lightning.lightning_to_variables(sd)
    with pytest.raises(AssertionError):
        jlightning.lightning_to_variables(sd)
    with pytest.raises(ValueError, match="towernum"):
        lightning.lightning_to_variables(state_dict, towernum=1)


# -- load_variables, default_weights_path ------------------------------------------------


def test_load_variables_dispatch_matches_jax(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr("feartracker_tpu_torch.convert.lightning.load_from_lightning",
                        lambda p, channels, towernum, trust_pickle: calls.append(("ckpt", p, channels, towernum))
                        or {})
    monkeypatch.setattr("feartracker_tpu_torch.convert.fear_weights.load_fear_xs",
                        lambda p, channels, towernum: calls.append(("coreml", p, channels, towernum)) or {})
    jcalls = []
    monkeypatch.setattr("feartracker_tpu.convert.lightning.load_from_lightning",
                        lambda p, channels, towernum: jcalls.append(("ckpt", p, channels, towernum)) or {})
    monkeypatch.setattr("feartracker_tpu.convert.fear_weights.load_fear_xs",
                        lambda p, channels, towernum: jcalls.append(("coreml", p, channels, towernum)) or {})
    for path, kw in (("weights.ckpt", dict(channels=48, towernum=1)), ("Tracker.mlmodel", {}),
                     ("export.bin", dict(channels=32))):
        L.load_variables(path, **kw)
        jload.load_variables(path, **kw)
    assert calls == jcalls == [("ckpt", "weights.ckpt", 48, 1), ("coreml", "Tracker.mlmodel", 256, 2),
                               ("coreml", "export.bin", 32, 2)]
    # a zoo name and an .npz path: the archive, as JAX's nested tree has it
    want = L.flatten_variables(jload.load_variables("fear_xs_gate"))
    _assert_same_flat(L.load_variables("fear_xs_gate"), want)
    _assert_same_flat(L.load_variables(os.path.join(os.path.dirname(L.PACKAGED_FEAR_XS), "fear_xs_gate.npz")), want)


def test_default_weights_path(tmp_path, monkeypatch):
    """Inside the checkout unless the user names other weights; the CLI,
    the demo and the export take it as their default."""
    from feartracker_tpu_torch import demo
    from feartracker_tpu_torch.evaluate import cli

    monkeypatch.delenv(L.WEIGHTS_ENV, raising=False)
    assert L.default_weights_path() == L.PACKAGED_FEAR_XS
    assert os.path.commonpath([L.default_weights_path(), L.REPO_ROOT]) == L.REPO_ROOT
    assert cli.build_parser().parse_args(["macs"]).weights_path == L.PACKAGED_FEAR_XS
    mounted = str(tmp_path / "Tracker.mlmodel")
    monkeypatch.setenv(L.WEIGHTS_ENV, mounted)
    assert L.default_weights_path() == mounted
    assert cli.build_parser().parse_args(["macs"]).weights_path == mounted
    assert not hasattr(demo, "REFERENCE_VIDEO") and not hasattr(L, "REFERENCE_MLMODEL")


def test_export_main_writes_the_f32_pair(tmp_path, capsys):
    """``python -m feartracker_tpu_torch.convert.export`` on the CPU with
    JAX's flags: FEAR-XS from a zoo name, ``--no_quantize``."""
    from feartracker_tpu_torch.convert import export

    out = str(tmp_path / "export")
    export.main(["--weights_path", "fear_xs", "--out_dir", out, "--no_quantize", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res["paths"]) == {"tracker_init", "tracker"}
    assert all(res["bytes"][k] == os.path.getsize(p) > 1_000_000 for k, p in res["paths"].items())
    feats = export.load_exported(res["paths"]["tracker_init"])(torch.zeros(1, 128, 128, 3))
    assert feats.shape == (1, 8, 8, 256) and torch.isfinite(feats).all()
