"""The port's classification pretraining
(``feartracker_tpu_torch/tools/pretrain_trunk.py``) against the JAX tool:
fear_tiny at 32², B=8, 2 epochs on one JPEG ImageFolder written by the JAX
class generator, the port started from JAX's initial variables (the
``load_classifier`` bridge), both float32 on the CPU.

Tolerances. Per-epoch loss rtol 1e-5 and equal accuracy (measured 2e-7).
The exported trunk: the same keys, shapes and dtypes; each array within 1e-3
of its own largest |value| (measured 3.3e-4: Adam divides each gradient by
its own running scale, so an element whose gradient crosses zero during the
12 steps takes a step of up to ±lr on either side by the rounding of that
gradient alone). Three leaves get a bound of their own: a BatchNorm bias
feeding the next block's 1×1 expand conv and its train-mode BatchNorm has a
gradient that is rounding noise on both sides (the BatchNorm removes any
per-channel shift), so Adam moves it by up to lr a step in a direction the
rounding picks: |gap| ≤ 2·lr·steps; the running mean of that next BatchNorm
sees the shift through the conv: |gap| ≤ 2·lr·steps·(the conv's largest
row L1 norm). The transfer into FEARNet reports the same leaves on both
sides."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import tools.make_class_dataset as jax_cls
import tools.pretrain_trunk as jax_pretrain
from feartracker_tpu.convert.load import transfer_variables as jax_transfer
from feartracker_tpu.models.fbnet import TRUNKS as JAX_TRUNKS
from feartracker_tpu.models.fear_net import FEARNet as JaxFEARNet
from feartracker_tpu_torch.convert.load import transfer_variables, variables_of
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tools import pretrain_trunk
from torch_tool_parity import one_thread  # noqa: F401  (a module fixture)

SIZE, BATCH, EPOCHS, LR = 32, 8, 2, 1e-3
LOSS_RTOL = 1e-5
ARRAY_TOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain")
    classes = str(root / "classes")
    jax_cls.generate_classes(classes, per_class=4, size=40, seed=0)  # 48 JPEGs, resized to 32²
    n = len(os.listdir(classes))
    jmodel = jax_pretrain.make_classifier("fear_tiny", n)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    flat_init = {"/".join(k): np.asarray(v) for k, v in flatten_dict(jax.tree.map(np.asarray, dict(init))).items()}
    want = jax_pretrain.train(classes, "fear_tiny", str(root / "jax.npz"), epochs=EPOCHS, batch_size=BATCH,
                              image_size=SIZE, lr=LR, seed=0)
    got = pretrain_trunk.run(classes, "fear_tiny", str(root / "port.npz"), epochs=EPOCHS, batch_size=BATCH,
                             image_size=SIZE, lr=LR, seed=0, device="cpu", init_variables=flat_init)
    with np.load(root / "jax.npz") as zj, np.load(root / "port.npz") as zp:
        arrays = ({k: zj[k] for k in zj.files}, {k: zp[k] for k in zp.files})
    return want, got, arrays, flat_init, jmodel, classes


def test_losses_and_accuracy_equal_jax(runs):
    want, got = runs[:2]
    assert got["classes"] == want["classes"] and got["arrays"] == want["arrays"]
    assert got["steps"] == EPOCHS * (48 // BATCH)
    for g, w in zip(got["history"], want["history"], strict=True):
        assert g["epoch"] == w["epoch"] and g["acc"] == w["acc"]
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), (g, w)


def _noise_bounds(jax_arrays):
    """The leaves whose gradient is rounding noise, and their bounds."""
    steps = EPOCHS * (48 // BATCH)
    bias_bound = 2 * LR * steps
    bounds = {}
    for i, spec in enumerate(TINY_TRUNK[1:], start=1):
        if spec.expansion > 1:
            bounds[f"params/encoder/block{i - 1}/project/bn/bias"] = bias_bound
            kernel = jax_arrays[f"params/encoder/block{i}/expand/conv/kernel"][0, 0]  # (Cin, Cout)
            bounds[f"batch_stats/encoder/block{i}/expand/bn/mean"] = bias_bound * float(np.abs(kernel).sum(0).max())
    return bounds


def test_exported_trunk_equals_jax(runs):
    jax_arrays, port_arrays = runs[2]
    assert sorted(port_arrays) == sorted(jax_arrays)
    assert all(k.split("/")[1] == "encoder" for k in port_arrays)
    bounds = _noise_bounds(jax_arrays)
    assert len(bounds) == 4
    for k, w in jax_arrays.items():
        g = port_arrays[k]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        gap = float(np.abs(g - w).max())
        assert gap <= bounds.get(k, ARRAY_TOL * float(np.abs(w).max())), (k, gap, np.abs(w).max())


def test_transfer_report_equals_jax(runs):
    jax_arrays, port_arrays = runs[2]
    jnet = JaxFEARNet(trunk_blocks=JAX_TRUNKS["fear_tiny"], adjust_channels=24, towernum=1)
    jinit = jnet.init(jax.random.PRNGKey(1), (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 64, 3))))
    _, want = jax_transfer(_nest(jax_arrays), jax.tree.map(np.asarray, dict(jinit)))  # JAX's loader nests
    port_net = FEARNet(trunk_blocks=TINY_TRUNK, adjust_channels=24, towernum=1, template_size=32)
    _, got = transfer_variables(port_arrays, variables_of(port_net))
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    assert got["transferred"] and not got["skipped_shape"] and not got["unused"]


def test_bridge_gives_jax_logits(runs):
    """The JAX classifier's initial variables in the port's classifier: the
    same logits in eval mode."""
    flat_init, jmodel, classes = runs[3:]
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, _nest(flat_init)), jnp.asarray(x), train=False))
    model = pretrain_trunk.TrunkClassifier("fear_tiny", len(os.listdir(classes)))
    pretrain_trunk.load_classifier(model, flat_init)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def test_main_exports_and_refuses_a_missing_card(tmp_path, capsys):
    jax_cls.generate_classes(str(tmp_path / "c"), per_class=1, size=32, seed=0)
    pretrain_trunk.main(["--data", str(tmp_path / "c"), "--trunk", "fear_tiny", "--out", str(tmp_path / "t.npz"),
                         "--epochs", "1", "--batch_size", "4", "--image_size", "32", "--device", "cpu"])
    assert "cpu" in capsys.readouterr().out.splitlines()[0]
    with np.load(tmp_path / "t.npz") as z:
        assert z.files and all("encoder" in k for k in z.files)
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_trunk.main(["--data", str(tmp_path / "c"), "--out", str(tmp_path / "u.npz"), "--device", "cuda"])


def test_mixed_format_folder_matches_jax(tmp_path):
    """An ImageFolder whose files cv2 reads by their signature, not their
    suffix (ImageNet holds a PNG named ``.JPEG`` and CMYK JPEGs): baseline,
    CMYK, YCCK, 4:1:1 and block-smoothed progressive JPEGs, a PNG, a PNG
    named ``.JPEG`` and a BMP named ``.jpg``, through both tools from the
    same initial variables: the same per-epoch loss (``LOSS_RTOL``) and
    accuracy."""
    import sys

    import cv2

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures"))
    import make_host_io_fixtures as W

    from feartracker_tpu_torch.train.summary import encode_png

    folder = tmp_path / "mixed"
    for k in range(2):
        cls = folder / f"class{k}"
        cls.mkdir(parents=True)
        img = W._img(300 + k, 40, 48)
        four = W._img(310 + k, 40, 48, 4)
        files = {
            "baseline.jpg": cv2.imencode(".jpg", img[..., ::-1])[1].tobytes(),
            "cmyk.jpg": W._pil_cmyk(four, 90),
            "ycck.jpg": W.jpeg_baseline(W.sub_planes(four, [(1, 1)] * 4), [(1, 1)] * 4, adobe=2),
            "s411.jpg": W.jpeg_baseline(W.sub_planes(img, [(4, 1), (1, 1), (1, 1)]), [(4, 1), (1, 1), (1, 1)],
                                        jfif=True),
            "smoothed.jpg": W.keep_scans(W._cv2_progressive(img), lambda i, ah: ah == 0),
            "plain.png": encode_png(img),
            "png_named.JPEG": encode_png(img[::-1]),
            "bmp_named.jpg": W.bmp(img[:, ::-1], 24),
        }
        for name, data in files.items():
            (cls / name).write_bytes(data)
    jmodel = jax_pretrain.make_classifier("fear_tiny", 2)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)  # the JAX tool's seed 0
    flat_init = {"/".join(k): np.asarray(v) for k, v in flatten_dict(jax.tree.map(np.asarray, dict(init))).items()}
    kw = dict(epochs=1, batch_size=4, image_size=SIZE, lr=LR, seed=0)
    want = jax_pretrain.train(str(folder), "fear_tiny", str(tmp_path / "jax.npz"), **kw)
    got = pretrain_trunk.run(str(folder), "fear_tiny", str(tmp_path / "port.npz"), device="cpu",
                             init_variables=flat_init, **kw)
    assert got["steps"] == 4 and len(got["history"]) == len(want["history"]) == 1
    for g, w in zip(got["history"], want["history"], strict=True):
        assert g["acc"] == w["acc"]
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), (g, w)
