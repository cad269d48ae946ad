"""Weights bridge of the PyTorch port: every leaf of the packaged zoo
archives lands in the port's FEARNet, and the trunk tables equal the JAX
package's."""

import os

import numpy as np
import pytest
import torch

from feartracker_tpu.convert.load import load_npz_variables
from feartracker_tpu.models import fbnet as jfbnet
from feartracker_tpu.models import fear_net as jfear_net
from feartracker_tpu_torch.convert.load import (
    PACKAGED_FEAR_XS,
    load_fear_net,
    torch_key,
    variables_from_npz,
)
from feartracker_tpu_torch.models import fbnet, fear_net
from feartracker_tpu_torch.models.fear_net import build_family_model

WEIGHTS = os.path.dirname(PACKAGED_FEAR_XS)
ZOO = [
    ("fear_xs", "fear_xs"),
    ("fear_xs_noembs", "fear_xs"),
    ("fear_xs_repo", "fear_xs"),
    ("fear_m_repo", "fear_m"),
    ("fear_l_repo", "fear_l"),  # towernum 3
]


def _as_torch_layout(key, arr):
    arr = np.asarray(arr, np.float32)
    return arr.transpose(3, 2, 0, 1) if key.endswith("/kernel") and arr.ndim == 4 else arr


@pytest.mark.parametrize("archive,family", ZOO)
def test_every_leaf_consumed(archive, family):
    flat = variables_from_npz(os.path.join(WEIGHTS, f"{archive}.npz"))
    model = load_fear_net(build_family_model(family), flat)
    state = model.state_dict()
    wanted = {k for k in state if not k.endswith("num_batches_tracked")}
    assert {torch_key(k) for k in flat} == wanted  # none missing, none left over
    for key, arr in flat.items():
        np.testing.assert_array_equal(state[torch_key(key)].numpy(), _as_torch_layout(key, arr))


def test_fear_xs_archive_size_and_scalars():
    flat = variables_from_npz(PACKAGED_FEAR_XS)
    assert len(flat) == 307
    model = load_fear_net(build_family_model("fear_xs"), flat)
    cm = model.connect_model
    assert tuple(cm.bias.shape) == (1, 1, 1, 4)
    np.testing.assert_array_equal(cm.cls_scale.detach().numpy(), flat["params/connect_model/cls_scale"])
    np.testing.assert_array_equal(cm.adjust.detach().numpy(), flat["params/connect_model/adjust"])
    np.testing.assert_array_equal(model.template_gate.detach().numpy(), flat["params/template_gate"])


def test_depthwise_and_pointwise_layouts():
    flat = variables_from_npz(PACKAGED_FEAR_XS)
    model = load_fear_net(build_family_model("fear_xs"), flat)
    dw = flat["params/encoder/block1/dw/conv/kernel"]  # (3,3,1,96)
    w = model.encoder.block1.dw.conv.weight.detach().numpy()  # (96,1,3,3)
    assert w.shape == (96, 1, 3, 3)
    np.testing.assert_array_equal(w[7, 0], dw[:, :, 0, 7])
    pw = flat["params/encoder/block1/project/conv/kernel"]  # (1,1,96,24)
    w = model.encoder.block1.project.conv.weight.detach().numpy()  # (24,96,1,1)
    np.testing.assert_array_equal(w[5, :, 0, 0], pw[0, 0, :, 5])


def test_nested_variables_match_flat():
    nested = load_npz_variables(PACKAGED_FEAR_XS)  # the JAX loader's pytree
    a = load_fear_net(build_family_model("fear_xs"), nested).state_dict()
    b = load_fear_net(build_family_model("fear_xs"), variables_from_npz(PACKAGED_FEAR_XS)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_missing_leftover_and_shape_mismatch_raise():
    flat = variables_from_npz(PACKAGED_FEAR_XS)
    missing = dict(flat)
    missing.pop("params/neck/downsample/bn/scale")
    with pytest.raises(KeyError, match="missing"):
        load_fear_net(build_family_model("fear_xs"), missing)
    extra = dict(flat, **{"params/encoder/block99/dw/conv/kernel": np.zeros((3, 3, 1, 4))})
    with pytest.raises(KeyError, match="block99"):
        load_fear_net(build_family_model("fear_xs"), extra)
    with pytest.raises(ValueError, match="shape"):
        load_fear_net(build_family_model("fear_m"), flat)


def test_trunk_tables_match_reference():
    assert set(fbnet.TRUNKS) == set(jfbnet.TRUNKS)
    for name, blocks in fbnet.TRUNKS.items():
        assert [tuple(b) for b in blocks] == [tuple(b) for b in jfbnet.TRUNKS[name]], name
    assert fear_net.FAMILY_TOWERNUM == jfear_net.FAMILY_TOWERNUM


def test_bare_zoo_names_resolve_like_jax(tmp_path):
    """A bare zoo name is the packaged archive (as JAX ``load_variables``
    resolves it); anything else passes through unchanged."""
    from feartracker_tpu.convert.load import load_variables
    from feartracker_tpu_torch.convert.load import resolve_weights

    assert resolve_weights("fear_xs_gate") == os.path.join(WEIGHTS, "fear_xs_gate.npz")
    assert os.path.samefile(resolve_weights("fear_xs"), PACKAGED_FEAR_XS)
    assert resolve_weights("no_such_model") == "no_such_model"
    assert resolve_weights(str(tmp_path / "fear_xs")) == str(tmp_path / "fear_xs")
    ours = variables_from_npz("fear_xs_gate")
    ref = load_variables("fear_xs_gate")
    np.testing.assert_array_equal(ours["params/template_gate"], ref["params"]["template_gate"])
    assert ours["params/template_gate"][0] != 0.0  # the trained gate, not the zero fill
