"""The port's gate v2 (``models/gate.py``) against the JAX package's on the
CPU: observables and rates on random inputs within 1e-5 (float32 sums in
other orders), parameter draws and the on-disk format identical."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.models import gate as jgate
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS
from feartracker_tpu_torch.models import gate

FEATURE_GATE = os.path.join(os.path.dirname(PACKAGED_FEAR_XS), "fear_xs_feature_gate.npz")


def _random_observable_inputs(seed, S=5):
    rng = np.random.RandomState(seed)
    conf = rng.rand(S).astype(np.float32)
    apce = (rng.rand(S) * 60).astype(np.float32)
    cand, tmpl, dyn = rng.randn(3, S, 4, 4, 8).astype(np.float32)
    bbox = np.concatenate([rng.rand(S, 2) * 100, rng.rand(S, 2) * 60 + 3], -1).astype(np.float32)
    prev = np.concatenate([rng.rand(S, 2) * 100, rng.rand(S, 2) * 60 + 3], -1).astype(np.float32)
    # a stream whose box did not move, and one that jumped far (clip bounds)
    prev[0] = bbox[0]
    prev[1, 2:] = bbox[1, 2:] * 20.0
    return conf, apce, cand, tmpl, dyn, bbox, prev


def test_contract_matches_jax():
    assert gate.OBS_FEATURES == jgate.OBS_FEATURES
    assert gate.N_OBS == jgate.N_OBS == 6
    assert gate.DEFAULT_HIDDEN == jgate.DEFAULT_HIDDEN
    ours = gate.init_gate_params(np.random.RandomState(3), hidden=5)
    ref = jgate.init_gate_params(np.random.RandomState(3), hidden=5)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_observables_match_jax(seed):
    args = _random_observable_inputs(seed)
    ref = np.asarray(jgate.gate_observables(*map(jnp.asarray, args)))
    got = gate.gate_observables(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, gate.N_OBS)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the clip bounds are part of the contract
    assert got[1, 4] == -1.0 and got[0, 4] == 0.0 and got[0, 5] == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_rate_and_logit_match_jax(seed):
    rng = np.random.RandomState(seed)
    params = gate.init_gate_params(rng)
    params["b1"] = rng.randn(*params["b1"].shape).astype(np.float32)
    params["b2"] = rng.randn(1).astype(np.float32)
    obs = rng.randn(7, gate.N_OBS).astype(np.float32)
    for ours, ref in ((gate.gate_rate, jgate.gate_rate), (gate.gate_logit, jgate.gate_logit)):
        want = np.asarray(ref(params, jnp.asarray(obs)))
        # numpy parameters and tensors on the device give the same result
        for p in (params, gate.gate_params_to(params, "cpu")):
            got = ours(p, torch.from_numpy(obs)).numpy()
            assert got.shape == (7,)
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_cosine_matches_jax_in_bfloat16():
    """Cosines are taken in float32 whatever the features' dtype."""
    rng = np.random.RandomState(4)
    a, b = rng.randn(2, 3, 2, 2, 16).astype(np.float32)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    ref = np.asarray(jgate._cosine(jnp.asarray(ta.float().numpy()), jnp.asarray(tb.float().numpy())))
    got = gate._cosine(ta, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_load_packaged_feature_gate():
    ours = gate.load_gate(FEATURE_GATE)
    ref = jgate.load_gate(FEATURE_GATE)
    assert ours.keys() == ref.keys() == set(gate.GATE_KEYS)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert ours["w1"].shape[0] == gate.N_OBS
    obs = np.random.RandomState(5).rand(4, gate.N_OBS).astype(np.float32)
    np.testing.assert_allclose(gate.gate_rate(ours, torch.from_numpy(obs)).numpy(),
                               np.asarray(jgate.gate_rate(ref, jnp.asarray(obs))), atol=1e-5)


def test_save_load_round_trip_and_obs_count_error(tmp_path):
    params = gate.init_gate_params(np.random.RandomState(6))
    path = str(tmp_path / "gate.npz")
    gate.save_gate(gate.gate_params_to(params, "cpu"), path)  # tensors save too
    loaded = gate.load_gate(path)
    for k in params:
        np.testing.assert_array_equal(loaded[k], params[k])
    # the JAX package reads what the port writes
    for k, v in jgate.load_gate(path).items():
        np.testing.assert_array_equal(v, params[k])
    gate.save_gate(dict(params, w1=params["w1"][:2]), path)
    with pytest.raises(ValueError, match="observables"):
        gate.load_gate(path)
