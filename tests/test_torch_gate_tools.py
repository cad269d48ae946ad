"""The port's gate trainers and the flagship's quality gate against the JAX
tools, float32 on the CPU, on JPEG roots written by the JAX generator:

* ``train_template_gate``: the gate logit after its Adam steps within 1e-5,
  the archive's other arrays unchanged;
* ``train_feature_gate.collect_rollouts``: the EMA@1 rollout's observations
  within 1e-4 with equal labels; ``train_mlp``: the parameters within 1e-5
  and the report to 4 decimals after 100 epochs. The tool's 3000 epochs fit
  data the MLP can nearly separate: its weights grow, and the order of a
  float32 reduction moves them by 0.62 (of 27) between the two packages by
  the end on this test's data, so no parameter tolerance holds there."""

import json
import os

import numpy as np
import pytest
import torch

import feartracker_tpu.evaluate.harness as jax_harness  # noqa: F401  (patched by jax_float32)
import tools.make_synthetic_dataset as jax_gen
import tools.train_feature_gate as jax_feature_gate
import tools.train_template_gate as jax_template_gate
from feartracker_tpu_torch.tools import train_feature_gate, train_template_gate
from torch_tool_parity import jax_float32, one_thread, run_jax_tool  # noqa: F401  (one_thread: a fixture)

GATE_ATOL = 1e-5
OBS_ATOL = 1e-4
MLP_ATOL = 1e-5


def test_template_gate_equals_jax(tmp_path, monkeypatch, capsys):
    work = str(tmp_path / "work")
    kw = dict(tracks=1, frames=10, epochs=1, samples_per_scenario=4, batch=2)
    argv = ["--scenarios", "swap", "--tracks", "1", "--frames", "10", "--epochs", "1", "--samples_per_scenario",
            "4", "--batch", "2", "--platform", "cpu", "--work", work, "--out", str(tmp_path / "jax.npz")]
    want = run_jax_tool(jax_template_gate, argv, monkeypatch, capsys)[-1]
    got = train_template_gate.run(scenarios=("swap",), work=work, out=str(tmp_path / "port.npz"), device="cpu",
                                  **kw)[-1]
    assert got["steps"] == want["steps"] == 2
    assert abs(got["gate_logit"] - want["gate_logit"]) <= GATE_ATOL, (got, want)
    assert abs(got["gate_logit"]) > 10 * GATE_ATOL  # the steps moved it
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            if k != "params/template_gate":
                assert np.array_equal(zp[k], zj[k]), k
    assert json.loads((tmp_path / "port.json").read_text())["gate_logit"] == got["gate_logit"]
    # the dataset configs the loaders read
    roots = [os.path.join(work, "swap")]
    jax_ds = jax_template_gate.build_dataset(roots, 4, 0)
    assert [d.config for d in train_template_gate.build_dataset(roots, 4, 0).datasets] == [
        d.config for d in jax_ds.datasets]


@pytest.fixture(scope="module")
def rollouts(tmp_path_factory):
    """Pose at a train seed, 2 sequences of 12 frames (the tracker holds the
    target on all but one frame: both labels occur)."""
    root = str(tmp_path_factory.mktemp("rollouts"))
    jax_gen.generate(os.path.join(root, "pose_s51"), tracks=1, frames=12, val_sequences=2, seed=51, scenario="pose")
    mp = pytest.MonkeyPatch()
    jax_float32(mp)
    want = jax_feature_gate.collect_rollouts(["pose"], [51], 12, 2, 1.0, root)
    mp.undo()
    got = train_feature_gate.collect_rollouts(["pose"], [51], 12, 2, 1.0, root, dtype=torch.float32, device="cpu")
    return want, got


def test_rollout_observations_equal_jax(rollouts):
    (j_obs, j_vis, j_iou, j_tag, j_prov), (obs, vis, iou, tag, prov, pred) = rollouts
    assert obs.shape == j_obs.shape == (2 * 11, 6) and pred.shape == (22, 4)
    assert prov == j_prov == "fear_xs"
    assert float(np.abs(obs - j_obs).max()) <= OBS_ATOL
    assert np.array_equal(vis, j_vis) and np.array_equal(tag, j_tag)
    labels = (vis >= 0.7) & (iou >= 0.5)
    assert np.array_equal(labels, (j_vis >= 0.7) & (j_iou >= 0.5))
    assert 0 < labels.sum() < len(labels)


def test_train_mlp_equals_jax():
    rng = np.random.RandomState(0)
    obs = rng.rand(300, 6).astype(np.float32)
    labels = ((obs @ np.array([2, 1, -1, 0.5, 0, -2]) + 0.8 * rng.randn(300)) > 0.2).astype(np.float32)
    want = jax_feature_gate.train_mlp(obs, labels, 8, 100, 3e-2, 0)
    got = train_feature_gate.train_mlp(obs, labels, 8, 100, 3e-2, 0)
    assert sorted(got[0]) == sorted(want[0])
    for k, w in want[0].items():
        assert got[0][k].dtype == np.float32 and float(np.abs(got[0][k] - w).max()) <= MLP_ATOL, k
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) <= 1e-6


def test_feature_gate_refuses_eval_seeds(tmp_path):
    with pytest.raises(SystemExit, match="collide"):
        train_feature_gate.run(train_seeds=(51, 13), work=str(tmp_path), device="cpu")
    assert os.listdir(tmp_path) == []
