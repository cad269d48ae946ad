"""The port's sequential-protocol tools (``feartracker_tpu_torch/tools/
{vot_recovery,vot_unified,tune_tracker}.py``) against the JAX tools on the
same JPEG root written by the JAX generator (seed 7, two 12-frame
sequences), both in float32 on the CPU: VOT failures equal, accuracy and
EAO within 0.01; the tuning points' AO within 0.01, sequential and
batched."""

import jax.numpy as jnp
import pytest
import torch

import feartracker_tpu.models.fear_net as jax_fear_net
import feartracker_tpu.tracker.runtime as jax_runtime
import tools.tune_tracker as jax_tune
import tools.vot_recovery as jax_vot_recovery
import tools.vot_unified as jax_vot_unified
from feartracker_tpu_torch.tools import tune_tracker, vot_recovery, vot_unified
from torch_tool_parity import (  # noqa: F401  (one_thread: a module fixture)
    FRAMES,
    SEED,
    SEQUENCES,
    assert_rows_close,
    jax_float32,
    jpeg_roots,
    one_thread,
    run_jax_tool,
)

# occlusion makes the tracker fail, so the failure counts are compared
# where they are not zero; swap for the tuning points
SCENARIOS = ("occlusion", "swap")
VOT = ["--skip", "2", "--burnin", "3"]
RUN = dict(seeds=[SEED], sequences=SEQUENCES, frames=FRAMES, skip=2, burnin=3, dtype=torch.float32, device="cpu")
METRICS = ("accuracy", "eao")  # within 0.01; the failure counts equal


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return jpeg_roots(tmp_path_factory.mktemp("jpeg"), SCENARIOS)


def _common(root):
    return ["--scenarios", "occlusion", "--seeds", str(SEED), "--sequences", str(SEQUENCES), "--frames",
            str(FRAMES), "--root", root, *VOT]


def _summaries_close(got, want):
    assert [(r["summary"], r["scenario"], r["n_seeds"]) for r in got] == [
        (w["summary"], w["scenario"], w["n_seeds"]) for w in want]
    for r, w in zip(got, want):
        assert set(r) == set(w)
        for k in r:
            if k.startswith(("delta_robustness", "mean_robustness", "delta_failures", "mean_failures")):
                assert r[k] == w[k], (k, r, w)
            elif isinstance(r[k], float):
                assert abs(r[k] - w[k]) <= 0.01, (k, r, w)


def test_vot_recovery_equals_jax(root, monkeypatch, capsys):
    jax_float32(monkeypatch)
    want = run_jax_tool(jax_vot_recovery, _common(root) + ["--contexts", "3"], monkeypatch, capsys)
    got = vot_recovery.run(["occlusion"], contexts=[3.0], root=root, **RUN)
    rows = [r for r in got if "summary" not in r]
    assert [r["mode"] for r in rows] == ["baseline", "recover_c3"]
    assert rows[0]["robustness_failures"] > 0
    assert_rows_close(rows, [w for w in want if "summary" not in w], ("mode", "scenario", "seed"), close=METRICS)
    _summaries_close([r for r in got if "summary" in r], [w for w in want if "summary" in w])


def test_vot_unified_equals_jax(root, monkeypatch, capsys, tmp_path):
    jax_float32(monkeypatch)
    configs = "static,ema_recover"
    want = run_jax_tool(jax_vot_unified, _common(root) + ["--configs", configs], monkeypatch, capsys)
    out = tmp_path / "rows.jsonl"
    got = vot_unified.run(["occlusion"], configs=configs.split(","), root=root, out=str(out), **RUN)
    assert out.read_text().count("\n") == len(got) == len(want) == 4
    rows = [r for r in got if "summary" not in r]
    assert_rows_close(rows, [w for w in want if "summary" not in w], ("mode", "scenario", "seed"), close=METRICS)
    _summaries_close([r for r in got if "summary" in r], [w for w in want if "summary" in w])


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_tune_tracker_equals_jax(batched, root, monkeypatch, capsys):
    """Two grid points; JAX's batched search builds a bfloat16 ``FEARNet``
    and ``ScanTracker`` itself, so both are made float32 here."""
    real_net, real_scan = jax_fear_net.FEARNet, jax_runtime.ScanTracker
    monkeypatch.setattr(jax_fear_net, "FEARNet", lambda dtype=None, **kw: real_net(**kw))
    monkeypatch.setattr(jax_runtime, "ScanTracker",
                        lambda *a, dtype=None, **kw: real_scan(*a, dtype=jnp.float32, **kw))
    got10k = f"{root}/swap_s{SEED}/got10k"
    argv = ["--root", got10k, "--penalty_k", "0.062,0.15", "--window", "0.38"]
    if batched:
        argv += ["--batched", "--streams", "2"]
    want = run_jax_tool(jax_tune, argv, monkeypatch, capsys)
    got = tune_tracker.run(got10k, penalty_k=[0.062, 0.15], window=[0.38], batched=batched, streams=2,
                           dtype=torch.float32, device="cpu")
    assert len(got) == len(want) == 3
    assert_rows_close(got[:2], want[:2], ("penalty_k", "window_influence", "lr"), close=("ao", "sr50"))
    assert got[0]["num_sequences"] == 2
    assert got[2]["best"]["ao"] == max(p["ao"] for p in got[:2])
