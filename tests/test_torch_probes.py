"""The port's gate v2 ablation and occlusion signal probe
(``feartracker_tpu_torch/tools/{gate_v2_ablation,occlusion_signal_probe}.py``)
against the JAX tools on the same JPEG root written by the JAX generator
(seed 7, two 12-frame sequences), both in float32 on the CPU: rows' AO
within 0.01, summaries' deltas within 0.01, the probe's eligible / good /
bad counts within one a sequence."""

import pytest
import torch

import tools.gate_v2_ablation as jax_gate_v2
import tools.occlusion_signal_probe as jax_probe
from feartracker_tpu_torch.tools import gate_v2_ablation, occlusion_signal_probe
from torch_tool_parity import (  # noqa: F401  (one_thread: a module fixture)
    FRAMES,
    SEED,
    SEQUENCES,
    assert_rows_close,
    assert_summaries_close,
    jax_float32,
    jpeg_roots,
    one_thread,
    run_jax_tool,
)

SCENARIOS = ("swap", "occlusion")
RUN = dict(seeds=[SEED], sequences=SEQUENCES, frames=FRAMES, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return jpeg_roots(tmp_path_factory.mktemp("jpeg"), SCENARIOS)


def _common(scenario, root):
    return ["--scenarios", scenario, "--seeds", str(SEED), "--sequences", str(SEQUENCES), "--frames", str(FRAMES),
            "--root", root]


def test_gate_v2_ablation_equals_jax(root, monkeypatch, capsys, tmp_path):
    jax_float32(monkeypatch)
    gate = "feartracker_tpu/weights/fear_xs_feature_gate.npz"
    want = run_jax_tool(jax_gate_v2, _common("swap", root) + ["--gate_npz", gate], monkeypatch, capsys)
    out = tmp_path / "rows.jsonl"
    got = gate_v2_ablation.run(gate, scenarios=["swap"], root=root, out=str(out), **RUN)
    assert out.read_text().count("\n") == len(got)
    rows = [r for r in got if "summary" not in r]
    summaries = [r for r in got if "summary" in r]
    assert [r["mode"] for r in rows] == ["static", "ema1", "feature"]
    assert_rows_close(rows, [w for w in want if "summary" not in w], ("mode", "scenario", "seed"),
                      close=("ao", "sr50"))
    want_summaries = [w for w in want if "summary" in w]
    assert_summaries_close(summaries, want_summaries, "delta_ao")
    assert "decision" in summaries[1] and "decision" in want_summaries[1]


def test_occlusion_signal_probe_equals_jax(root, monkeypatch, capsys):
    jax_float32(monkeypatch)
    want = run_jax_tool(jax_probe, _common("occlusion,swap", root), monkeypatch, capsys)
    got = occlusion_signal_probe.run(scenarios=["occlusion", "swap"], root=root, **RUN)
    assert len(got) == len(want) == 1 + 2 + 1 + 6 + 4
    assert got[0] == want[0]
    tol = SEQUENCES  # one frame a sequence
    for r, w in zip(got[1:3], want[1:3]):
        assert (r["scenario"], r["seed"]) == (w["scenario"], w["seed"])
        for k in ("eligible", "good", "bad"):
            assert abs(r[k] - w[k]) <= tol, (k, r, w)
    assert abs(got[3]["n_good"] - want[3]["n_good"]) <= 2 * tol and abs(got[3]["n_bad"] - want[3]["n_bad"]) <= 2 * tol
    for r, w in zip(got[4:], want[4:]):
        assert r["gate"] == w["gate"]
        for k in ("bad_blocked", "good_sacrificed"):
            (a, n), (b, m) = (map(int, r[k].split("/")), map(int, w[k].split("/")))
            assert abs(a - b) <= 2 * tol and abs(n - m) <= 2 * tol, (k, r, w)
    # the signals' quantiles are the scan runtime's APCE and run lengths
    assert got[1]["apce_good"] is None or set(got[1]["apce_good"]) == {"q5", "q25", "q50", "q75", "q95"}
