"""The port's dual-template and recovery ablations (``feartracker_tpu_torch/
tools/{dual_template,recovery}_ablation.py``) against the JAX tools on the
same JPEG root written by the JAX generator (the swap scenario, seed 7, two
12-frame sequences), both in float32 on the CPU: every row's AO, SR50 and
SR75 within 0.01 and every other field equal, then the summaries' means
within 0.01."""

import pytest
import torch

import tools.dual_template_ablation as jax_dual
import tools.recovery_ablation as jax_recovery
from feartracker_tpu_torch.tools import dual_template_ablation, recovery_ablation
from torch_tool_parity import (  # noqa: F401  (one_thread: a module fixture)
    SEED,
    SEQUENCES,
    FRAMES,
    assert_rows_close,
    assert_summaries_close,
    jax_float32,
    jpeg_roots,
    one_thread,
    run_jax_tool,
)

SCENARIO = "swap"
COMMON = ["--scenarios", SCENARIO, "--seeds", str(SEED), "--sequences", str(SEQUENCES), "--frames", str(FRAMES)]
RUN = dict(scenarios=[SCENARIO], seeds=[SEED], sequences=SEQUENCES, frames=FRAMES, dtype=torch.float32,
           device="cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return jpeg_roots(tmp_path_factory.mktemp("jpeg"), [SCENARIO])


def _split(recs):
    return [r for r in recs if "summary" not in r], [r for r in recs if "summary" in r]


def test_mean_ci_equals_jax():
    for xs in ([0.5], [0.1, -0.2], [0.3, 0.1, 0.25, -0.05], [0.01] * 12):
        assert dual_template_ablation.mean_ci(xs) == pytest.approx(jax_dual.mean_ci(xs), nan_ok=True)
    assert dual_template_ablation._T975 == jax_dual._T975


def test_dual_template_ablation_equals_jax(root, monkeypatch, capsys):
    jax_float32(monkeypatch)
    modes, gate = "static,gated,gated_trained", "feartracker_tpu/weights/fear_xs_gate.npz"
    want = run_jax_tool(jax_dual, COMMON + ["--modes", modes, "--intervals", "1", "--root", root, "--gate_npz", gate],
                        monkeypatch, capsys)
    got = dual_template_ablation.run(root, modes=modes.split(","), intervals=[1], gate_npz=gate, **RUN)
    rows, summaries = _split(got)
    assert [r["mode"] for r in rows] == ["static", "gated_0.5", "gated_trained"]
    assert rows[2]["weights"] == "fear_xs_gate.npz+trained_gate" and rows[1]["gate"] == 0.5 < rows[2]["gate"]
    want_rows, want_summaries = _split(want)
    assert_rows_close(rows, want_rows, ("mode", "scenario", "seed"), close=("ao", "sr50", "sr75"))
    assert_summaries_close(summaries, want_summaries, "delta_ao_mean")


def test_recovery_ablation_equals_jax(root, monkeypatch, capsys):
    jax_float32(monkeypatch)
    want = run_jax_tool(jax_recovery, COMMON + ["--contexts", "0,3", "--root", root], monkeypatch, capsys)
    got = recovery_ablation.run(root, contexts=[0.0, 3.0], **RUN)
    rows, summaries = _split(got)
    assert [r["mode"] for r in rows] == ["baseline", "recover_c3"]
    assert_rows_close(rows, _split(want)[0], ("mode", "scenario", "seed"), close=("ao", "sr50", "sr75"))
    assert_summaries_close(summaries, _split(want)[1], "delta_ao_mean")


def test_recovery_ablation_with_dual_arms(root, capsys):
    """``--with_dual`` adds the EMA@1 arms, with and without recovery, in
    JAX's order; each summary is its arm's AO less the baseline's."""
    got = recovery_ablation.run(root, contexts=[3.0], with_dual=True, **RUN)
    rows, summaries = _split(got)
    assert [r["mode"] for r in rows] == ["baseline", "recover_c3", "ema1", "ema1+recover_c3"]
    ao = {r["mode"]: r["ao"] for r in rows}
    assert [s["summary"] for s in summaries] == ["ema1", "ema1+recover_c3", "recover_c3"]
    for s in summaries:
        assert s["delta_ao_mean"] == pytest.approx(ao[s["summary"]] - ao["baseline"], abs=1e-9)
