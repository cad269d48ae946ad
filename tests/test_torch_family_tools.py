"""The port's family Pareto table and letterbox penalty
(``feartracker_tpu_torch/tools/{family_pareto,letterbox_penalty}.py``)
against the JAX tools on JPEG roots written by the JAX generator (swap,
seed 7, two 12-frame sequences), both in float32 on the CPU: AO within
0.01. ``family_pareto`` runs FEAR-M and FEAR-L at their published widths,
so the port's trunk runs K2's plain twin at their block shapes."""

import pytest
import torch

import tools.family_pareto as jax_pareto
import tools.letterbox_penalty as jax_letterbox
from feartracker_tpu_torch.tools import family_pareto, letterbox_penalty
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

RUN = dict(seeds=[SEED], sequences=SEQUENCES, frames=FRAMES, dtype=torch.float32, device="cpu")
WEIGHTS = "feartracker_tpu/weights"


def test_family_pareto_equals_jax(tmp_path, monkeypatch, capsys):
    root = jpeg_roots(tmp_path, ["swap"])
    jax_float32(monkeypatch)
    entries = f"{WEIGHTS}/fear_m_repo.npz:fear_m,{WEIGHTS}/fear_l_repo.npz:fear_l"
    want = run_jax_tool(jax_pareto, ["--entries", entries, "--scenarios", "swap", "--seeds", str(SEED),
                                     "--sequences", str(SEQUENCES), "--frames", str(FRAMES), "--root", root],
                        monkeypatch, capsys)
    got = family_pareto.run(entries, fps={"fear_l": 123.0}, scenarios=["swap"], root=root, **RUN)
    assert [r["model"] for r in got] == ["fear_m", "fear_l"]
    assert got[1].pop("fps_per_card") == 123.0
    assert_rows_close(got, want, ("entry",), close=("mixed_ao", "ao_swap"))
    skipped = family_pareto.run("missing.npz:fear_xs", scenarios=["swap"], root=root, **RUN)
    assert skipped[0]["entry"] == "missing.npz" and "FileNotFoundError" in skipped[0]["skipped"]


def test_letterbox_penalty_equals_jax(tmp_path, monkeypatch, capsys):
    """A 120×168 canvas, the scenes at 2× (240×336): the sequential
    ``FEARTracker`` at full resolution, the batched path at a fitting and
    at the letterboxed canvas."""
    root = jpeg_roots(tmp_path, ["swap"], suffix="_x2", size=(240, 336), obj_scale=2.0)
    jax_float32(monkeypatch)
    argv = ["--scenarios", "swap", "--seeds", str(SEED), "--sequences", str(SEQUENCES), "--frames", str(FRAMES),
            "--canvas_h", "120", "--canvas_w", "168", "--scale", "2", "--root", root]
    want = run_jax_tool(jax_letterbox, argv, monkeypatch, capsys)
    got = letterbox_penalty.run(["swap"], canvas_h=120, canvas_w=168, scale=2.0, root=root, **RUN)
    rows = [r for r in got if "summary" not in r]
    assert [(r["path"], r["canvas"]) for r in rows] == [("sequential", [240, 336]), ("batched_fit", [240, 336]),
                                                         ("batched_lb", [120, 168])]
    assert_rows_close(rows, [w for w in want if "summary" not in w], ("scenario", "seed", "path"),
                      close=("ao", "sr50", "sr75"))
    for r, w in zip([r for r in got if "summary" in r], [w for w in want if "summary" in w]):
        assert (r["summary"], r["n_seeds"]) == (w["summary"], w["n_seeds"])
        assert abs(r["delta_ao_mean"] - w["delta_ao_mean"]) <= 0.01
