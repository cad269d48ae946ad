"""The port's OPE plots and multi-tracker report against the JAX package's,
on the CPU: the same result dicts give the same ``performance.json`` and
the same PNG bytes (one matplotlib draws both), more than eight trackers
are folded to the top eight by AUC, the report's ``main``, and the eval
CLI's ``--plot`` / ``--plot_precision`` (as ``tests/test_evaluate.py``
holds JAX's)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from feartracker_tpu.core.geometry import overlap_xywh_np  # noqa: E402
from feartracker_tpu.evaluate import plots as jplots  # noqa: E402
from feartracker_tpu.evaluate import report as jreport  # noqa: E402
from feartracker_tpu.evaluate.got10k_eval import precision_stats, summarize  # noqa: E402
from feartracker_tpu_torch.evaluate import cli, plots, report  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _results(names, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i, name in enumerate(names):
        gt = np.abs(rng.randn(12, 4)) * 30 + np.array([20, 20, 30, 30])
        pred = gt + rng.randn(12, 4) * (0.5 + i)
        out[name] = summarize([overlap_xywh_np(pred, gt)], ["seq"], [precision_stats(pred, gt)])
    return json.loads(json.dumps(out, default=lambda a: a.tolist()))  # as an `eval --report` dump


def test_plot_writers_match_jax(tmp_path):
    assert plots.SERIES_COLORS == jplots.SERIES_COLORS and len(set(plots.SERIES_COLORS)) == 8
    t = np.arange(0, 1.05, 0.05)
    p = np.arange(0, 51, 1.0)
    cases = {
        "success_one": (plots.plot_success, jplots.plot_success, {"fear_xs": np.clip(1 - t, 0, 1)}),
        "success_eight": (plots.plot_success, jplots.plot_success,
                          {f"t{i}": np.clip(1 - t * (1 + i / 10), 0, 1) for i in range(8)}),
        "precision_one": (plots.plot_precision, jplots.plot_precision, {"fear_xs": np.clip(p / 30, 0, 1)}),
        "precision_three": (plots.plot_precision, jplots.plot_precision,
                            {f"t{i}": np.clip(p / (25 + i), 0, 1) for i in range(3)}),
    }
    for name, (mine, theirs, curves) in cases.items():
        got, want = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}_jax.png")
        assert mine(curves, got) == got
        theirs(curves, want)
        assert os.path.getsize(got) > 1000 and _bytes(got) == _bytes(want), name
    with pytest.raises(ValueError):
        plots.plot_success({f"t{i}": t for i in range(9)}, str(tmp_path / "no.png"))


def test_write_report_matches_jax(tmp_path):
    results = _results(["fear_xs", "tuned", "wide"])
    paths = report.write_report(results, str(tmp_path / "port"))
    jpaths = jreport.write_report(results, str(tmp_path / "jax"))
    assert set(paths) == set(jpaths) == {"performance", "success_plot", "precision_plot"}
    assert json.load(open(paths["performance"])) == json.load(open(jpaths["performance"]))
    for k in ("success_plot", "precision_plot"):
        assert os.path.getsize(paths[k]) > 1000 and _bytes(paths[k]) == _bytes(jpaths[k]), k
    perf = json.load(open(paths["performance"]))
    assert set(perf) == set(results) and perf["fear_xs"]["seq_wise"] == results["fear_xs"]["per_sequence"]


def test_report_folds_beyond_eight_trackers(tmp_path, capsys):
    results = _results([f"t{i}" for i in range(10)], seed=1)
    paths = report.write_report(results, str(tmp_path / "rep10"))
    assert "top 8 of 10" in capsys.readouterr().out
    assert len(json.load(open(paths["performance"]))) == 10  # every tracker in the JSON
    jpaths = jreport.write_report(results, str(tmp_path / "jax10"))
    assert _bytes(paths["success_plot"]) == _bytes(jpaths["success_plot"])


def test_report_main(tmp_path, monkeypatch, capsys):
    res = {"ao": 0.5, "success_auc": 0.5, "success_curve": [1.0] * 21,
           "precision_curve": [1.0] * 51, "precision_20px": 1.0, "num_sequences": 1}
    p1, p2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    json.dump(res, open(p1, "w"))
    json.dump(dict(res, success_auc=0.6), open(p2, "w"))
    out = str(tmp_path / "rep")
    monkeypatch.setattr(sys, "argv", ["report", out, f"a={p1}", f"b={p2}"])
    report.main()
    assert json.loads(capsys.readouterr().out)["performance"] == os.path.join(out, report.PERFORMANCE_JSON)
    assert set(json.load(open(os.path.join(out, report.PERFORMANCE_JSON)))) == {"a", "b"}
    assert os.path.exists(os.path.join(out, report.SUCCESS_PNG))
    monkeypatch.setattr(sys, "argv", ["report", out, "missing-equals-sign"])
    with pytest.raises(SystemExit):
        report.main()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    pytest.importorskip("cv2")  # the synthetic dataset's frames are image files
    from tools.make_synthetic_dataset import generate

    base = str(tmp_path_factory.mktemp("plot_root"))
    generate(base, tracks=1, frames=4, val_sequences=2, seed=0, scenario="drift")
    return os.path.join(base, "got10k")


def test_cli_plot_flags(root, tmp_path, capsys):
    succ, prec, rep = (str(tmp_path / "p" / n) for n in ("success.png", "precision.png", "report.json"))
    cli.main(["--device", "cpu", "eval", "--root", root, "--max_frames", "4", "--report", rep,
              "--plot", succ, "--plot_precision", prec])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["num_sequences"] == 2
    assert os.path.getsize(succ) > 1000 and os.path.getsize(prec) > 1000
    # the plots are the run's own curves, the series named after the weights file
    full = json.load(open(rep))
    want = str(tmp_path / "want.png")
    jplots.plot_success({"fear_xs": full["success_curve"]}, want, title="Success plot (OPE) — got10k")
    assert _bytes(succ) == _bytes(want)
    with pytest.raises(SystemExit, match="OPE curves"):
        cli.main(["--device", "cpu", "eval", "--root", root, "--max_frames", "4", "--supervised",
                  "--plot", str(tmp_path / "no.png")])
