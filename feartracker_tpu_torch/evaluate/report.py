"""Multi-tracker OPE comparison report — the got10k toolkit's
``Experiment*.report()`` capability (overlaid success/precision plots + a
``performance.json``), natively. The counterpart of
``feartracker_tpu/evaluate/report.py``.

Inputs are the per-tracker result dicts produced by
:func:`feartracker_tpu_torch.evaluate.got10k_eval.evaluate_tracker` /
``batched_evaluate`` (or their ``eval --report`` JSON dumps).

    python -m feartracker_tpu_torch.evaluate.report out_dir fear_xs=r1.json tuned=r2.json
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

PERFORMANCE_JSON = "performance.json"
SUCCESS_PNG = "success_plot.png"
PRECISION_PNG = "precision_plot.png"


def write_report(results: Dict[str, Dict[str, Any]], out_dir: str) -> Dict[str, str]:
    """Write ``performance.json`` + overlaid success/precision plots for a set
    of named tracker results. Returns the paths written.

    Trackers are ranked by success AUC in the plots (legend order = rank,
    matching the toolkit's report convention).
    """
    from feartracker_tpu_torch.evaluate.plots import plot_precision, plot_success

    os.makedirs(out_dir, exist_ok=True)
    paths = {}

    perf = {
        name: {
            "overall": {
                k: r[k]
                for k in (
                    "ao", "sr50", "sr75", "success_auc", "precision_20px",
                    "norm_precision_auc", "num_sequences",
                )
                if k in r
            },
            "seq_wise": r.get("per_sequence", {}),
        }
        for name, r in results.items()
    }
    paths["performance"] = os.path.join(out_dir, PERFORMANCE_JSON)
    with open(paths["performance"], "w") as fh:
        json.dump(perf, fh, indent=1)

    ranked = sorted(
        results.items(), key=lambda kv: kv[1].get("success_auc", 0.0), reverse=True
    )
    if len(ranked) > 8:  # plots carry ≤8 series: keep the top-8 by AUC
        print(f"[report] plotting top 8 of {len(ranked)} trackers by success AUC "
              f"(all appear in {PERFORMANCE_JSON})")
        ranked = ranked[:8]
    succ = {n: r["success_curve"] for n, r in ranked if "success_curve" in r}
    if succ:
        paths["success_plot"] = plot_success(succ, os.path.join(out_dir, SUCCESS_PNG))
    prec = {n: r["precision_curve"] for n, r in ranked if "precision_curve" in r}
    if prec:
        paths["precision_plot"] = plot_precision(prec, os.path.join(out_dir, PRECISION_PNG))
    return paths


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("reports", nargs="+",
                    help="name=path.json pairs (path = an `eval --report` dump)")
    args = ap.parse_args()

    results = {}
    for spec in args.reports:
        if "=" not in spec:
            raise SystemExit(f"expected name=path.json, got {spec!r}")
        name, path = spec.split("=", 1)
        with open(path) as fh:
            results[name] = json.load(fh)
    paths = write_report(results, args.out_dir)
    print(json.dumps(paths))


if __name__ == "__main__":
    main()
