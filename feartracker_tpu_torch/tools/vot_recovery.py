"""The VOT supervised protocol with zoom-out re-acquisition: does recovery
reduce supervised failures before the protocol's re-init has to fire? The
counterpart of ``tools/vot_recovery.py``.

``recover_context`` widens the next search crop after any frame scoring
below ``recover_threshold``; if that rescues the target before its overlap
reaches zero, the protocol counts fewer failures. Scored with
``evaluate_vot`` (burn-in-masked accuracy, failures, segment EAO) through
the sequential ``FEARTracker``, one per recovery config over one weight
load, on the same scenario datasets and seeds as ``recovery_ablation``.

    python -m feartracker_tpu_torch.tools.vot_recovery --scenarios occlusion --contexts 3 \\
        --seeds 7,13,21,29,37 --frames 48
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from feartracker_tpu_torch.evaluate.harness import DTYPES, device_line, load_model, tool_device
from feartracker_tpu_torch.evaluate.vot_eval import evaluate_vot
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter, ci_or_none, mean_ci
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets
from feartracker_tpu_torch.tracker.tracker import FEARTracker

METRICS = ("accuracy", "robustness_failures", "failures_per_100f", "eao")


def vot_row(res: dict) -> dict:
    """The protocol's metrics of one run, rounded as the rows print them."""
    return {m: round(float(res[m]), 4) for m in METRICS}


def paired_summary(rows, mode: str, scenario: str, base: dict, means: bool = False) -> dict:
    """Per-seed deltas of each metric of ``mode`` against ``base`` (keyed
    (scenario, seed, metric)) on ``scenario``, with their 95% t-CIs (and
    the mode's means with ``means``)."""
    summary = {"summary": mode, "scenario": scenario}
    mine = [r for r in rows if r["mode"] == mode and r["scenario"] == scenario]
    for m in METRICS:
        if not mine:
            continue
        if means:
            summary[f"mean_{m}"] = round(float(sum(r[m] for r in mine) / len(mine)), 4)
        mu, ci = mean_ci([r[m] - base[(scenario, r["seed"], m)] for r in mine])
        summary[f"delta_{m}"] = round(mu, 4)
        summary[f"delta_{m}_ci95"] = ci_or_none(ci)
    return summary


def run(scenarios=("occlusion",), drift=1.0, contexts=(3.0,), recover_threshold=0.7, frames=48, sequences=8,
        seeds=(7, 13, 21, 29, 37), skip=5, burnin=10, root=None, dtype=torch.bfloat16, device="cuda"):
    """A row per config × scenario × seed, then the pooled deltas against
    the baseline, each printed as a JSON line."""
    work = root or tempfile.mkdtemp(prefix="vot_recovery_")
    contexts = [float(c) for c in contexts if float(c) > 0]
    datasets = scenario_datasets(work, scenarios, seeds, frames, sequences, drift)
    model, prov = load_model()
    emit = Emitter()
    for ctx in [0.0] + contexts:
        kw = {} if ctx == 0.0 else dict(recover_context=ctx, recover_threshold=recover_threshold)
        tracker = FEARTracker(model, dtype=dtype, device=device, **kw)
        label = "baseline" if ctx == 0.0 else f"recover_c{ctx:g}"
        for (scenario, seed), ds in datasets.items():
            res = evaluate_vot(tracker, ds, skip=skip, burnin=burnin)
            emit({"scenario": scenario, "mode": label, "seed": seed, "context": ctx,
                  "threshold": recover_threshold, "weights": prov, **vot_row(res)})
    rows = list(emit.records)
    base = {(r["scenario"], r["seed"], m): r[m] for r in rows if r["mode"] == "baseline" for m in METRICS}
    print("\n== pooled deltas vs baseline (per-seed paired, 95% t-CI) ==")
    for mode in sorted({r["mode"] for r in rows} - {"baseline"}):
        for scenario in scenarios:
            emit({**paired_summary(rows, mode, scenario, base), "n_seeds": len(seeds)})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", default="occlusion")
    ap.add_argument("--drift", type=float, default=1.0)
    ap.add_argument("--contexts", default="3",
                    help="comma list of recover_context values (0 = baseline, always included)")
    ap.add_argument("--recover_threshold", type=float, default=0.7)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--seeds", default="7,13,21,29,37")
    ap.add_argument("--skip", type=int, default=5)
    ap.add_argument("--burnin", type=int, default=10)
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.scenarios.split(","), args.drift, [float(c) for c in args.contexts.split(",")],
        args.recover_threshold, args.frames, args.sequences, [int(s) for s in args.seeds.split(",")], args.skip,
        args.burnin, args.root, DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
