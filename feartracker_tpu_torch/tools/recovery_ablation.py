"""Zoom-out re-acquisition ablation: does widening the search window after a
low-confidence frame recover lost targets? The counterpart of
``tools/recovery_ablation.py``.

``ScanTracker(recover_context=...)`` widens the next search crop of any
stream whose confidence fell below ``recover_threshold`` (the same 256²
crop from a wider window, no host involvement). Static-template trackers
that differ only in their recovery config are evaluated per scenario ×
seed by ``batched_evaluate``; the per-seed AO deltas against the
no-recovery baseline are pooled with a 95% t-CI. ``--with_dual`` adds EMA@1
with and without recovery.

    python -m feartracker_tpu_torch.tools.recovery_ablation --scenarios occlusion,swap,pose,drift \\
        --contexts 3,4 --seeds 7,13,21,29,37 --frames 48
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.evaluate.harness import DTYPES, build_scan_tracker, device_line, tool_device
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter, ci_or_none, mean_ci
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets


def run(root=None, scenarios=("occlusion", "swap", "pose", "drift"), drift=1.0, contexts=(3.0, 4.0),
        recover_threshold=0.7, with_dual=False, frames=48, sequences=8, seeds=(7, 13, 21, 29, 37),
        dtype=torch.bfloat16, device="cuda"):
    """The arms' rows then the pooled deltas against the baseline, each
    printed as a JSON line. ``contexts`` ≤ 0 are dropped (the baseline is
    always run)."""
    work = root or tempfile.mkdtemp(prefix="recovery_ablation_")
    contexts = [float(c) for c in contexts if float(c) > 0]
    datasets = scenario_datasets(work, scenarios, seeds, frames, sequences, drift)
    arms = [("baseline", {})]
    for ctx in contexts:
        arms.append((f"recover_c{ctx:g}", dict(recover_context=ctx, recover_threshold=recover_threshold)))
    if with_dual:
        # does EMA@1 compose with zoom-out recovery, or do they interact?
        dual = dict(dynamic_template=True, update_mode="ema", update_interval=1)
        arms.append(("ema1", dict(dual)))
        for ctx in contexts:
            arms.append((f"ema1+recover_c{ctx:g}",
                         dict(dual, recover_context=ctx, recover_threshold=recover_threshold)))
    emit = Emitter()
    for label, kw in arms:
        ctx = kw.get("recover_context", 0.0)
        tracker, prov = build_scan_tracker(dtype=dtype, device=device, **kw)
        for (scenario, seed), ds in datasets.items():
            res = batched_evaluate(tracker, ds, streams=sequences)
            emit({"scenario": scenario, "mode": label, "seed": seed, "context": ctx,
                  "threshold": recover_threshold, "weights": prov, "ao": round(res["ao"], 4),
                  "sr50": round(res["sr50"], 4), "sr75": round(res["sr75"], 4)})
    rows = list(emit.records)
    base = {(r["scenario"], r["seed"]): r["ao"] for r in rows if r["mode"] == "baseline"}
    print("\n== pooled AO deltas vs baseline (per-seed paired, 95% t-CI) ==")
    for mode in sorted({r["mode"] for r in rows} - {"baseline"}):
        for scenario in scenarios:
            deltas = [r["ao"] - base[(scenario, r["seed"])]
                      for r in rows if r["mode"] == mode and r["scenario"] == scenario]
            if not deltas:
                continue
            m, ci = mean_ci(deltas)
            emit({"summary": mode, "scenario": scenario, "n_seeds": len(deltas), "delta_ao_mean": round(m, 4),
                  "delta_ao_ci95": ci_or_none(ci), "positive_seeds": f"{sum(d > 0 for d in deltas)}/{len(deltas)}"})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", default="occlusion,swap,pose,drift")
    ap.add_argument("--drift", type=float, default=1.0)
    ap.add_argument("--contexts", default="3,4",
                    help="comma list of recover_context values (0 = baseline, always included)")
    ap.add_argument("--recover_threshold", type=float, default=0.7)
    ap.add_argument("--with_dual", action="store_true",
                    help="add ema@1 and ema@1+recovery arms (the production-composition question)")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--seeds", default="7,13,21,29,37")
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.root, args.scenarios.split(","), args.drift, [float(c) for c in args.contexts.split(",")],
        args.recover_threshold, args.with_dual, args.frames, args.sequences,
        [int(s) for s in args.seeds.split(",")], DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
