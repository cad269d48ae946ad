"""Unified failure-handling study under the VOT supervised protocol: static
vs EMA@1 dual template vs zoom-out recovery vs EMA+recovery, on the
structural-appearance-change scenarios, at the pre-registered seeds. The
counterpart of ``tools/vot_unified.py``.

The VOT supervised protocol (``evaluate/vot_eval.py``: re-init on failure,
burn-in-masked accuracy, failure counting, segment EAO) through the
sequential ``FEARTracker``: accuracy / robustness / EAO per scenario per
config, with per-seed paired deltas against static (95% t-CI) and the
means.

    python -m feartracker_tpu_torch.tools.vot_unified --scenarios occlusion,pose,swap \\
        --seeds 7,13,21,29,37 --frames 48
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from feartracker_tpu_torch.evaluate.harness import DTYPES, device_line, load_model, tool_device
from feartracker_tpu_torch.evaluate.vot_eval import evaluate_vot
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets
from feartracker_tpu_torch.tools.vot_recovery import METRICS, paired_summary, vot_row
from feartracker_tpu_torch.tracker.tracker import FEARTracker

# EMA at the measured-best appearance-morph settings, recovery at the
# measured-best occlusion setting (the JAX tool's)
CONFIGS = {
    "static": {},
    "ema1": dict(dynamic_template=True, update_threshold=0.85, update_rate=0.2, update_interval=1),
    "recover": dict(recover_context=3.0, recover_threshold=0.7),
    "ema_recover": dict(dynamic_template=True, update_threshold=0.85, update_rate=0.2, update_interval=1,
                        recover_context=3.0, recover_threshold=0.7),
}


def run(scenarios=("occlusion", "pose", "swap"), drift=1.0, frames=48, sequences=8, seeds=(7, 13, 21, 29, 37),
        skip=5, burnin=10, configs=tuple(CONFIGS), root=None, out=None, dtype=torch.bfloat16, device="cuda"):
    """A row per config × scenario × seed, the per-config summaries and the
    static means, each printed as a JSON line (and written to ``out``)."""
    work = root or tempfile.mkdtemp(prefix="vot_unified_")
    datasets = scenario_datasets(work, scenarios, seeds, frames, sequences, drift)
    model, prov = load_model()
    emit = Emitter(out)
    for name in configs:
        tracker = FEARTracker(model, dtype=dtype, device=device, **CONFIGS[name])
        for (scenario, seed), ds in datasets.items():
            res = evaluate_vot(tracker, ds, skip=skip, burnin=burnin)
            emit({"scenario": scenario, "mode": name, "seed": seed, "weights": prov, **vot_row(res)})
    rows = list(emit.records)
    base = {(r["scenario"], r["seed"], m): r[m] for r in rows if r["mode"] == "static" for m in METRICS}
    for name in configs:
        if name != "static":
            for scenario in scenarios:
                emit({**paired_summary(rows, name, scenario, base, means=True), "n_seeds": len(seeds)})
    for scenario in scenarios:  # the static baseline's own means
        summary = {"summary": "static", "scenario": scenario}
        for m in METRICS:
            vals = [r[m] for r in rows if r["mode"] == "static" and r["scenario"] == scenario]
            if vals:
                summary[f"mean_{m}"] = round(float(sum(vals) / len(vals)), 4)
        emit({**summary, "n_seeds": len(seeds)})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", default="occlusion,pose,swap")
    ap.add_argument("--drift", type=float, default=1.0, help="appearance_drift for the 'drift' scenario")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--seeds", default="7,13,21,29,37")
    ap.add_argument("--skip", type=int, default=5)
    ap.add_argument("--burnin", type=int, default=10)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--out", default=None, help="write the JSON lines here too")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.scenarios.split(","), args.drift, args.frames, args.sequences, [int(s) for s in args.seeds.split(",")],
        args.skip, args.burnin, args.configs.split(","), args.root, args.out, DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
