"""Pre-registered gate v2 evaluation: the counterpart of
``tools/gate_v2_ablation.py``.

On the mixed structural-appearance suite (swap / pose / occlusion /
drift@1.0, the pre-registered seeds 7,13,21,29,37) it compares:

* ``static``  — the init template only (the floor);
* ``ema1``    — always-EMA@1: confidence-gated EMA, threshold 0.85, rate
  0.2, interval 1;
* ``feature`` — gate v2: the learned feature-conditioned per-frame rate
  (``models/gate.py``, the zoo's ``fear_xs_feature_gate.npz``), the same
  max rate 0.2, no threshold.

Decision rule (pre-registered): gate v2 replaces ema1 iff its per-seed
mixed-suite AO delta against ema1 (the mean over the scenarios, paired per
seed) is positive with the 95% t-CI excluding zero.

    python -m feartracker_tpu_torch.tools.gate_v2_ablation --gate_npz fear_xs_feature_gate
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.evaluate.harness import DTYPES, build_scan_tracker, device_line, tool_device
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter, ci_or_none, mean_ci
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets

SCENARIOS = ("swap", "pose", "occlusion", "drift")
SEEDS = (7, 13, 21, 29, 37)


def run(gate_npz="fear_xs_feature_gate", scenarios=SCENARIOS, seeds=SEEDS, frames=48, sequences=8, drift=1.0,
        update_rate=0.2, modes=("static", "ema1", "feature"), root=None, out=None, dtype=torch.bfloat16,
        device="cuda"):
    """The modes' rows, then per scenario and for the mixed suite the
    paired deltas (feature vs ema1 with the decision, feature vs static,
    ema1 vs static), each printed as a JSON line (and written to ``out``)."""
    work = root or tempfile.mkdtemp(prefix="gate_v2_eval_")
    datasets = scenario_datasets(work, scenarios, seeds, frames, sequences, drift)
    mode_kw = {
        "static": {},
        "ema1": dict(dynamic_template=True, update_mode="ema", update_threshold=0.85, update_rate=update_rate,
                     update_interval=1),
        "feature": dict(dynamic_template=True, update_mode="feature", update_rate=update_rate,
                        gate_params=gate_npz),
    }
    emit = Emitter(out)
    for mode in modes:
        tracker, prov = build_scan_tracker(dtype=dtype, device=device, **mode_kw[mode])
        for (scenario, seed), ds in datasets.items():
            res = batched_evaluate(tracker, ds, streams=sequences)
            emit({"scenario": scenario, "mode": mode, "seed": seed, "weights": prov, "ao": round(res["ao"], 4),
                  "sr50": round(res["sr50"], 4)})
    ao = {(r["mode"], r["scenario"], r["seed"]): r["ao"] for r in emit.records}
    for target, base in (("feature", "ema1"), ("feature", "static"), ("ema1", "static")):
        if target not in modes or base not in modes:
            continue
        mixed = [sum(ao[target, s, seed] - ao[base, s, seed] for s in scenarios) / len(scenarios) for seed in seeds]
        for scenario in scenarios:
            deltas = [ao[target, scenario, seed] - ao[base, scenario, seed] for seed in seeds]
            m, ci = mean_ci(deltas)
            emit({"summary": f"{target}_vs_{base}", "scenario": scenario, "delta_ao": round(m, 4),
                  "ci95": ci_or_none(ci), "positive_seeds": f"{sum(d > 0 for d in deltas)}/{len(deltas)}"})
        m, ci = mean_ci(mixed)
        decision = {}
        if (target, base) == ("feature", "ema1"):
            decision = {"decision": "SHIP gate v2" if (m - ci) > 0
                        else "NEGATIVE: keep ema1, close the gating design space"}
        emit({"summary": f"{target}_vs_{base}", "scenario": "MIXED", "delta_ao": round(m, 4), "ci95": ci_or_none(ci),
              "positive_seeds": f"{sum(d > 0 for d in mixed)}/{len(mixed)}", **decision})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gate_npz", default="fear_xs_feature_gate", help="gate v2 weights: a zoo name or an .npz")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--drift", type=float, default=1.0)
    ap.add_argument("--update_rate", type=float, default=0.2)
    ap.add_argument("--modes", default="static,ema1,feature")
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--out", default=None, help="write the JSON lines here too")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.gate_npz, args.scenarios.split(","), [int(s) for s in args.seeds.split(",")], args.frames,
        args.sequences, args.drift, args.update_rate, args.modes.split(","), args.root, args.out,
        DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
