"""Inference-time dual-template ablation: static vs EMA vs gated template on
the appearance-change scenarios, over several dataset seeds with pooled
statistics. The counterpart of ``tools/dual_template_ablation.py``.

Scenarios (``tools/make_synthetic_dataset.py``): ``drift`` (a colour morph),
``pose`` (out-of-plane rotation), ``occlusion`` (occluder bars over the
target), ``swap`` (a same-looking distractor crosses its path). Modes:

* ``static``        — the init template only (the reference's config);
* ``ema``           — the confidence-gated EMA of the dynamic template;
* ``gated``         — the blend ``sigmoid(template_gate)`` of the default
  weights, which hold a zero gate: reported as ``gated_0.5``;
* ``gated_trained`` — the same blend with ``--gate_npz``'s trained gate.

Each (mode, interval, threshold) tracker is built once and evaluated by
``batched_evaluate`` over every scenario × seed dataset; per-run rows
stream as JSON lines, then the per-seed AO deltas against static, pooled
with a 95% t-CI.

    python -m feartracker_tpu_torch.tools.dual_template_ablation --scenarios swap,occlusion,pose \\
        --modes static,ema,gated,gated_trained --intervals 1,4 --seeds 7,13,21,29,37 --frames 48
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile

import torch

from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.evaluate.harness import DTYPES, device_line, load_model, tool_device
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets
from feartracker_tpu_torch.tracker.runtime import ScanTracker

# two-sided 97.5% Student-t quantiles for n-1 degrees of freedom, n = 2..10
_T975 = {1: 12.71, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571,
         6: 2.447, 7: 2.365, 8: 2.306, 9: 2.262}


def mean_ci(xs):
    """(mean, half-width of the 95% CI) of a small sample (t-distribution)."""
    n = len(xs)
    m = sum(xs) / n
    if n < 2:
        return m, float("nan")
    var = sum((x - m) ** 2 for x in xs) / (n - 1)
    t = _T975.get(n - 1, 1.96)
    return m, t * math.sqrt(var / n)


def ci_or_none(ci: float):
    """A CI half-width for a JSON line: rounded, or None for one sample."""
    return None if math.isnan(ci) else round(ci, 4)


class Emitter:
    """Prints each record as a JSON line, appends it to ``out`` when given,
    and keeps it in ``records``."""

    def __init__(self, out=None):
        self.out, self.records = out, []
        if out:
            open(out, "w").close()

    def __call__(self, rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if self.out:
            with open(self.out, "a") as fh:
                fh.write(line + "\n")
        self.records.append(rec)


def run(root=None, scenarios=("drift", "pose", "occlusion", "swap"), drift=1.0,
        modes=("static", "ema", "gated", "gated_trained"), intervals=(4,), frames=48, sequences=8,
        update_threshold=(0.85,), update_rate=0.2, seeds=(7,), gate_npz="fear_xs_gate",
        dtype=torch.bfloat16, device="cuda"):
    """The ablation's rows then its summaries, each printed as a JSON line.
    Datasets are generated under ``root`` (a temporary directory if None),
    or reused where ``<root>/<scenario>_s<seed>`` holds one."""
    work = root or tempfile.mkdtemp(prefix="dual_ablation_")
    datasets = scenario_datasets(work, scenarios, seeds, frames, sequences, drift)
    emit = Emitter()
    for mode in modes:
        for interval in intervals if mode != "static" else [0]:
            for thr in update_threshold if mode != "static" else [update_threshold[0]]:
                kw = {}
                if mode != "static":
                    kw = dict(dynamic_template=True, update_mode="gated" if mode.startswith("gated") else mode,
                              update_threshold=thr, update_rate=update_rate, update_interval=max(interval, 1))
                if mode == "gated_trained":
                    model, prov = load_model(gate_npz)
                    prov = f"{prov}+trained_gate"
                else:
                    model, prov = load_model()
                tracker = ScanTracker(model, dtype=dtype, device=device, **kw)
                # sigmoid of the float32 parameter, as JAX reads it
                gate_val = round(float(torch.sigmoid(model.template_gate.detach().float())[0]), 4) \
                    if mode.startswith("gated") else None
                label = "gated_0.5" if mode == "gated" else mode
                if len(update_threshold) > 1 and mode != "static":
                    label = f"{label}_t{thr:g}"
                for (scenario, seed), ds in datasets.items():
                    res = batched_evaluate(tracker, ds, streams=sequences)
                    emit({"scenario": scenario, "mode": label, "seed": seed, "interval": interval,
                          "threshold": None if mode == "static" else thr, "weights": prov, "gate": gate_val,
                          "ao": round(res["ao"], 4), "sr50": round(res["sr50"], 4), "sr75": round(res["sr75"], 4)})
    rows = list(emit.records)
    static = {(r["scenario"], r["seed"]): r["ao"] for r in rows if r["mode"] == "static"}
    if static:
        print("\n== pooled AO deltas vs static (per-seed paired, 95% t-CI) ==")
        for mode in sorted({r["mode"] for r in rows} - {"static"}):
            for interval in sorted({r["interval"] for r in rows if r["mode"] == mode}):
                for scenario in scenarios:
                    deltas = [r["ao"] - static[(scenario, r["seed"])] for r in rows
                              if r["mode"] == mode and r["interval"] == interval and r["scenario"] == scenario
                              and (scenario, r["seed"]) in static]
                    if not deltas:
                        continue
                    m, ci = mean_ci(deltas)
                    emit({"summary": f"{mode}@{interval}", "scenario": scenario, "n_seeds": len(deltas),
                          "delta_ao_mean": round(m, 4), "delta_ao_ci95": ci_or_none(ci),
                          "positive_seeds": f"{sum(d > 0 for d in deltas)}/{len(deltas)}"})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", default="drift,pose,occlusion,swap")
    ap.add_argument("--drift", type=float, default=1.0,
                    help="appearance_drift level used for the 'drift' scenario")
    ap.add_argument("--modes", default="static,ema,gated,gated_trained")
    ap.add_argument("--intervals", default="4")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--update_threshold", default="0.85",
                    help="confidence gate threshold; a comma list sweeps it (a tracker each)")
    ap.add_argument("--update_rate", type=float, default=0.2)
    ap.add_argument("--seeds", default="7", help="comma list of dataset generator seeds (pooled stats)")
    ap.add_argument("--gate_npz", default="fear_xs_gate",
                    help="trained-gate weights for mode gated_trained (a zoo name or an .npz)")
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.root, args.scenarios.split(","), args.drift, args.modes.split(","),
        [int(i) for i in args.intervals.split(",")], args.frames, args.sequences,
        [float(t) for t in args.update_threshold.split(",")], args.update_rate,
        [int(s) for s in args.seeds.split(",")], args.gate_npz, DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
