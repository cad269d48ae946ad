"""The family Pareto table: quality × speed for every zoo artifact. The
counterpart of ``tools/family_pareto.py``.

Quality: batched AO over the pre-registered mixed structural suite (swap /
pose / occlusion / drift@1.0, seeds 7,13,21,29,37), each entry at its
published widths through its family trunk (K2 at FEAR-M's and FEAR-L's
block shapes), pooled as the per-seed mean ± 95% t-CI of the mixed-suite AO
(the mean over the scenarios per seed).

Speed: tracked frames/s per card from ``python -m
feartracker_tpu_torch.tools.family_bench`` on the card, passed with
``--fps fear_xs=...,fear_m=...`` and printed as ``fps_per_card``; without
it the table carries quality only.

    python -m feartracker_tpu_torch.tools.family_pareto \\
        --entries fear_xs:fear_xs,fear_xs_repo:fear_xs,fear_m_repo:fear_m,fear_l_repo:fear_l
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.evaluate.harness import DTYPES, build_scan_tracker, device_line, tool_device
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter, ci_or_none, mean_ci
from feartracker_tpu_torch.tools.family_bench import TOWERNUM
from feartracker_tpu_torch.tools.gate_v2_ablation import SCENARIOS, SEEDS
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets

ENTRIES = "fear_xs:fear_xs,fear_xs_repo:fear_xs,fear_m_repo:fear_m,fear_l_repo:fear_l"


def run(entries=ENTRIES, fps=None, scenarios=SCENARIOS, seeds=SEEDS, frames=48, sequences=8, drift=1.0, root=None,
        out=None, dtype=torch.bfloat16, device="cuda"):
    """A JSON line per entry (``<weights>:<model_name>``; a zoo name or an
    ``.npz``): its mixed-suite AO with the CI and its AO per scenario, or
    why it was skipped; ``fps`` maps a model name to family_bench's
    frames/s on the card."""
    fps = fps or {}
    work = root or tempfile.mkdtemp(prefix="pareto_")
    datasets = scenario_datasets(work, scenarios, seeds, frames, sequences, drift)
    emit = Emitter(out)
    for entry in entries.split(","):
        weights, model_name = entry.split(":")
        try:
            tracker, prov = build_scan_tracker(weights, dtype=dtype, device=device, model_name=model_name,
                                               towernum=TOWERNUM.get(model_name, 2))
        except (OSError, KeyError, ValueError, RuntimeError) as e:  # missing or mismatched weights
            emit({"entry": weights, "skipped": f"{type(e).__name__}: {e}"})
            continue
        per_seed_mixed, per_scenario = [], {s: [] for s in scenarios}
        for seed in seeds:
            aos = []
            for scenario in scenarios:
                res = batched_evaluate(tracker, datasets[(scenario, seed)], streams=sequences)
                aos.append(res["ao"])
                per_scenario[scenario].append(res["ao"])
            per_seed_mixed.append(sum(aos) / len(aos))
        m, ci = mean_ci(per_seed_mixed)
        emit({"entry": weights, "model": model_name, "weights": prov, "mixed_ao": round(m, 4),
              "mixed_ao_ci95": ci_or_none(ci), **{f"ao_{s}": round(sum(v) / len(v), 4) for s, v in per_scenario.items()},
              **({"fps_per_card": fps[model_name]} if model_name in fps else {})})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--entries", default=ENTRIES,
                    help="comma list of <weights>:<model_name>; <weights> is a zoo name or an .npz path")
    ap.add_argument("--fps", default="",
                    help="comma list of <model_name>=<frames/s per card> from family_bench on the card")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--drift", type=float, default=1.0)
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--out", default=None, help="write the JSON lines here too")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    fps = {k: float(v) for k, v in (kv.split("=") for kv in filter(None, args.fps.split(",")))}
    run(args.entries, fps, args.scenarios.split(","), [int(s) for s in args.seeds.split(",")], args.frames,
        args.sequences, args.drift, args.root, args.out, DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
