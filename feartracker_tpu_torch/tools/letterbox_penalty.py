"""Measure the batched evaluation's letterbox resolution penalty: the
counterpart of ``tools/letterbox_penalty.py``.

``batched_evaluate`` letterboxes every sequence into one canvas, so a
sequence larger than the canvas is tracked at reduced resolution. Each
scenario × seed scene is generated at ``--scale``× resolution from the
random stream of the 1× scene (``size·scale, obj_scale=scale``), and three
paths are scored on it:

* ``sequential``  — ``FEARTracker`` frame by frame at full resolution (the
  reference's protocol, no letterbox);
* ``batched_fit`` — ``batched_evaluate`` with a canvas that fits the
  sequences (letterbox scale 1): the batched runtime's own effect;
* ``batched_lb``  — ``batched_evaluate`` with the 1× canvas: the letterboxed
  production path, tracking at 1/scale resolution.

``batched_lb − batched_fit`` (paired per seed, pooled 95% t-CI) is the
letterbox penalty; ``batched_fit − sequential`` the batched path's. Both
trackers run the one ``--dtype``.

    python -m feartracker_tpu_torch.tools.letterbox_penalty --scale 2 --scenarios drift,pose \\
        --seeds 7,13,21 --frames 48 --sequences 8
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
from feartracker_tpu_torch.evaluate.harness import DTYPES, device_line, load_model, tool_device
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter, ci_or_none, mean_ci
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.tracker.tracker import FEARTracker

PATHS = ("sequential", "batched_fit", "batched_lb")


def run(scenarios=("drift", "pose"), seeds=(7, 13, 21), scale=2.0, canvas_h=360, canvas_w=640, frames=48,
        sequences=8, paths=PATHS, root=None, dtype=torch.bfloat16, device="cuda"):
    """A row per scenario × seed × path, then the pooled paired deltas,
    each printed as a JSON line."""
    for path in paths:
        if path not in PATHS:
            raise ValueError(f"unknown path {path!r}; the paths are {PATHS}")
    canvas = (canvas_h, canvas_w)
    big = (int(round(canvas_h * scale)), int(round(canvas_w * scale)))
    work = root or tempfile.mkdtemp(prefix="letterbox_")
    datasets = scenario_datasets(work, scenarios, seeds, frames, sequences, drift=1.0, suffix=f"_x{scale:g}",
                                 size=big, obj_scale=scale)
    model, prov = load_model()
    scan_tracker = ScanTracker(model, dtype=dtype, device=device)
    seq_tracker = FEARTracker(model, dtype=dtype, device=device)
    emit = Emitter()
    for (scenario, seed), ds in sorted(datasets.items()):
        for path in paths:
            if path == "sequential":
                res = evaluate_tracker(seq_tracker, ds)
            else:
                res = batched_evaluate(scan_tracker, ds, streams=sequences,
                                       frame_hw=canvas if path == "batched_lb" else big)
            emit({"scenario": scenario, "seed": seed, "path": path,
                  "canvas": list(canvas if path == "batched_lb" else big), "weights": prov, "scale": scale,
                  "ao": round(res["ao"], 4), "sr50": round(res["sr50"], 4), "sr75": round(res["sr75"], 4)})
    by = {(r["scenario"], r["seed"], r["path"]): r["ao"] for r in emit.records}
    print("\n== pooled paired AO deltas (95% t-CI) ==")
    for name, a, b in (("letterbox_penalty", "batched_lb", "batched_fit"),
                       ("batched_vs_sequential", "batched_fit", "sequential")):
        for scenario in scenarios:
            deltas = [by[(scenario, s, a)] - by[(scenario, s, b)] for s in seeds
                      if (scenario, s, a) in by and (scenario, s, b) in by]
            if not deltas:
                continue
            m, ci = mean_ci(deltas)
            emit({"summary": name, "scenario": scenario, "n_seeds": len(deltas), "delta_ao_mean": round(m, 4),
                  "delta_ao_ci95": ci_or_none(ci)})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", default="drift,pose")
    ap.add_argument("--seeds", default="7,13,21")
    ap.add_argument("--scale", type=float, default=2.0, help="sequence resolution as a multiple of the canvas")
    ap.add_argument("--canvas_h", type=int, default=360)
    ap.add_argument("--canvas_w", type=int, default=640)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.scenarios.split(","), [int(s) for s in args.seeds.split(",")], args.scale, args.canvas_h,
        args.canvas_w, args.frames, args.sequences, args.paths.split(","), args.root, DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
