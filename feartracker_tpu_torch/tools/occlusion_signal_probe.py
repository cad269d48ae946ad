"""Probe: can a whole-map signal separate good template updates from
occluder/distractor absorptions where the decode confidence cannot? The
counterpart of ``tools/occlusion_signal_probe.py``.

Two cheap signals against the confidence gate:

* **APCE** (average peak-to-correlation energy), which ``ScanTracker.track``
  emits per frame (``outputs["apce"]``, computed by K1): a second mode or a
  flat map lowers it even where the argmax cell saturates;
* **stability**, the count of consecutive confident frames before a frame,
  from the confidence trace.

Per scenario × seed it tracks the val sequences as streams with the harmful
config (ema@1, threshold 0.85), labels every update-eligible frame good or
bad by the predicted box's overlap with the ground truth, and reports each
signal's quantiles per class and, over a sweep of thresholds, the bad
updates each gate blocks against the good ones it sacrifices.

    python -m feartracker_tpu_torch.tools.occlusion_signal_probe --scenarios occlusion,pose,swap \\
        --seeds 7,13 --frames 48
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from feartracker_tpu_torch.core.geometry_np import overlap_xywh_np
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.evaluate.harness import DTYPES, build_scan_tracker, device_line, tool_device
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets


def quantiles(xs, qs=(0.05, 0.25, 0.5, 0.75, 0.95)):
    if not len(xs):
        return None
    return {f"q{int(q * 100)}": round(float(np.quantile(xs, q)), 2) for q in qs}


def run(scenarios=("occlusion", "pose", "swap"), seeds=(7, 13), frames=48, sequences=8, update_threshold=0.85,
        good_iou=0.3, apce_grid=(10, 15, 20, 25, 30, 40), stab_grid=(2, 3, 4, 6), root=None,
        dtype=torch.bfloat16, device="cuda"):
    """The config line, a line per scenario × seed (eligible / good / bad
    counts and the signals' quantiles), the pooled separability and a line
    per gate threshold, each printed as a JSON line."""
    work = root or tempfile.mkdtemp(prefix="occl_probe_")
    tracker, prov = build_scan_tracker(dtype=dtype, device=device, dynamic_template=True, update_mode="ema",
                                       update_threshold=update_threshold, update_rate=0.2, update_interval=1)
    emit = Emitter()
    emit({"weights": prov, "config": "ema@1", "threshold": update_threshold})
    pooled = {"good": {"apce": [], "conf": [], "stab": []}, "bad": {"apce": [], "conf": [], "stab": []}}
    for scenario in scenarios:
        for seed in seeds:
            ds = scenario_datasets(work, [scenario], [seed], frames, sequences, drift=0.0)[scenario, seed]
            # every sequence has the generator's frame size: the streams of one batch
            seqs = [ds[i] for i in range(len(ds))]
            T = min(len(f) for f, _, _ in seqs)
            video = np.stack([np.stack([read_img(f[t]) for f, _, _ in seqs]) for t in range(T)])  # (T, S, H, W, 3)
            gt = np.stack([a[:T] for _, a, _ in seqs], axis=1)  # (T, S, 4)
            state = tracker.init(video[0], gt[0].astype(np.float32))
            state, out = tracker.track(state, video[1:])
            bbox, conf, apce = (out[k].float().cpu().numpy() for k in ("bbox", "confidence", "apce"))
            iou = np.stack([overlap_xywh_np(bbox[t], gt[t + 1]) for t in range(T - 1)])  # (T-1, S)
            # stability before frame t's decision: consecutive earlier frames above the gate
            above = conf > update_threshold
            stab = np.zeros_like(conf, dtype=np.int32)
            run_len = np.zeros(conf.shape[1], dtype=np.int32)
            for t in range(conf.shape[0]):
                stab[t] = run_len
                run_len = np.where(above[t], run_len + 1, 0)
            eligible = above
            good = eligible & (iou >= good_iou)
            bad = eligible & (iou < good_iou)
            for cls, mask in (("good", good), ("bad", bad)):
                pooled[cls]["apce"] += apce[mask].tolist()
                pooled[cls]["conf"] += conf[mask].tolist()
                pooled[cls]["stab"] += stab[mask].tolist()
            emit({"scenario": scenario, "seed": seed, "eligible": int(eligible.sum()), "good": int(good.sum()),
                  "bad": int(bad.sum()), "apce_good": quantiles(apce[good]), "apce_bad": quantiles(apce[bad]),
                  "stab_good": quantiles(stab[good]), "stab_bad": quantiles(stab[bad])})
    print("\n== pooled separability (update-eligible frames only) ==")
    ng, nb = len(pooled["good"]["apce"]), len(pooled["bad"]["apce"])
    emit({"n_good": ng, "n_bad": nb, "apce_good": quantiles(pooled["good"]["apce"]),
          "apce_bad": quantiles(pooled["bad"]["apce"])})
    ga, ba = np.asarray(pooled["good"]["apce"]), np.asarray(pooled["bad"]["apce"])
    gs, bs = np.asarray(pooled["good"]["stab"]), np.asarray(pooled["bad"]["stab"])
    for thr in apce_grid:
        emit({"gate": f"apce>{thr:g}", "bad_blocked": f"{int((ba <= thr).sum())}/{nb}",
              "good_sacrificed": f"{int((ga <= thr).sum())}/{ng}"})
    for m in stab_grid:
        emit({"gate": f"stab>={m}", "bad_blocked": f"{int((bs < m).sum())}/{nb}",
              "good_sacrificed": f"{int((gs < m).sum())}/{ng}"})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", default="occlusion,pose,swap")
    ap.add_argument("--seeds", default="7,13")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--update_threshold", type=float, default=0.85)
    ap.add_argument("--good_iou", type=float, default=0.3,
                    help="GT overlap above which an eligible frame counts as a good update candidate")
    ap.add_argument("--apce_grid", default="10,15,20,25,30,40")
    ap.add_argument("--stab_grid", default="2,3,4,6")
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.scenarios.split(","), [int(s) for s in args.seeds.split(",")], args.frames, args.sequences,
        args.update_threshold, args.good_iou, [float(t) for t in args.apce_grid.split(",")],
        [int(t) for t in args.stab_grid.split(",")], args.root, DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
