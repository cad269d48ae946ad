"""Quality of the bfloat16 quantized deployment export: the counterpart of
``tools/quantized_quality.py``.

The exported pairs (``convert/export.py``: ``tracker_init`` / ``tracker``
in float32 and ``*_quantized`` in bfloat16, K2 inside them as the operator
``fear_port::ir_block``) are driven through ``ExportedTracker``
(``FEARTracker``'s crop, geometry and K1 decode around the graphs):

1. **Trajectory divergence** on the reference demo video (``--video``,
   default ``assets/test.mp4`` in the checkout; a ``.npy`` of frames, or any
   file cv2 decodes): the float32 pair against the quantized pair, and the
   in-process float32 ``FEARTracker`` against the float32 pair, per-frame
   centre distance (px) and box IoU. Skipped, with the reason, when the
   video is missing;
2. **ΔAO on the synthetic suite**: the sequential GOT-10k protocol over
   both pairs per scenario × seed, the paired per-seed AO deltas pooled
   with a 95% t-CI.

    python -m feartracker_tpu_torch.tools.quantized_quality --frames 120 --scenarios drift,pose \\
        --seeds 7,13,21
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from feartracker_tpu_torch.convert.export import ExportedTracker, export_tracker
from feartracker_tpu_torch.convert.load import REPO_ROOT, default_weights_path, load_fear_net, load_variables
from feartracker_tpu_torch.core.geometry_np import overlap_xywh_np
from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
from feartracker_tpu_torch.evaluate.harness import DEMO_BBOX, device_line, tool_device
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tools.dual_template_ablation import Emitter, ci_or_none, mean_ci
from feartracker_tpu_torch.tools.make_synthetic_dataset import scenario_datasets
from feartracker_tpu_torch.tracker.tracker import FEARTracker
from feartracker_tpu_torch.utils.video import read_video

DEMO_VIDEO = os.path.join(REPO_ROOT, "assets", "test.mp4")


def trajectory(tracker, frames, init_bbox):
    tracker.initialize(frames[0], np.asarray(init_bbox, np.float64))
    boxes = [np.asarray(init_bbox, np.float64)]
    for f in frames[1:]:
        boxes.append(np.asarray(tracker.update(f)["bbox"], np.float64))
    return np.stack(boxes)


def divergence(a, b):
    """Per-frame centre distance (px) and IoU stats between two trajectories."""
    ca = a[:, :2] + a[:, 2:] / 2
    cb = b[:, :2] + b[:, 2:] / 2
    dist = np.linalg.norm(ca - cb, axis=1)
    iou = overlap_xywh_np(a, b)
    return {
        "center_px_mean": round(float(dist.mean()), 3),
        "center_px_median": round(float(np.median(dist)), 3),
        "center_px_p95": round(float(np.percentile(dist, 95)), 3),
        "center_px_max": round(float(dist.max()), 3),
        "iou_mean": round(float(iou.mean()), 4),
        "iou_min": round(float(iou.min()), 4),
    }


def run(export_dir=None, video=DEMO_VIDEO, frames=120, scenarios=("drift", "pose"), seeds=(7, 13, 21),
        seq_frames=24, sequences=4, root=None, device="cuda"):
    """The divergence lines (or the skip), a row per scenario × seed ×
    pair, then the pooled quantized − float32 deltas, each printed as a
    JSON line. The pairs are exported into ``export_dir`` unless it holds
    them; the datasets are generated under ``root`` unless it holds them."""
    model = load_fear_net(FEARNet(), load_variables(default_weights_path()))
    out_dir = export_dir or tempfile.mkdtemp(prefix="export_quality_")
    if not os.path.isfile(os.path.join(out_dir, "tracker_quantized.pt2")):
        export_tracker(model, out_dir, device=device)

    def pair(sfx):
        return ExportedTracker(os.path.join(out_dir, f"tracker_init{sfx}.pt2"),
                               os.path.join(out_dir, f"tracker{sfx}.pt2"), device=device)

    fp32, quant = pair(""), pair("_quantized")
    emit = Emitter()
    if os.path.isfile(video):
        clip = read_video(video, max_frames=frames)
        t_proc = trajectory(FEARTracker(model, device=device), clip, DEMO_BBOX)
        t_fp32 = trajectory(fp32, clip, DEMO_BBOX)
        t_quant = trajectory(quant, clip, DEMO_BBOX)
        emit({"divergence": "quantized_vs_fp32_export", "frames": len(clip), **divergence(t_quant, t_fp32)})
        emit({"divergence": "fp32_export_vs_inprocess", "frames": len(clip), **divergence(t_fp32, t_proc)})
    else:
        emit({"divergence": "skipped", "reason": f"{video} missing"})

    work = root or tempfile.mkdtemp(prefix="quant_ao_")
    datasets = scenario_datasets(work, scenarios, seeds, seq_frames, sequences, drift=1.0)
    deltas_all = {}
    for (scenario, seed), ds in datasets.items():
        ao = {}
        for name, tr in (("fp32_export", fp32), ("quantized_export", quant)):
            res = evaluate_tracker(tr, ds)
            ao[name] = res["ao"]
            emit({"scenario": scenario, "seed": seed, "path": name, "ao": round(res["ao"], 4),
                  "sr50": round(res["sr50"], 4)})
        deltas_all.setdefault(scenario, []).append(ao["quantized_export"] - ao["fp32_export"])
    print("\n== quantized − fp32 AO (paired per seed, 95% t-CI) ==")
    for scenario, deltas in deltas_all.items():
        m, ci = mean_ci(deltas)
        emit({"summary": "quantized_delta_ao", "scenario": scenario, "n_seeds": len(deltas),
              "delta_ao_mean": round(m, 4), "delta_ao_ci95": ci_or_none(ci)})
    return emit.records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--export_dir", default=None, help="reuse an existing export dir")
    ap.add_argument("--video", default=DEMO_VIDEO)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--scenarios", default="drift,pose")
    ap.add_argument("--seeds", default="7,13,21")
    ap.add_argument("--seq_frames", type=int, default=24)
    ap.add_argument("--sequences", type=int, default=4)
    ap.add_argument("--root", default=None, help="dataset root to reuse or fill (default: a temporary directory)")
    ap.add_argument("--device", "--platform", default=None,
                    help="where the pairs are exported and run (default: BENCH_DEVICE, else the card)")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.export_dir, args.video, args.frames, args.scenarios.split(","), [int(s) for s in args.seeds.split(",")],
        args.seq_frames, args.sequences, args.root, device)


if __name__ == "__main__":
    main()
