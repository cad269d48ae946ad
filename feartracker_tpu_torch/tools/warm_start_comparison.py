"""From-scratch against partial-warm-start training: the counterpart of
``tools/warm_start_comparison.py``.

Trains one fear_tiny configuration (64²/32²) twice on a synthetic dataset:
from random init, and partially warm-started from the packaged FEAR-XS
weights (only the shared trunk prefix transfers: the stem and block 0's
depthwise; ``convert/load.py:transfer_variables``), each through the port's
``Trainer`` (validation through K1 and K2), and prints the per-epoch
validation box IoU and train loss of both, then a summary, as JSON lines.
Data and runs go under ``--work``; pass ``--device_augs`` where cv2 is
absent (the card's host).

    python -m feartracker_tpu_torch.tools.warm_start_comparison --epochs 4 --tracks 12 --frames 12
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from feartracker_tpu_torch.evaluate.harness import device_line, tool_device
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate
from feartracker_tpu_torch.tools.pretrain_chain import epoch_rows, platform_of


def _config(root, csv_path, exp, epochs, pretrained, platform=""):
    model = {"name": "fear_tiny", "adjust_channels": 24, "towernum": 1}
    if pretrained:
        model["pretrained_weights"] = pretrained
    return {
        "platform": platform,
        "num_devices": 1,
        "sync_bn": False,
        "precision": "float32",
        "seed": 0,
        "model": model,
        "tracker": {
            "score_size": 8, "total_stride": 8, "instance_size": 64, "template_size": 32,
            "penalty_k": 0.062, "window_influence": 0.38, "lr": 0.765,
            "template_bbox_offset": 0.2, "search_context": 2,
        },
        "optimizer": {"name": "adam", "lr": 1e-3},
        "scheduler": {"mode": "max", "patience": 5, "factor": 0.5},
        "batch_size": {"train": 8, "val": 1},
        "num_workers": 2,
        "max_epochs": epochs,
        "early_stopping": epochs + 1,
        "metric_mode": "max",
        "max_val_samples": 16,
        "sanity_steps": 0,
        "log_every_n_steps": 10,
        "save_top_k": 1,
        "experiment": {"folder": exp, "name": "CMP"},
        "train": {
            "datasets": [
                {
                    "name": "synthetic",
                    "root": root,
                    "sizes": {
                        "search_image_size": 64, "template_image_size": 32,
                        "search_context": 2, "template_bbox_offset": 0.2,
                        "search_image_shift": 8, "search_image_scale": 0.2,
                        "context_range": 1,
                    },
                    "regression_weight_label_size": 8,
                    "sampling": {
                        "type": "track", "data_path": csv_path, "negative_ratio": 0,
                        "frame_offset": 6, "num_samples": 64, "clip_range": True,
                    },
                }
            ]
        },
        "val": {"datasets": [{"name": "got10k", "root_dir": os.path.join(root, "got10k"), "subset": "val"}]},
    }


def run(epochs=4, tracks=12, frames=12, val_sequences=4, work=None, device="cuda", device_augs=False) -> list:
    """Both arms' epoch rows, then the summary, each printed as a JSON line."""
    work = work or tempfile.mkdtemp(prefix="warmcmp_")
    root = os.path.join(work, "data")
    csv_path = generate(root, tracks=tracks, frames=frames, val_sequences=val_sequences, seed=11)
    arms = {}
    for init, pretrained in (("scratch", None), ("partial_warm", "fear_xs")):
        cfg = _config(root, csv_path, os.path.join(work, f"exp_{init}"), epochs, pretrained, platform_of(device))
        arms[init] = epoch_rows(cfg, epochs, {"init": init}, device_augs, wall=False)
    rec = {"summary": {
        "final_val_box_iou": {k: h[-1]["val_box_iou"] for k, h in arms.items()},
        "best_val_box_iou": {k: max(r["val_box_iou"] for r in h) for k, h in arms.items()},
    }}
    print(json.dumps(rec), flush=True)
    return arms["scratch"] + arms["partial_warm"] + [rec]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--tracks", type=int, default=12)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--val_sequences", type=int, default=4)
    ap.add_argument("--work", default=None, help="where the dataset and the runs go (default: temporary)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--device_augs", action="store_true",
                    help="staged loader + augmentation in the train step (needed where cv2 is absent)")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.epochs, args.tracks, args.frames, args.val_sequences, args.work, device, args.device_augs)


if __name__ == "__main__":
    main()
