"""End-to-end check of the training stack on a synthetic dataset: AO of the
untrained and of the trained fear_tiny (64²/32²) through ``FEARTracker``
and ``evaluate_tracker`` around one ``Trainer.fit``. The counterpart of
``tools/synthetic_e2e.py``.

``--root`` holds a dataset of ``make_synthetic_dataset`` (``train.csv`` and
``got10k/val``); checkpoints and logs go under ``--exp`` (default
``<root>/synth_exp``). Pass ``--device_augs`` where cv2 is absent (the card's
host).

    python -m feartracker_tpu_torch.tools.make_synthetic_dataset --root /tmp/synth
    python -m feartracker_tpu_torch.tools.synthetic_e2e --root /tmp/synth
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from feartracker_tpu_torch.data.sequence import GOT10kDataset
from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
from feartracker_tpu_torch.evaluate.harness import device_line, tool_device
from feartracker_tpu_torch.tools.pretrain_chain import platform_of
from feartracker_tpu_torch.tracker.tracker import FEARTracker
from feartracker_tpu_torch.train.loop import Trainer


def build_config(root: str, exp: str, platform: str, epochs: int = 30) -> dict:
    return {
        "platform": platform, "num_devices": 1, "sync_bn": False, "precision": "float32",
        "seed": 0,
        "model": {"name": "fear_tiny", "adjust_channels": 48, "towernum": 1},
        "tracker": {"score_size": 8, "total_stride": 8, "instance_size": 64, "template_size": 32,
                    "penalty_k": 0.062, "window_influence": 0.38, "lr": 0.765,
                    "template_bbox_offset": 0.2, "search_context": 2},
        "optimizer": {"name": "adam", "lr": 3e-4},
        "scheduler": {"mode": "max", "patience": 8, "factor": 0.5},
        "loss": {"coeffs": {"TARGET_CLASSIFICATION_KEY": 1, "TARGET_REGRESSION_LABEL_KEY": 1}},
        "batch_size": {"train": 32, "val": 1},
        "num_workers": 2, "max_epochs": epochs, "min_epochs": min(5, epochs), "early_stopping": 30,
        "metric_mode": "max", "max_val_samples": 24, "log_every_n_steps": 16,
        "save_top_k": 2, "sanity_steps": 1, "check_val_every_n_epoch": min(5, epochs),
        "experiment": {"folder": exp, "name": "SYNTH"},
        "train": {"datasets": [{
            "name": "synthetic", "root": root,
            "sizes": {"search_image_size": 64, "template_image_size": 32, "search_context": 2,
                      "template_bbox_offset": 0.2, "search_image_shift": 8, "search_image_scale": 0.2,
                      "context_range": 1},
            "regression_weight_label_size": 8,
            "sampling": {"type": "track", "data_path": f"{root}/train.csv", "negative_ratio": 0,
                         "frame_offset": 10, "num_samples": 256, "clip_range": True},
        }]},
        "val": {"datasets": [{"name": "got10k", "root_dir": f"{root}/got10k", "subset": "val"}]},
    }


def run(root: str, exp=None, epochs: int = 30, device="cuda", device_augs=False) -> list:
    """AO/SR50 before and after ``Trainer.fit``, each printed as a JSON line,
    then the total. ``epochs`` below the JAX script's 30 also bring
    ``min_epochs`` and the validation interval (5) down to it."""
    exp = exp or os.path.join(root, "synth_exp")
    config = build_config(root, exp, platform_of(device), epochs)
    if device_augs:
        config["device_augs"] = True
    trainer = Trainer(config)
    trainer.setup_data()
    trainer.setup_state(0)
    val = GOT10kDataset(os.path.join(root, "got10k"), subset="val")
    records = []

    def ao_now(tag):
        tracker = FEARTracker(trainer.state.model, trainer.tracker_config, dtype=torch.float32, device=trainer.device)
        res = evaluate_tracker(tracker, val, max_frames=24)
        records.append({"model": tag, "ao": round(float(res["ao"]), 4), "sr50": round(float(res["sr50"]), 4)})
        print(json.dumps(records[-1]), flush=True)
        return res

    t0 = time.time()
    before = ao_now("untrained")
    trainer.fit()
    after = ao_now("trained")
    records.append({"total_s": round(time.time() - t0, 1), "steps": int(trainer.state.step),
                    "ao_before": round(float(before["ao"]), 4), "ao_after": round(float(after["ao"]), 4)})
    print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="dataset root from make_synthetic_dataset")
    ap.add_argument("--exp", default=None, help="default: <root>/synth_exp")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--device_augs", action="store_true",
                    help="staged loader + augmentation in the train step (needed where cv2 is absent)")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.root, args.exp, args.epochs, device, args.device_augs)


if __name__ == "__main__":
    main()
