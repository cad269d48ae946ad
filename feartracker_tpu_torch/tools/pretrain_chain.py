"""The classification-pretrain → tracking-quality chain at full FEAR-XS
geometry (256²/128², bfloat16): the counterpart of ``tools/pretrain_chain.py``.

The reference trains its tracker from an ImageNet-pretrained FBNet-C trunk
(ref: model_training/model/blocks.py:22-25, config/model/fear.yaml:5). This
tool runs the port's re-expression of that start end to end:

1. classification-pretrain the FEAR-XS trunk (``pretrain_trunk``) on a
   synthetic class-structured ImageFolder (``make_class_dataset``);
2. train three trackers on one synthetic tracking set at identical budget,
   seed and hyperparameters, differing only in initialisation:
   ``scratch`` (random), ``cls_pretrain`` (the pretrained trunk through
   ``model.pretrained_weights`` → ``convert/load.py:transfer_variables``) and
   ``recovered`` (``convert/load.py:default_weights_path()``: ``$FEAR_WEIGHTS``
   when set, e.g. the reference's ``Tracker.mlmodel``, else the packaged
   ``fear_xs.npz``, the same weights recovered from it);
3. print each arm's per-epoch train loss and online-validation box IoU (K1
   and K2 run there) and a three-way summary.

All arms run in one process. Everything is written under ``--work`` (a
temporary directory by default). On a host without cv2 (the card's), pass
``--device_augs``: the loader then stops at uint8 crops and the train step
augments on the device.

    python -m feartracker_tpu_torch.tools.pretrain_chain --epochs 12 --device_augs
    python -m feartracker_tpu_torch.tools.pretrain_chain --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from feartracker_tpu_torch.convert.load import default_weights_path
from feartracker_tpu_torch.evaluate.harness import device_line, tool_device
from feartracker_tpu_torch.tools import pretrain_trunk
from feartracker_tpu_torch.tools.make_class_dataset import generate_classes
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate
from feartracker_tpu_torch.train.loop import Trainer


def platform_of(device) -> str:
    """A config's ``platform`` for a torch device: ``gpu`` (the card) or
    ``cpu``."""
    return "cpu" if torch.device(device).type == "cpu" else "gpu"


def tracker_config(root, exp, platform, epochs, pretrained, lr, batch, num_samples, seed):
    return {
        "platform": platform,
        "num_devices": 1,
        "sync_bn": False,
        "precision": "bfloat16",
        "seed": seed,
        "model": {
            "name": "fear_xs", "adjust_channels": 256, "towernum": 2,
            **({"pretrained_weights": pretrained} if pretrained else {}),
        },
        "tracker": {
            "score_size": 16, "total_stride": 16, "instance_size": 256,
            "template_size": 128, "penalty_k": 0.062, "window_influence": 0.38,
            "lr": 0.765, "template_bbox_offset": 0.2, "search_context": 2,
        },
        "optimizer": {"name": "adam", "lr": lr},
        "scheduler": {"mode": "max", "patience": 2, "factor": 0.5},
        "loss": {"coeffs": {"TARGET_CLASSIFICATION_KEY": 1, "TARGET_REGRESSION_LABEL_KEY": 1}},
        "batch_size": {"train": batch, "val": 1},
        "num_workers": 2,
        "max_epochs": epochs,
        "early_stopping": epochs + 1,
        "metric_mode": "max",
        "max_val_samples": 8,
        "sanity_steps": 0,
        "log_every_n_steps": 50,
        "save_top_k": 0,
        "experiment": {"folder": exp, "name": "CHAIN"},
        "train": {"datasets": [{
            "name": "synthetic", "root": root,
            "sizes": {
                "search_image_size": 256, "template_image_size": 128,
                "search_context": 2, "template_bbox_offset": 0.2,
                "search_image_shift": 32, "search_image_scale": 0.2,
                "context_range": 1,
            },
            "regression_weight_label_size": 16,
            "sampling": {
                "type": "track", "data_path": f"{root}/train.csv",
                "negative_ratio": 0, "frame_offset": 8,
                "num_samples": num_samples, "clip_range": True,
            },
        }]},
        "val": {"datasets": [{"name": "got10k", "root_dir": f"{root}/got10k", "subset": "val"}]},
    }


def epoch_rows(config: dict, epochs: int, head: dict, device_augs: bool = False, wall: bool = True) -> list:
    """A ``Trainer`` on ``config`` (``device_augs`` switched on when asked)
    for ``epochs`` epochs of train + validate + resample, one JSON line an
    epoch (``head`` first, then ``epoch``, ``loss``, ``val_box_iou``), and
    with ``wall`` a last line of the wall seconds. → the epoch rows."""
    if device_augs:
        config = dict(config, device_augs=True)
    trainer = Trainer(config)
    trainer.setup_data()
    trainer.setup_state(0)
    history = []
    t0 = time.time()
    for epoch in range(epochs):
        tm = trainer.train_epoch(epoch)
        vm = trainer.validate(epoch)
        history.append({**head, "epoch": epoch, "loss": round(float(tm["loss"]), 4),
                        "val_box_iou": round(float(vm.get("box_iou", 0.0)), 4)})
        print(json.dumps(history[-1]), flush=True)
        trainer.train_dataset.resample()
    if wall:
        print(json.dumps({**head, "wall_s": round(time.time() - t0, 1)}), flush=True)
    return history


def summary(results: dict) -> dict:
    """Each arm's best and final validation box IoU and final loss."""
    return {arm: {"best_val_box_iou": max(h["val_box_iou"] for h in hist),
                  "final_val_box_iou": hist[-1]["val_box_iou"], "final_loss": hist[-1]["loss"]}
            for arm, hist in results.items()}


def run(epochs=12, lr=1e-3, batch=32, num_samples=256, seed=0, tracks=24, track_frames=16, per_class=120,
        pretrain_epochs=3, pretrain_npz=None, arms=("scratch", "cls_pretrain", "recovered"), work=None,
        device="cuda", device_augs=False) -> list:
    """The pretraining record, each arm's epoch rows and the summary, each
    printed as a JSON line."""
    work = work or tempfile.mkdtemp(prefix="chain_")
    platform = platform_of(device)
    records = []
    # 1. classification pretraining (or reuse)
    npz = pretrain_npz
    if npz is None:
        cls_root = os.path.join(work, "cls")
        generate_classes(cls_root, per_class=per_class, seed=seed)
        npz = os.path.join(work, "fear_xs_trunk.npz")
        rec = pretrain_trunk.run(cls_root, "fear_xs", npz, epochs=pretrain_epochs, batch_size=batch, image_size=128,
                                 seed=seed, device=device)
        records.append({"pretrain_final": rec["history"][-1], "arrays": rec["arrays"]})
        print(json.dumps(records[-1]), flush=True)

    # 2. the shared tracking dataset
    root = os.path.join(work, "track")
    generate(root, tracks=tracks, frames=track_frames, val_sequences=4, seed=11, size=(288, 384), obj_scale=1.5)

    # 3. the arms: identical budget, seed and hyperparameters
    inits = {"scratch": None, "cls_pretrain": npz, "recovered": default_weights_path()}
    results = {}
    for arm in arms:
        config = tracker_config(root, os.path.join(work, f"exp_{arm}"), platform, epochs, inits[arm], lr, batch,
                                num_samples, seed)
        results[arm] = epoch_rows(config, epochs, {"arm": arm}, device_augs)
        records += results[arm]
    records.append({"summary": summary(results)})
    print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--num_samples", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tracks", type=int, default=24)
    ap.add_argument("--track_frames", type=int, default=16)
    ap.add_argument("--per_class", type=int, default=120)
    ap.add_argument("--pretrain_epochs", type=int, default=3)
    ap.add_argument("--pretrain_npz", default=None, help="reuse an existing pretrained-trunk npz (skips step 1)")
    ap.add_argument("--arms", default="scratch,cls_pretrain,recovered")
    ap.add_argument("--work", default=None, help="where the datasets, the trunk and the runs go (default: temporary)")
    ap.add_argument("--device_augs", action="store_true",
                    help="staged loader + augmentation in the train step (needed where cv2 is absent)")
    ap.add_argument("--smoke", action="store_true", help="tiny budget for a quick run")
    args = ap.parse_args(argv)
    if args.smoke:
        args.epochs, args.batch, args.num_samples = 1, 4, 8
        args.tracks, args.track_frames, args.per_class = 4, 6, 8
        args.pretrain_epochs = 1
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.epochs, args.lr, args.batch, args.num_samples, args.seed, args.tracks, args.track_frames,
        args.per_class, args.pretrain_epochs, args.pretrain_npz, args.arms.split(","), args.work, device,
        args.device_augs)


if __name__ == "__main__":
    main()
