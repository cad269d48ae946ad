"""Full-geometry FEAR-XS training on the card: fine-tune from the recovered
weights on synthetic data through the whole training stack (``Trainer.fit``
with checkpoints, plateau LR and online tracking validation through K1 and
K2), then a run resumed from the last checkpoint with a step continuity
check. The card's counterpart of ``tools/tpu_train_run.py``.

The warm start is ``convert/load.py:default_weights_path()``: the file in
``$FEAR_WEIGHTS`` when set (e.g. the reference's ``Tracker.mlmodel``), else
the packaged ``fear_xs.npz``, the same weights recovered from it.
Checkpoints and logs go under ``--exp`` (default ``<root>/train_run_exp``).
Pass ``--device_augs`` where cv2 is absent (the card's host).

    python -m feartracker_tpu_torch.tools.make_synthetic_dataset --root /tmp/synth_xl --tracks 24 \\
        --frames 16 --val_sequences 4 --height 288 --width 384
    python -m feartracker_tpu_torch.tools.train_run --root /tmp/synth_xl --device_augs
"""

from __future__ import annotations

import argparse
import json
import os
import time

from feartracker_tpu_torch.convert.load import default_weights_path
from feartracker_tpu_torch.evaluate.harness import device_line, tool_device
from feartracker_tpu_torch.tools.pretrain_chain import platform_of
from feartracker_tpu_torch.train.loop import Trainer


def build_config(root: str, exp: str, platform: str, epochs: int, resume: bool,
                 dual_template: bool = False, device_augs: bool = False):
    return {
        "dual_template": dual_template,
        "device_augs": device_augs,
        "platform": platform,
        "num_devices": 1,
        "sync_bn": False,
        "precision": "bfloat16",
        "seed": 0,
        "model": {
            "name": "fear_xs",
            "adjust_channels": 256,
            "towernum": 2,
            "pretrained_weights": default_weights_path(),
        },
        "tracker": {
            "score_size": 16, "total_stride": 16, "instance_size": 256,
            "template_size": 128, "penalty_k": 0.062, "window_influence": 0.38,
            "lr": 0.765, "template_bbox_offset": 0.2, "search_context": 2,
        },
        "optimizer": {"name": "adam", "lr": 1e-4},
        "scheduler": {"mode": "max", "patience": 1, "factor": 0.5},
        "loss": {"coeffs": {"TARGET_CLASSIFICATION_KEY": 1, "TARGET_REGRESSION_LABEL_KEY": 1}},
        "batch_size": {"train": 32, "val": 1},
        "num_workers": 2,
        "max_epochs": epochs,
        "min_epochs": 1,
        "early_stopping": 50,
        "metric_mode": "max",
        "max_val_samples": 12,
        "log_every_n_steps": 4,
        "save_top_k": 2,
        "sanity_steps": 1,
        "check_val_every_n_epoch": 1,
        "resume": resume,
        "experiment": {"folder": exp, "name": "TPU_XS"},
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
                "num_samples": 256, "clip_range": True,
            },
        }]},
        "val": {"datasets": [{"name": "got10k", "root_dir": f"{root}/got10k", "subset": "val"}]},
    }


def run(root: str, exp=None, epochs: int = 4, resume_epochs: int = 2, dual: bool = False, device_augs: bool = False,
        resume: bool = False, device="cuda", overrides=None) -> list:
    """``Trainer.fit`` for ``epochs`` epochs (one JSON line an epoch: its
    train means and validation metrics), then, unless ``resume_epochs`` is
    0, a fresh ``Trainer`` with ``resume`` for ``resume_epochs`` more; raises
    unless its steps are the first run's plus ``resume_epochs`` epochs'.
    ``resume`` resumes the first run too (a crash-recovery drill).
    ``overrides`` are merged into both configs' top level (a cut budget:
    ``train_percent``, ``batch_size``)."""
    exp = exp or os.path.join(root, "train_run_exp")
    platform = platform_of(device)

    def config(total_epochs, resume_flag):
        cfg = build_config(root, exp, platform, total_epochs, resume_flag, dual_template=dual,
                           device_augs=device_augs)
        cfg.update(overrides or {})
        return cfg

    t0 = time.time()
    trainer = Trainer(config(epochs, resume))
    trainer.setup_data()
    trainer.setup_state(0)
    # per-epoch curves through the epoch hooks
    curves = []
    orig_train_epoch, orig_validate = trainer.train_epoch, trainer.validate

    def train_epoch(epoch):
        te0 = time.time()
        m = orig_train_epoch(epoch)
        curves.append({"epoch": epoch, **{k: round(float(v), 4) for k, v in m.items()},
                       "epoch_s": round(time.time() - te0, 1)})
        return m

    def validate(epoch):
        v = orig_validate(epoch)
        if curves and epoch >= 0:
            curves[-1].update({f"val_{k}": round(float(x), 4) for k, x in v.items()})
        return v

    trainer.train_epoch, trainer.validate = train_epoch, validate
    trainer.fit()
    steps_first = int(trainer.state.step)
    for c in curves:
        print(json.dumps(c), flush=True)
    records = curves + [{"first_run_steps": steps_first, "wall_s": round(time.time() - t0, 1)}]
    print(json.dumps(records[-1]), flush=True)

    if resume_epochs:
        resumed = Trainer(config(epochs + resume_epochs, True))
        resumed.setup_data()
        resumed.setup_state(0)
        resumed.fit()
        steps_resumed = int(resumed.state.step)
        expected = steps_first + resume_epochs * (steps_first // epochs)
        records.append({"resumed_from_step": steps_first, "resumed_steps": steps_resumed,
                        "expected_steps": expected, "resume_continuity": steps_resumed == expected})
        print(json.dumps(records[-1]), flush=True)
        # continuity: the epoch counter resumed, exactly resume_epochs more epochs
        if steps_resumed != expected:
            raise RuntimeError(f"resume continuity: {steps_first} -> {steps_resumed} steps, expected {expected}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="dataset root from make_synthetic_dataset")
    ap.add_argument("--exp", default=None, help="default: <root>/train_run_exp")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--resume_epochs", type=int, default=2,
                    help="extra epochs for the resumed run (0 = skip resume check)")
    ap.add_argument("--dual", action="store_true", help="train the dual-template module")
    ap.add_argument("--device_augs", action="store_true",
                    help="staged loader + on-device augmentation in the train step (needed where cv2 is absent)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the FIRST run from the experiment's last checkpoint (crash-recovery drill: "
                    "kill a run mid-training, rerun with --resume, and the epoch/step counters continue "
                    "from the last completed save)")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.root, args.exp, args.epochs, args.resume_epochs, args.dual, args.device_augs, args.resume, device)


if __name__ == "__main__":
    main()
