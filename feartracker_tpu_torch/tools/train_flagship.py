"""Train the framework's own flagship checkpoint: the counterpart of
``tools/train_flagship.py``.

1. build a mixed-scenario synthetic corpus: drift at three appearance-morph
   strengths, pose, swap and occlusion at two resolutions, with distractors
   and presence==0 negative frames, plus one combined held-out val set (2
   sequences a scenario, symlinked, with a ``list.txt``);
2. classification-pretrain the trunk (``pretrain_trunk``), the re-expressed
   analog of the reference's ImageNet FBNet-C warm start (ref:
   model_training/model/blocks.py:22-25), or ``--warm_start`` from a
   trained checkpoint;
3. ``Trainer.fit``: bfloat16, plateau LR, the dynamic frame-offset
   curriculum, per-epoch resampling, top-k checkpoints on batched online
   validation (``ScanTracker``: K1 a step, K2 13 a step and an init) over the
   held-out mixed suite;
4. restore the best checkpoint and export it as ``.npz`` (float32, the JAX
   package's keys; ``--out``, default ``<work>/<model>_repo.npz``);
5. score it on the quality-gate protocol (sequential and batched letterboxed
   AO on the held-out drift suite, seed 3) beside the packaged ``fear_xs``.

Everything goes under ``--work`` (a temporary directory by default; name one
to resume or reuse the corpus). Pass ``--device_augs`` where cv2 is absent
(the card's host).

    python -m feartracker_tpu_torch.tools.train_flagship --work /data/flagship --device_augs
    python -m feartracker_tpu_torch.tools.train_flagship --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from feartracker_tpu_torch.convert.load import variables_of
from feartracker_tpu_torch.data.sequence import GOT10kDataset
from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
from feartracker_tpu_torch.evaluate.harness import DTYPES, device_line, load_model, tool_device
from feartracker_tpu_torch.tools import pretrain_trunk
from feartracker_tpu_torch.tools.export_weights import save_npz
from feartracker_tpu_torch.tools.make_class_dataset import generate_classes
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate
from feartracker_tpu_torch.tools.pretrain_chain import platform_of
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.tracker.tracker import FEARTracker
from feartracker_tpu_torch.train.loop import Trainer

# (name, generator kwargs): seeds disjoint from every committed fixture
SCENARIOS = [
    ("drift0", dict(scenario="drift", appearance_drift=0.0, size=(160, 224), obj_scale=1.0, seed=101)),
    ("drift5", dict(scenario="drift", appearance_drift=0.5, size=(288, 384), obj_scale=1.5, seed=102)),
    ("drift9", dict(scenario="drift", appearance_drift=0.9, size=(160, 224), obj_scale=1.0, seed=103)),
    ("pose", dict(scenario="pose", appearance_drift=0.0, size=(288, 384), obj_scale=1.5, seed=104)),
    ("swap", dict(scenario="swap", appearance_drift=0.3, size=(160, 224), obj_scale=1.0, seed=105)),
    ("occl", dict(scenario="occlusion", appearance_drift=0.3, size=(288, 384), obj_scale=1.5, seed=106)),
]


def build_corpus(root: str, tracks: int, frames: int, presence_dropout: float):
    """Generate per-scenario corpora + one combined held-out val root."""
    val_root = os.path.join(root, "val_all", "val")
    if os.path.exists(os.path.join(val_root, "list.txt")):
        return
    os.makedirs(val_root, exist_ok=True)
    names = []
    for name, kw in SCENARIOS:
        sroot = os.path.join(root, name)
        generate(sroot, tracks=tracks, frames=frames, val_sequences=2, presence_dropout=presence_dropout, **kw)
        src_val = os.path.join(sroot, "got10k", "val")
        for seq in sorted(os.listdir(src_val)):
            seq_dir = os.path.join(src_val, seq)
            if not os.path.isdir(seq_dir):
                continue
            combined = f"{name}_{seq}"
            dst = os.path.join(val_root, combined)
            if not os.path.exists(dst):
                os.symlink(seq_dir, dst)
            names.append(combined)
    with open(os.path.join(val_root, "list.txt"), "w") as fh:
        fh.write("\n".join(names))


def dataset_entry(root: str, name: str, num_samples: int, frame_offset: int):
    return {
        "name": name, "root": os.path.join(root, name),
        "image_cache": True,
        "sizes": {
            "search_image_size": 256, "template_image_size": 128,
            "search_context": 2, "template_bbox_offset": 0.2,
            "search_image_shift": 32, "search_image_scale": 0.2,
            "context_range": 1,
        },
        "regression_weight_label_size": 16,
        "sampling": {
            "type": "track",
            "data_path": os.path.join(root, name, "train.csv"),
            "negative_ratio": 0.1, "frame_offset": frame_offset,
            "num_samples": num_samples, "clip_range": True,
        },
    }


def build_config(root: str, exp: str, platform: str, args, pretrained: str):
    return {
        "platform": platform,
        "num_devices": 1,
        "sync_bn": False,
        "precision": "bfloat16",
        "seed": args.seed,
        "model": {
            "name": args.model, "adjust_channels": 256, "towernum": args.towernum,
            "pretrained_weights": pretrained,
        },
        "tracker": {
            "score_size": 16, "total_stride": 16, "instance_size": 256,
            "template_size": 128, "penalty_k": 0.062, "window_influence": 0.38,
            "lr": 0.765, "template_bbox_offset": 0.2, "search_context": 2,
        },
        # clip + skip-non-finite: a loss spike once poisoned Adam's moments;
        # global-norm clipping bounds the update and apply_if_finite skips
        # any residual bad step instead of absorbing it
        "optimizer": {"name": "adam", "lr": args.lr,
                      "gradient_clip_val": 1.0, "skip_non_finite": 100},
        "scheduler": {"mode": "max", "patience": 5, "factor": 0.5, "min_lr": 1e-5},
        "loss": {"coeffs": {"TARGET_CLASSIFICATION_KEY": 1, "TARGET_REGRESSION_LABEL_KEY": 1}},
        "batch_size": {"train": args.batch, "val": 1},
        "num_workers": 2,
        "max_epochs": args.epochs,
        "min_epochs": (min(40, args.epochs) if args.min_epochs is None
                       else args.min_epochs),
        "early_stopping": args.early_stopping,
        "metric_mode": "max",
        "max_val_samples": 24,
        "val_batched": True,
        "val_streams": 16,
        "val_frame_hw": (288, 384),
        "sanity_steps": 1,
        "log_every_n_steps": 50,
        "save_top_k": 5,
        "resume": args.resume,
        # reference curriculum shape (ref: fear_lightning_model.py:266-284)
        "dynamic_frame_offset": {"start_epoch": 8, "freq": 2, "step": 2, "max_value": 20},
        "experiment": {"folder": exp, "name": "FLAGSHIP"},
        "train": {"datasets": [
            dataset_entry(root, name, args.num_samples, frame_offset=6)
            for name, _ in SCENARIOS
        ]},
        "val": {"datasets": [{
            "name": "got10k", "root_dir": os.path.join(root, "val_all"), "subset": "val",
        }]},
    }


def export_npz(state, out_path: str) -> None:
    """The train state's model as a float32 ``.npz`` under the JAX
    package's keys."""
    save_npz({k: np.asarray(v, np.float32) for k, v in variables_of(state.model).items()}, out_path)


def quality_gate_eval(weights_path: str, label: str, model_name: str = "fear_xs", towernum: int = 2, root=None,
                      dtype=torch.bfloat16, device="cuda"):
    """The quality-gate protocol standalone: sequential and batched
    letterboxed AO on the held-out drift suite (seed 3), generated under
    ``root`` unless it holds ``got10k`` already."""
    root = root or tempfile.mkdtemp(prefix="flagship_gate_")
    if not os.path.isdir(os.path.join(root, "got10k")):
        generate(root, tracks=1, frames=12, val_sequences=3, seed=3, scenario="drift", appearance_drift=0.5)
    ds = GOT10kDataset(os.path.join(root, "got10k"), subset="val")
    model, provenance = load_model(weights_path, model_name, towernum)
    seq = evaluate_tracker(FEARTracker(model, dtype=dtype, device=device), ds)
    bat = batched_evaluate(ScanTracker(model, dtype=dtype, device=device), ds, streams=3, frame_hw=(120, 168))
    rec = {"gate": label, "weights": weights_path, "provenance": provenance,
           "sequential_ao": round(float(seq["ao"]), 4),
           "batched_letterboxed_ao": round(float(bat["ao"]), 4)}
    print(json.dumps(rec), flush=True)
    return rec


def run(work=None, root=None, exp=None, out=None, model="fear_xs", towernum=None, warm_start=None, epochs=110,
        min_epochs=None, early_stopping=18, lr=1e-3, batch=32, num_samples=512, tracks=48, frames=24,
        presence_dropout=0.1, seed=0, pretrain_npz=None, per_class=120, pretrain_epochs=3, resume=False,
        skip_train=False, device="cuda", device_augs=False, gate_dtype=torch.bfloat16, overrides=None) -> list:
    """The whole run; every record printed as a JSON line. ``overrides`` are
    merged into the trainer config's top level (a cut budget:
    ``train_percent``, ``num_workers``). → the records."""
    work = work or tempfile.mkdtemp(prefix="flagship_")
    root = root or os.path.join(work, "corpus")
    exp = exp or os.path.join(work, "exp")
    towernum = (3 if model == "fear_l" else 2) if towernum is None else towernum
    out = out or os.path.join(work, f"{model}_repo.npz")
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    t0 = time.time()
    build_corpus(root, tracks, frames, presence_dropout)
    emit({"corpus": root, "scenarios": [n for n, _ in SCENARIOS], "gen_s": round(time.time() - t0, 1)})

    # initialization: an explicit warm start, or classification pretraining
    # (reused across resumes)
    if warm_start:
        npz = warm_start
        if not os.path.exists(npz):
            raise SystemExit(f"--warm_start {npz} does not exist")
    else:
        npz = pretrain_npz or os.path.join(root, f"{model}_trunk.npz")
    if not os.path.exists(npz):
        cls_root = os.path.join(root, "cls")
        if not os.path.exists(cls_root):
            generate_classes(cls_root, per_class=per_class, seed=seed)
        rec = pretrain_trunk.run(cls_root, model, npz, epochs=pretrain_epochs, batch_size=batch, image_size=128,
                                 seed=seed, device=device)
        emit({"pretrain_final": rec["history"][-1], "arrays": rec["arrays"]})

    args = SimpleNamespace(seed=seed, model=model, towernum=towernum, lr=lr, batch=batch, epochs=epochs,
                           min_epochs=min_epochs, early_stopping=early_stopping, resume=resume,
                           num_samples=num_samples)
    config = build_config(root, exp, platform_of(device), args, npz)
    if device_augs:
        config["device_augs"] = True
    config.update(overrides or {})
    trainer = Trainer(config)
    trainer.setup_data()
    trainer.setup_state(seed)

    if not skip_train:
        curves = []
        orig_train_epoch, orig_validate = trainer.train_epoch, trainer.validate

        def train_epoch(epoch):
            te0 = time.time()
            m = orig_train_epoch(epoch)
            curves.append({"epoch": epoch, "epoch_s": round(time.time() - te0, 1),
                           **{k: round(float(v), 4) for k, v in m.items()}})
            return m

        def validate(epoch):
            v = orig_validate(epoch)
            if curves and epoch >= 0:
                curves[-1].update({f"val_{k}": round(float(x), 4) for k, x in v.items()})
                emit(curves[-1])
            return v

        trainer.train_epoch, trainer.validate = train_epoch, validate
        trainer.fit()
        emit({"train_done_steps": int(trainer.state.step), "wall_s": round(time.time() - t0, 1)})

    # the best checkpoint → the archive
    best = trainer.ckpt.best_step()
    if best is not None:
        state = trainer.ckpt.restore(trainer.state)
        emit({"restored_best_step": int(best)})
    else:
        state = trainer.state
        emit({"restored_best_step": None, "note": "using last state"})
    export_npz(state, out)
    emit({"exported": out, "mb": round(os.path.getsize(out) / 2**20, 1)})

    # side-by-side quality gate (the yardstick is always the recovered
    # FEAR-XS: for fear_m / fear_l the cross-family bar)
    gate_root = os.path.join(work, "quality_gate")
    repo = quality_gate_eval(out, "repo_trained", model, towernum, gate_root, gate_dtype, device)
    ref = quality_gate_eval("fear_xs", "recovered_reference", root=gate_root, dtype=gate_dtype, device=device)
    records += [repo, ref]
    emit({"summary": {
        "repo_sequential_ao": repo["sequential_ao"], "ref_sequential_ao": ref["sequential_ao"],
        "repo_batched_ao": repo["batched_letterboxed_ao"], "ref_batched_ao": ref["batched_letterboxed_ao"],
        "sequential_gap": round(ref["sequential_ao"] - repo["sequential_ao"], 4),
        "batched_gap": round(ref["batched_letterboxed_ao"] - repo["batched_letterboxed_ao"], 4),
        "target": "gap <= 0.05 on both paths", "wall_s": round(time.time() - t0, 1),
    }})
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--work", default=None, help="default: a temporary directory")
    ap.add_argument("--root", default=None, help="the corpus (default: <work>/corpus)")
    ap.add_argument("--exp", default=None, help="the experiment (default: <work>/exp)")
    ap.add_argument("--out", default=None, help="default: <work>/<model>_repo.npz")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    # model family training: same corpus, same recipe, the fear_m / fear_l
    # trunks; --warm_start transfers a trained XS checkpoint
    ap.add_argument("--model", default="fear_xs", choices=["fear_xs", "fear_m", "fear_l"])
    ap.add_argument("--towernum", type=int, default=None, help="default: 2 (xs/m), 3 (l)")
    ap.add_argument("--warm_start", default=None,
                    help="npz checkpoint to transfer from (replaces the classification pretrain stage)")
    ap.add_argument("--epochs", type=int, default=110)
    ap.add_argument("--min_epochs", type=int, default=None, help="default: min(40, epochs)")
    ap.add_argument("--early_stopping", type=int, default=18)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--num_samples", type=int, default=512, help="per scenario per epoch")
    ap.add_argument("--tracks", type=int, default=48, help="per scenario")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--presence_dropout", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pretrain_npz", default=None)
    ap.add_argument("--per_class", type=int, default=120)
    ap.add_argument("--pretrain_epochs", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--skip_train", action="store_true", help="only restore best + export + gate eval")
    ap.add_argument("--device_augs", action="store_true",
                    help="staged loader + augmentation in the train step (needed where cv2 is absent)")
    ap.add_argument("--gate_dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="the quality gate's trackers (the JAX tool's: bfloat16)")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        args.epochs, args.num_samples, args.tracks = 1, 16, 3
        args.frames, args.per_class, args.pretrain_epochs = 8, 8, 1
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.work, args.root, args.exp, args.out, args.model, args.towernum, args.warm_start, args.epochs,
        args.min_epochs, args.early_stopping, args.lr, args.batch, args.num_samples, args.tracks, args.frames,
        args.presence_dropout, args.seed, args.pretrain_npz, args.per_class, args.pretrain_epochs, args.resume,
        args.skip_train, device, args.device_augs, DTYPES[args.gate_dtype])


if __name__ == "__main__":
    main()
