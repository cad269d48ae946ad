"""Family training: do the FEAR-M and FEAR-L scale-ups train, and does a
FEAR-XS → M warm start pay? The counterpart of ``tools/family_train.py``.

The reference ships one trainable architecture, FEAR-XS (its paper names
FEAR-M and FEAR-L but the repo releases neither, ref: README.md:28). This
tool trains arms that differ only in architecture, and for the warm-start
arms in initialisation (the non-strict transfer from the packaged
``fear_xs.npz``, ``convert/load.py:transfer_variables``), on one synthetic
tracking set at identical budget, seed and hyperparameters
(``pretrain_chain.tracker_config``), at the published widths. Validation
tracks through K1 and K2 at each family's block shapes.

Arms (``<arch>_<init>``): xs_scratch, m_scratch, m_warmstart, l_scratch,
l_warmstart. Per-epoch train loss and validation box IoU are printed as JSON
lines, then a summary. Everything is written under ``--work``; pass
``--device_augs`` where cv2 is absent (the card's host).

    python -m feartracker_tpu_torch.tools.family_train --epochs 6 --device_augs
    python -m feartracker_tpu_torch.tools.family_train --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS
from feartracker_tpu_torch.evaluate.harness import device_line, tool_device
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate
from feartracker_tpu_torch.tools.pretrain_chain import epoch_rows, platform_of, summary, tracker_config

ARCHS = {
    # name -> (model.name, towernum)
    "xs": ("fear_xs", 2),
    "m": ("fear_m", 2),
    "l": ("fear_l", 3),
}


def arm_config(label, root, work, platform, epochs, lr, batch, num_samples, seed) -> dict:
    """``tracker_config`` for arm ``label`` (``<arch>_<init>``)."""
    arch, init = label.split("_", 1)
    if arch not in ARCHS:
        raise SystemExit(f"unknown arch in arm {label!r}")
    pretrained = PACKAGED_FEAR_XS if init == "warmstart" else None
    cfg = tracker_config(root, os.path.join(work, f"exp_{label}"), platform, epochs, pretrained, lr, batch,
                         num_samples, seed)
    cfg["model"]["name"], cfg["model"]["towernum"] = ARCHS[arch]
    return cfg


def run(epochs=6, lr=1e-3, batch=32, num_samples=256, seed=0, tracks=24, track_frames=16,
        arms=("xs_scratch", "m_scratch", "m_warmstart"), work=None, device="cuda", device_augs=False) -> list:
    """Each arm's epoch rows, then the summary, each printed as a JSON line."""
    work = work or tempfile.mkdtemp(prefix="family_")
    # the shared tracking dataset (the pretrain chain's generator settings)
    root = os.path.join(work, "track")
    generate(root, tracks=tracks, frames=track_frames, val_sequences=4, seed=11, size=(288, 384), obj_scale=1.5)
    results, records = {}, []
    for label in arms:
        cfg = arm_config(label, root, work, platform_of(device), epochs, lr, batch, num_samples, seed)
        results[label] = epoch_rows(cfg, epochs, {"arm": label}, device_augs)
        records += results[label]
    records.append({"summary": summary(results)})
    print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--num_samples", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tracks", type=int, default=24)
    ap.add_argument("--track_frames", type=int, default=16)
    ap.add_argument("--arms", default="xs_scratch,m_scratch,m_warmstart",
                    help="comma list from: xs_scratch, m_scratch, m_warmstart, l_scratch, l_warmstart")
    ap.add_argument("--work", default=None, help="where the dataset and the runs go (default: temporary)")
    ap.add_argument("--device_augs", action="store_true",
                    help="staged loader + augmentation in the train step (needed where cv2 is absent)")
    ap.add_argument("--smoke", action="store_true", help="tiny budget for a quick run")
    args = ap.parse_args(argv)
    if args.smoke:
        args.epochs, args.batch, args.num_samples = 1, 4, 8
        args.tracks, args.track_frames = 4, 6
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.epochs, args.lr, args.batch, args.num_samples, args.seed, args.tracks, args.track_frames,
        args.arms.split(","), args.work, device, args.device_augs)


if __name__ == "__main__":
    main()
