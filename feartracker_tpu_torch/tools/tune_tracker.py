"""Decode-constant tuning: a grid search over penalty_k / window_influence /
lr in smooth mode on any registry dataset, AO per point. The counterpart of
``tools/tune_tracker.py``.

    python -m feartracker_tpu_torch.tools.tune_tracker --dataset got10k --root /data/got10k \\
        --subset val --batched --penalty_k 0.02,0.062,0.1 --window 0.2,0.38,0.5 --lr 0.5,0.765,1.0

Sequential mode tracks one sequence at a time with ``FEARTracker``;
``--batched`` letterboxes the sequences through ``ScanTracker``
(``batched_evaluate``), a tracker per grid point. As in the JAX tool the
batched search runs bfloat16 and the sequential one float32 unless
``--dtype`` says otherwise. A root of the numpy scenario generator
(``tools/make_synthetic_dataset.py``, ``<root>/got10k``) is a GOT-10k root.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from feartracker_tpu_torch.convert.load import default_weights_path, load_fear_net, load_variables
from feartracker_tpu_torch.data.sequence import DATASET_REGISTRY
from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
from feartracker_tpu_torch.evaluate.harness import DTYPES, device_line, tool_device
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.tracker.tracker import FEARTracker


def _floats(s: str):
    return [float(v) for v in s.split(",")]


def run(root: str, dataset: str = "got10k", subset: str = "val", weights_path: Optional[str] = None,
        penalty_k=(0.02, 0.062, 0.15), window=(0.2, 0.38, 0.5), lr=(0.765,), batched: bool = False,
        streams: int = 16, max_frames: Optional[int] = None, max_sequences: Optional[int] = None, dtype=None,
        device="cuda"):
    """A JSON line per grid point, then the best point's; → the points and
    the best. ``dtype`` None: bfloat16 batched, float32 sequential."""
    kwargs = {"subset": subset} if dataset in ("got10k", "trackingnet") else {}
    data = DATASET_REGISTRY[dataset](root, **kwargs)
    model = load_fear_net(FEARNet(), load_variables(weights_path or default_weights_path()))
    dtype = dtype or (torch.bfloat16 if batched else torch.float32)
    points, best = [], None
    for pk in penalty_k:
        for wi in window:
            for r in lr:
                cfg = TrackerConfig(smooth=True, penalty_k=pk, window_influence=wi, lr=r)
                if batched:
                    tracker = ScanTracker(model, cfg, dtype=dtype, device=device)
                    res = batched_evaluate(tracker, data, streams=streams, max_frames=max_frames,
                                           max_sequences=max_sequences)
                else:
                    tracker = FEARTracker(model, cfg, dtype=dtype, device=device)
                    res = evaluate_tracker(tracker, data, max_frames=max_frames)
                point = {"penalty_k": pk, "window_influence": wi, "lr": r, "ao": res["ao"], "sr50": res["sr50"],
                         "num_sequences": res["num_sequences"]}
                print(json.dumps(point), flush=True)
                points.append(point)
                if best is None or point["ao"] > best["ao"]:
                    best = point
    print(json.dumps({"best": best}))
    return points + [{"best": best}]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights_path", default=None)
    ap.add_argument("--dataset", default="got10k")
    ap.add_argument("--root", required=True)
    ap.add_argument("--subset", default="val")
    ap.add_argument("--penalty_k", default="0.02,0.062,0.15")
    ap.add_argument("--window", default="0.2,0.38,0.5")
    ap.add_argument("--lr", default="0.765")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--max_sequences", type=int, default=None)
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="default: bfloat16 with --batched, float32 sequential (the JAX tool's)")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.root, args.dataset, args.subset, args.weights_path, _floats(args.penalty_k), _floats(args.window),
        _floats(args.lr), args.batched, args.streams, args.max_frames, args.max_sequences,
        DTYPES[args.dtype] if args.dtype else None, device)


if __name__ == "__main__":
    main()
