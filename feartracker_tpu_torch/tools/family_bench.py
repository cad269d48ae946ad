"""Family throughput: FEAR-XS, FEAR-M and FEAR-L on ``ScanTracker.track``,
in the bench's protocol shape (warmup, then timed chunk calls on frames
already on the device, the best of the repeats). The counterpart of
``tools/family_bench.py``.

Throughput does not depend on the weights, and no trained FEAR-M or FEAR-L
weights exist: those two run a seeded random init (torch's generator,
seed 0), labelled ``"random"``; FEAR-XS runs ``fear_xs.npz`` as the anchor
of the same run.

    python -m feartracker_tpu_torch.tools.family_bench --models fear_xs,fear_m,fear_l \\
        --streams 128 --chunk 64 --warmup 3 --timed 10 --repeats 2
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from feartracker_tpu_torch.evaluate.harness import (
    DTYPES,
    bench_device,
    build_scan_tracker,
    device_line,
    sync,
    synthetic_streams,
    timed_track_calls,
)
from feartracker_tpu_torch.models.fear_net import build_family_model
from feartracker_tpu_torch.tracker.runtime import ScanTracker

TOWERNUM = {"fear_xs": 2, "fear_m": 2, "fear_l": 3}


def seeded_model(name: str, seed: int = 0):
    """A family model with PyTorch's default init drawn from torch's
    generator seeded with ``seed`` (the caller's generator state is kept)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_family_model(name, towernum=TOWERNUM.get(name, 2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", default="fear_xs,fear_m,fear_l")
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--timed", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    device, dtype = bench_device(), DTYPES[args.dtype]
    print(device_line(device), flush=True)
    for name in (n.strip() for n in args.models.split(",")):
        t0 = time.perf_counter()
        if name == "fear_xs":
            tracker, provenance = build_scan_tracker(dtype=dtype, device=device)
        else:
            tracker, provenance = ScanTracker(seeded_model(name), dtype=dtype, device=device), "random"
        frames0, chunk, bboxes = synthetic_streams(args.streams, args.chunk, device=device)
        state = tracker.init(frames0, bboxes)
        sync(device)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, out, elapsed = timed_track_calls(tracker, state, chunk, args.warmup, args.timed, args.repeats)
        warmup_s = time.perf_counter() - t0 - sum(elapsed)
        best = min(elapsed) / args.timed
        print(json.dumps({
            "model": name,
            "weights": provenance,
            "streams": args.streams,
            "chunk": args.chunk,
            "ms_per_call_best": round(best * 1e3, 3),
            "fps_per_card" if device.type == "cuda" else "fps_on_cpu": round(args.streams * args.chunk / best, 1),
            "setup_s": round(setup_s, 2),
            "warmup_s": round(warmup_s, 2),
            "finite": bool(torch.isfinite(out["bbox"]).all()),
        }), flush=True)
        del tracker, state, out, frames0, chunk, bboxes
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
