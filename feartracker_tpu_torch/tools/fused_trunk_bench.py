"""The fused trunk (K2) against the model's own unfolded trunk on cuDNN, at
tracker level. The counterpart of ``tools/fused_trunk_bench.py``.

Stage 1 (numerics): ``ScanTracker(trunk_impl="xla")`` and ``"fused"`` on
``--check_streams`` numpy-rendered clips (``tools/make_npy_dataset.py:
render_clip``, seeds 20, 21, ...: at S=4 the clips of ``chip_smoke.py``
phase 9g), each started on its object's true box: the boxes of the first
chunk, ``max_abs_px`` and ``mean_abs_px`` apart. (The JAX tool checks on the
synthetic noise streams, where no object is tracked: there any rounding
sends the boxes far apart in bfloat16, ≈70-150 px after 16 frames on the
CPU, so the numbers say nothing about the trunks.)
Stage 2 (timing, ``--timed`` > 0): both trunks at ``--streams`` on the
synthetic streams in the bench's protocol
(warmup, then ``--repeats`` passes of ``--timed`` ``track`` calls on frames
already on the device, each pass closed by a sync, the best counting), with
each trunk's K2 launches per call (``xla`` 0, ``fused`` 13 a frame for
FEAR-XS). ``compile_s`` is the first ``init`` + ``track`` call's seconds
(cuDNN's plans, the caching allocator's first blocks, the kernels' build).

    python -m feartracker_tpu_torch.tools.fused_trunk_bench --streams 128 --chunk 32 --timed 30
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from feartracker_tpu_torch.evaluate.harness import (
    bench_device,
    build_scan_tracker,
    device_line,
    rate_key,
    sync,
    synthetic_streams,
    timed_track_calls,
)
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block
from feartracker_tpu_torch.tools.make_npy_dataset import render_clip

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


CHECK_SEED = 20  # clip s of the check is rendered from CHECK_SEED + s


def rendered_streams(S: int, T: int, device):
    """(frames0 (S, H, W, 3), chunk (T, S, H, W, 3), true boxes at frame 0
    (S, 4)) of S rendered clips on ``device``."""
    clips = [render_clip(CHECK_SEED + s, T + 1) for s in range(S)]
    frames = torch.from_numpy(np.stack([np.stack(f) for f, _ in clips], axis=1)).to(device)
    boxes = torch.tensor(np.stack([b[0] for _, b in clips]), dtype=torch.float32, device=device)
    return frames[0], frames[1:], boxes


def check(S: int, T: int, dtype, device) -> dict:
    """Both trunks' first-chunk boxes on S rendered clips, how far apart."""
    frames0, chunk, boxes = rendered_streams(S, T, device)
    got = {}
    for impl in ("xla", "fused"):
        tracker, _ = build_scan_tracker(dtype=dtype, device=device, trunk_impl=impl)
        got[impl] = tracker.track(tracker.init(frames0, boxes), chunk)[1]["bbox"].cpu()
    dev = (got["xla"] - got["fused"]).abs()
    return {"max_abs_px": dev.max().item(), "mean_abs_px": dev.mean().item()}


def run(impl: str, S: int, T: int, warmup: int, timed: int, repeats: int, dtype, device) -> dict:
    """One trunk at S synthetic streams: the first call's seconds, then the
    bench protocol's best pass and K2's launches a call."""
    tracker, provenance = build_scan_tracker(dtype=dtype, device=device, trunk_impl=impl)
    frames0, chunk, bboxes = synthetic_streams(S, T, device=device)
    t0 = time.perf_counter()
    state, _ = tracker.track(tracker.init(frames0, bboxes), chunk)
    sync(device)
    compile_s = time.perf_counter() - t0
    before = fused_ir_block.launches
    _, _, elapsed = timed_track_calls(tracker, state, chunk, warmup, timed, repeats)
    calls = max(warmup, 1) + repeats * timed
    best = min(elapsed)
    return {"impl": impl, "weights": provenance, "streams": S, "chunk": T, "compile_s": compile_s,
            "ms_per_call": best / timed * 1e3, rate_key("tracked_fps", device): timed * S * T / best,
            "k2_launches_per_call": (fused_ir_block.launches - before) / calls}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--timed", type=int, default=30, help="timed calls a pass (0 = the check only)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--check_streams", type=int, default=8,
                    help="small-S numeric cross-check before timing (0 = skip)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, help="default: BENCH_DEVICE, else the card")
    args = ap.parse_args(argv)

    device = torch.device(args.device) if args.device else bench_device()
    dtype = DTYPES[args.dtype]
    print(device_line(device), flush=True)
    if args.check_streams:
        print(json.dumps({"check": "fused vs xla boxes, first chunk", "streams": args.check_streams,
                          "chunk": args.chunk, "dtype": args.dtype,
                          **check(args.check_streams, args.chunk, dtype, device)}), flush=True)
    for impl in ("xla", "fused") if args.timed else ():
        r = run(impl, args.streams, args.chunk, args.warmup, args.timed, args.repeats, dtype, device)
        print(json.dumps({**r, "dtype": args.dtype}), flush=True)


if __name__ == "__main__":
    main()
