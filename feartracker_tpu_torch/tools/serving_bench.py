"""``StreamPool`` serving benchmark: per-frame against chunked stepping,
serial against pipelined. The counterpart of ``tools/serving_bench.py``.

Times the four ways a server advances its slots: ``step`` and
``step_async`` (one frame, one dispatch each) against ``step_chunk`` and
``step_chunk_async`` (T frames in one ``track`` call), each serial and, for
the asynchronous two, with ``--depth`` calls in flight. FEAR-XS in bfloat16
from ``fear_xs.npz``, one random frame on the device shared by every slot.
Prints the device line, then one JSON line per mode.

    python -m feartracker_tpu_torch.tools.serving_bench --streams 128 --chunk 8 --depth 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from feartracker_tpu_torch.evaluate.harness import (
    DEMO_BBOX,
    bench_device,
    build_scan_tracker,
    device_line,
)
from feartracker_tpu_torch.tracker.serving import StreamPool


def _timed(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def _pipelined(dispatch, depth: int, n: int) -> float:
    pending = []
    t0 = time.perf_counter()
    for _ in range(n):
        if len(pending) >= depth:
            pending.pop(0).result()
        pending.append(dispatch())
    for p in pending:
        p.result()
    return (time.perf_counter() - t0) / n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--timed", type=int, default=25)
    args = ap.parse_args(argv)

    device = bench_device()
    tracker, provenance = build_scan_tracker(dtype=torch.bfloat16, device=device)
    print(device_line(device), flush=True)
    print(f"[setup] weights: {provenance}", file=sys.stderr)
    S, T, hw = args.streams, args.chunk, (256, 480)
    frame = np.random.RandomState(0).randint(0, 255, (*hw, 3), dtype=np.uint8)
    pool = StreamPool(tracker, capacity=S, frame_hw=hw)
    for _ in range(S):
        pool.add(frame, np.asarray(DEMO_BBOX))
    on_device = torch.from_numpy(frame).to(device)
    frames = on_device.expand(S, *on_device.shape)  # every slot sees the frame, stored once
    chunk = on_device.expand(T, S, *on_device.shape)

    for _ in range(args.warmup):
        pool.step(frames)
        pool.step_chunk(chunk)

    results = {
        "frame_serial": (_timed(lambda: pool.step(frames), args.timed), S),
        "frame_pipelined": (_pipelined(lambda: pool.step_async(frames), args.depth, 2 * args.timed), S),
        "chunk_serial": (_timed(lambda: pool.step_chunk(chunk), args.timed), S * T),
        "chunk_pipelined": (_pipelined(lambda: pool.step_chunk_async(chunk), args.depth, 2 * args.timed), S * T),
    }
    for mode, (dt, frames_per_call) in results.items():
        print(json.dumps({
            "mode": mode, "streams": S, "chunk": T if mode.startswith("chunk") else 1,
            "depth": args.depth if "pipelined" in mode else 1,
            "ms_per_call": round(dt * 1e3, 3),
            "live_fps": round(frames_per_call / dt, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
