"""Throughput against the stream count S, with its spread. The counterpart
of ``tools/sweep_streams.py``:

* wall time per ``track`` call, reported as the median and the
  interquartile range over the repeats (not one mean);
* the S values interleaved in two passes, so that drift in the host's speed
  hits every S alike;
* inputs already on the device, each repeat closed by a device sync.

    python -m feartracker_tpu_torch.tools.sweep_streams --streams 64,128,160,192,256 \\
        --warmup 5 --timed 10 --repeats 3 [--profile-dir DIR] [--memory]

``--trunk_impl`` is ``ScanTracker``'s: "fused" (the default, the folded
trunk with the fused block kernel) or "xla" (the model's unfolded trunk).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from feartracker_tpu_torch.evaluate.harness import (
    bench_device,
    build_scan_tracker,
    device_line,
    sync,
    synthetic_streams,
    timed_track_calls,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", default="64,128,160,192,256")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--timed", type=int, default=10, help="timed calls per repeat")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--profile-dir", default=None, help="a torch.profiler trace of one call at the last S")
    ap.add_argument("--memory", action="store_true", help="print the device's peak memory for each S")
    ap.add_argument("--trunk_impl", default="fused", choices=["xla", "fused"])
    args = ap.parse_args(argv)

    device = bench_device()
    s_values = [int(s) for s in args.streams.split(",")]
    tracker, provenance = build_scan_tracker(dtype=DTYPES[args.dtype], device=device, trunk_impl=args.trunk_impl)
    print(device_line(device), flush=True)
    print(f"[setup] weights: {provenance}, trunk: {args.trunk_impl}, dtype: {args.dtype}", flush=True)

    def run_one(S: int, warm: int) -> list:
        """Set up S streams on the device, warm up, return seconds per call
        for each repeat. Inputs live only for this call."""
        frames0, chunk, bboxes = synthetic_streams(S, args.chunk, device=device)
        if args.memory and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        state = tracker.init(frames0, bboxes)
        _, _, elapsed = timed_track_calls(tracker, state, chunk, warm, args.timed, args.repeats)
        if args.memory and device.type == "cuda":
            print(json.dumps({"S": S, "peak_mib": round(torch.cuda.max_memory_allocated(device) / 2**20, 1)}))
        return [e / args.timed for e in elapsed]

    times: dict = {S: [] for S in s_values}
    for p in range(2):
        for S in s_values:
            reps = run_one(S, args.warmup if p == 0 else max(args.warmup // 2, 1))
            times[S].extend(reps)
            for dt in reps:
                print(f"[pass {p}] S={S}: {dt * 1e3:.2f} ms/call -> {S * args.chunk / dt:,.1f} frames/s", flush=True)

    print("\n== summary (median over repeats) ==")
    for S in s_values:
        med = float(np.median(times[S]))
        lo, hi = np.percentile(times[S], [25, 75])
        print(json.dumps({
            "S": S, "ms_per_call_median": round(med * 1e3, 3),
            "iqr_ms": [round(lo * 1e3, 3), round(hi * 1e3, 3)],
            "fps": round(S * args.chunk / med, 1), "us_per_frame": round(med / (S * args.chunk) * 1e6, 3),
        }), flush=True)

    if args.profile_dir:
        from feartracker_tpu_torch.evaluate.profiling import trace

        frames0, chunk, bboxes = synthetic_streams(s_values[-1], args.chunk, device=device)
        state, _ = tracker.track(tracker.init(frames0, bboxes), chunk)  # warm
        sync(device)
        with trace(args.profile_dir):
            tracker.track(state, chunk)
            sync(device)
        print(f"trace written to {os.path.join(args.profile_dir, 'trace.json')}")


if __name__ == "__main__":
    main()
