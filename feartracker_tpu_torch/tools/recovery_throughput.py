"""Throughput cost of zoom-out re-acquisition (``recover_context``) in the
multi-stream runtime. The counterpart of ``tools/recovery_throughput.py``.

The recovery branch is a per-stream ``torch.where`` on the crop context
(``tracker/runtime.py``): the same shapes and no extra model evaluation, so
its expected cost is about zero. This measures it: the bench's protocol
(warmup, then ``BENCH_REPEATS`` passes of ``BENCH_TIMED`` ``track`` calls on
frames already on the device, each pass closed by a sync, the best
counting) run back to back in one process for each ``--contexts`` value,
on the same streams and weights (FEAR-XS bf16 from ``fear_xs.npz``).

    python -m feartracker_tpu_torch.tools.recovery_throughput            # the card
    BENCH_DEVICE=cpu BENCH_STREAMS=2 BENCH_CHUNK=2 BENCH_WARMUP=1 BENCH_TIMED=1 \\
        python -m feartracker_tpu_torch.tools.recovery_throughput        # a CPU smoke run

Prints the card line, one JSON line a context and the ``recovery_overhead``
summary of the first two.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from feartracker_tpu_torch.evaluate.harness import (
    bench_device,
    build_scan_tracker,
    device_line,
    rate_key,
    synthetic_streams,
    timed_track_calls,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--contexts", default="0,3")
    args = ap.parse_args(argv)
    env = {k: int(os.environ.get(f"BENCH_{k}", d))
           for k, d in (("WARMUP", 10), ("TIMED", 40), ("STREAMS", 128), ("CHUNK", 64), ("REPEATS", 2))}
    S, T = env["STREAMS"], env["CHUNK"]

    device = torch.device(args.device) if args.device else bench_device()
    print(device_line(device), flush=True)
    frames0, chunk, bboxes = synthetic_streams(S, T, device=device)
    results, provenance = {}, None
    fps_key = rate_key("fps", device)
    for ctx in [float(c) for c in args.contexts.split(",")]:
        kw = {} if ctx == 0.0 else {"recover_context": ctx}
        tracker, provenance = build_scan_tracker(dtype=torch.bfloat16, device=device, **kw)
        state = tracker.init(frames0, bboxes)
        _, _, elapsed = timed_track_calls(tracker, state, chunk, env["WARMUP"], env["TIMED"], env["REPEATS"])
        fps = env["TIMED"] * S * T / min(elapsed)
        results[ctx] = fps
        print(json.dumps({"recover_context": ctx, fps_key: fps, "streams": S, "chunk": T,
                          "weights": provenance}), flush=True)
        del tracker, state

    if len(results) >= 2:
        base, rec = list(results.values())[:2]
        print(json.dumps({"summary": "recovery_overhead", rate_key("baseline_fps", device): base,
                          rate_key("recovery_fps", device): rec, "overhead_pct": 100.0 * (1 - rec / base),
                          "weights": provenance}), flush=True)


if __name__ == "__main__":
    main()
