"""Throughput at each ``scan_unroll`` K on the bench's protocol shape:
``ScanTracker.track`` with K steps per CUDA graph against the eager loop
(K=1). The counterpart of ``tools/unroll_probe.py`` (there, K unrolls the
compiled ``lax.scan``).

    python -m feartracker_tpu_torch.tools.unroll_probe                 # K = 1, 2, 4
    python -m feartracker_tpu_torch.tools.unroll_probe --unrolls 1,4,16

Other knobs through ``PROBE_*`` environment variables: ``WARMUP`` (5),
``TIMED`` (30), ``STREAMS`` (128), ``CHUNK`` (64), ``REPEATS`` (2; the best
pass counts). FEAR-XS in bfloat16 from ``fear_xs.npz``, frames from
``synthetic_streams`` on the device. Prints the device line, one JSON line
per K, then each K against K=1. The warm-up includes the graphs' capture.
"""

from __future__ import annotations

import argparse
import gc
import json
import os

import torch

from feartracker_tpu_torch.evaluate.harness import (
    bench_device,
    build_scan_tracker,
    device_line,
    synthetic_streams,
    timed_track_calls,
)


def measure(unroll: int, device: torch.device) -> float:
    warmup = int(os.environ.get("PROBE_WARMUP", 5))
    timed = int(os.environ.get("PROBE_TIMED", 30))
    streams = int(os.environ.get("PROBE_STREAMS", 128))
    chunk_len = int(os.environ.get("PROBE_CHUNK", 64))
    repeats = int(os.environ.get("PROBE_REPEATS", 2))
    tracker, prov = build_scan_tracker(dtype=torch.bfloat16, device=device, scan_unroll=unroll)
    frames0, chunk, bboxes = synthetic_streams(streams, chunk_len, device=device)
    state = tracker.init(frames0, bboxes)
    _, _, elapsed = timed_track_calls(tracker, state, chunk, warmup, timed, repeats)
    fps = timed * streams * chunk_len / min(elapsed)
    print(json.dumps({"unroll": unroll, "fps": round(fps, 1), "weights": prov, "streams": streams,
                      "chunk": chunk_len, "ms_per_call": round(min(elapsed) / timed * 1e3, 3),
                      "passes_s": [round(e, 3) for e in elapsed]}), flush=True)
    del tracker, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the next K captures its own graphs
    return fps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--unrolls", default="1,2,4",
                    help="comma list (other knobs via PROBE_* env vars: WARMUP/TIMED/STREAMS/CHUNK/REPEATS)")
    args = ap.parse_args(argv)
    device = bench_device()
    print(device_line(device), flush=True)
    results = {u: measure(u, device) for u in (int(x) for x in args.unrolls.split(","))}
    base = results.get(1)
    for u, fps in results.items():
        vs = f" ({fps / base - 1:+.1%} vs unroll=1)" if base else ""
        print(f"unroll={u}: {fps:,.1f} frames/s{vs}")


if __name__ == "__main__":
    main()
