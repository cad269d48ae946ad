"""The port's headline benchmark: FEAR-XS tracked frames per second on one
card, over S batched streams. The counterpart of the repository's
``bench.py``:

    python -m feartracker_tpu_torch.bench

Protocol (each knob an environment override): ``BENCH_WARMUP`` (20) warmup
calls, then ``BENCH_REPEATS`` (2) passes of ``BENCH_TIMED`` (100) timed
``ScanTracker.track`` calls, the best pass counting; each call tracks a
chunk of ``BENCH_CHUNK`` (64) frames of ``BENCH_STREAMS`` (128) streams
with FEAR-XS in bfloat16 from the packaged ``fear_xs.npz``. The frames come
from :func:`synthetic_streams` already on the device: one random 256×480
video expanded over the streams. Each pass ends with a device sync.

The tracker comes from :func:`build_scan_tracker`, which raises when the
weights do not load: there is no random-weights run, and such a failure
exits non-zero without a result.

The run is on the card unless ``BENCH_DEVICE=cpu`` (the tests): a CPU run
times the host and says so in its unit. Prints the card's ``nvidia-smi``
name and power limit, then one JSON line::

  {"metric": ..., "value": N, "unit": "frames/sec/card", "weights": ...,
   "vs_baseline": N}

``vs_baseline`` is ``value`` over the north star of 1000 tracked frames/s
(``BASELINE.json``), credited only when ``weights`` is "fear_xs".
"""

from __future__ import annotations

import json
import os

import torch

BASELINE_FPS = 1000.0


def main() -> None:
    from feartracker_tpu_torch.evaluate.harness import (
        bench_device,
        build_scan_tracker,
        device_line,
        synthetic_streams,
        timed_track_calls,
    )

    warmup = int(os.environ.get("BENCH_WARMUP", 20))
    timed = int(os.environ.get("BENCH_TIMED", 100))
    streams = int(os.environ.get("BENCH_STREAMS", 128))
    chunk_len = int(os.environ.get("BENCH_CHUNK", 64))
    repeats = int(os.environ.get("BENCH_REPEATS", 2))
    device = bench_device()

    tracker, weights = build_scan_tracker(dtype=torch.bfloat16, device=device)
    frames0, chunk, bboxes = synthetic_streams(streams, chunk_len, device=device)
    state = tracker.init(frames0, bboxes)
    state, out, elapsed = timed_track_calls(tracker, state, chunk, warmup, timed, repeats)
    if not (torch.isfinite(out["bbox"]).all() and torch.isfinite(state.bbox).all()):
        raise RuntimeError("non-finite tracking output")

    fps = timed * streams * chunk_len / min(elapsed)
    where = "card" if device.type == "cuda" else "cpu"
    print(device_line(device), flush=True)
    print(json.dumps({
        "metric": f"FEAR-XS tracked FPS/{where} ({streams} streams, T={chunk_len} chunks, bf16)",
        "value": round(fps, 1),
        "unit": f"frames/sec/{where}",
        "weights": weights,
        "vs_baseline": round(fps / BASELINE_FPS, 4) if weights == "fear_xs" else 0.0,
    }), flush=True)


if __name__ == "__main__":
    main()
