"""Multi-object tracking throughput: a shared frame feed against a feed
tiled on the host. The counterpart of ``tools/multiobject_bench.py``.

N objects tracked through ONE video. The tiled feed repeats the frame chunk
N times on the host, (T, N, H, W, 3), and pays N times the copy to the
device; the shared feed hands ``track`` the (T, H, W, 3) chunk once and the
tracker broadcasts it over the streams. With host frames the copy is what
the shared mode saves; ``--device_resident`` stages both feeds on the device
first, which isolates the cost of the broadcast itself.

    python -m feartracker_tpu_torch.tools.multiobject_bench --objects 4,16 --chunk 16 --chunks 4

Prints the device line, then one JSON line per (mode, N).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from feartracker_tpu_torch.evaluate.harness import bench_device, build_scan_tracker, device_line, sync


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--objects", default="4,16")
    ap.add_argument("--chunk", type=int, default=16, help="frames per track() call")
    ap.add_argument("--chunks", type=int, default=4, help="timed chunks per config")
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--device_resident", action="store_true",
                    help="stage the feed on the device first (isolates the in-tracker broadcast from the copy)")
    ap.add_argument("--platform", default="", help="the device to run on (default: BENCH_DEVICE, else cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.platform) if args.platform else bench_device()
    H, W, T = args.height, args.width, args.chunk
    video = np.random.RandomState(0).randint(0, 255, (T, H, W, 3)).astype(np.uint8)
    tracker, _ = build_scan_tracker(dtype=torch.bfloat16, device=device)
    print(device_line(device), flush=True)

    for n in [int(x) for x in args.objects.split(",")]:
        boxes = np.stack(
            [[20 + 7 * i % (W - 120), 20 + 11 * i % (H - 120), 60, 80] for i in range(n)]
        ).astype(np.float32)
        for mode in ("tiled", "shared"):
            if mode == "tiled":
                feed0 = np.broadcast_to(video[0], (n, H, W, 3)).copy()
                feed = np.broadcast_to(video[:, None], (T, n, H, W, 3)).copy()
            else:
                feed0, feed = video[0], video
            feed_bytes = feed.nbytes
            if args.device_resident:
                feed0, feed = torch.from_numpy(feed0).to(device), torch.from_numpy(feed).to(device)
                sync(device)
            state = tracker.init(feed0, boxes)
            state, out = tracker.track(state, feed)  # warm
            out["bbox"].cpu()
            t0 = time.perf_counter()
            for _ in range(args.chunks):
                state, out = tracker.track(state, feed)
                out["bbox"].cpu()  # the host reads the boxes: a real sync
            dt = time.perf_counter() - t0
            print(json.dumps({
                "mode": mode, "objects": n, "chunk": T, "hw": [H, W],
                "h2d_mb_per_chunk": round(feed_bytes / 1e6, 1),
                "tracked_fps": round(args.chunks * T * n / dt, 1),
                "s_per_chunk": round(dt / args.chunks, 4),
            }), flush=True)


if __name__ == "__main__":
    main()
