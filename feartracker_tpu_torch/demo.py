"""Track object(s) through a video, the counterpart of ``demo_video.py``:

    python -m feartracker_tpu_torch.demo --initial_bbox 163 53 45 174 \\
        --video_path clip.npy --output_path outputs/clip.npz
    # two objects, one ScanTracker stream each, the frames shared:
    python -m feartracker_tpu_torch.demo --initial_bbox 163 53 45 174 40 60 50 80 ...

``--device`` (default ``cuda``, with no fallback; ``cpu`` runs the kernels'
plain twins) is where the tracker runs. Weights come through
``convert.load.load_variables``: an ``.npz`` or zoo name, a reference
Lightning ``.ckpt``, or the reference's CoreML ``.mlmodel``; the default is
``$FEAR_WEIGHTS``, else the packaged ``fear_xs.npz``.

``--video_path`` is a ``.npy`` of (T, H, W, 3) RGB uint8 frames, read with
numpy, or a video file such as an mp4, decoded with cv2. ``--output_path``
by suffix: ``.npz`` holds the drawn frames (``frames``, (T, H, W, 3) uint8)
and the boxes (``boxes``, (T, N, 4) xywh), written with numpy; any other
suffix is encoded as an mp4v video with cv2, and raises up front where cv2
is not installed. The H100 host has cv2 4.13.0 with FFMPEG, so mp4 in and
out run there (``chip_smoke.py`` phase 20d). The last line printed is the
final box, as ``demo_video.py`` prints it.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from feartracker_tpu_torch.convert.load import default_weights_path, load_fear_net, load_variables
from feartracker_tpu_torch.models.fear_net import build_family_model
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.utils.video import draw_bbox, read_video, require_cv2, video_fps, write_video

COLORS = [(0, 255, 0), (255, 80, 0), (0, 120, 255), (255, 0, 200), (255, 220, 0), (0, 255, 220)]


def _model(weights_path: str, model_name: str, trust_pickle: bool = False):
    return load_fear_net(build_family_model(model_name), load_variables(weights_path, trust_pickle=trust_pickle))


def get_tracker(weights_path: str, smooth: bool = False, device="cuda", recover_context: float = 0.0,
                model_name: str = "fear_xs", trust_pickle: bool = False):
    """The sequential ``FEARTracker`` (float32) on ``device``."""
    from feartracker_tpu_torch.tracker.tracker import FEARTracker

    return FEARTracker(_model(weights_path, model_name, trust_pickle), TrackerConfig(smooth=smooth), device=device,
                       recover_context=recover_context)


def track(tracker, frames, initial_bbox: np.ndarray) -> List[np.ndarray]:
    """``initialize`` on the first frame, ``update`` on each other → a box a
    frame, the initial one first."""
    tracked = [np.asarray(initial_bbox)]
    tracker.initialize(frames[0], initial_bbox)
    for frame in frames[1:]:
        tracked.append(np.asarray(tracker.update(frame)["bbox"]))
    return tracked


def track_scan(weights_path, frames, initial_bboxes, smooth=False, dynamic_template=False, update_interval=1,
               chunk=32, recover_context=0.0, model_name="fear_xs", device="cuda", trust_pickle=False):
    """One video, N objects, through ``ScanTracker`` (float32): one stream
    per object, each frame shared by all of them. ``initial_bboxes`` (N, 4),
    or (4,) for one object. Returns a box array a frame: (N, 4), or (4,)
    for one object."""
    from feartracker_tpu_torch.tracker.runtime import ScanTracker

    single = np.asarray(initial_bboxes).ndim == 1
    boxes = np.atleast_2d(np.asarray(initial_bboxes, np.float32))
    tracker = ScanTracker(_model(weights_path, model_name, trust_pickle), TrackerConfig(smooth=smooth), device=device,
                          dynamic_template=dynamic_template, update_interval=update_interval,
                          recover_context=recover_context)
    state = tracker.init(frames[0], boxes)
    tracked = [boxes[0] if single else boxes]
    for t0 in range(1, len(frames), chunk):
        state, out = tracker.track(state, frames[t0:t0 + chunk], start_step=t0 - 1)
        bb = out["bbox"].cpu().numpy()
        tracked.extend(bb[:, 0] if single else bb)
    return tracked


def write_output(path: str, frames: List[np.ndarray], boxes, fps: float) -> None:
    """The drawn frames by ``path``'s suffix: ``.npz`` with numpy (frames
    and boxes), else a video with cv2."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.lower().endswith(".npz"):
        per_frame = np.stack([np.atleast_2d(np.asarray(b, np.float64)) for b in boxes])
        np.savez(path, frames=np.stack(frames), boxes=per_frame)
    else:
        write_video(path, frames, fps=fps)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--initial_bbox", type=int, nargs="+", default=[163, 53, 45, 174],
                   help="x y w h, or N×4 ints to track N objects in the same video (one ScanTracker stream "
                        "per object, the frames shared)")
    p.add_argument("--video_path", required=True,
                   help="a .npy of (T, H, W, 3) uint8 RGB frames, or a video file (decoded with cv2), such as "
                        "the reference's assets/test.mp4")
    p.add_argument("--output_path", default="outputs/test.mp4",
                   help=".npz (drawn frames and boxes, numpy) or a video file (cv2)")
    p.add_argument("--weights_path", default=default_weights_path(),
                   help="an .npz or zoo name, a Lightning .ckpt or a CoreML .mlmodel (default: $FEAR_WEIGHTS, "
                        "else the packaged fear_xs.npz)")
    p.add_argument("--trust_checkpoint", action="store_true",
                   help="unpickle a .ckpt that holds more than tensors and plain values in full (runs the code it "
                        "names: only for checkpoints you trust)")
    p.add_argument("--model", default="fear_xs", choices=["fear_tiny", "fear_xs", "fear_m", "fear_l"],
                   help="family trunk to build; pair it with matching weights")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--smooth", action="store_true", help="penalty-window decode + size smoothing")
    p.add_argument("--device", default="cuda",
                   help="where the tracker runs: 'cuda' (the kernels; the default) or 'cpu' (their plain twins)")
    p.add_argument("--runtime", choices=["host", "scan"], default="host",
                   help="host = the reference-API FEARTracker; scan = the multi-stream ScanTracker")
    p.add_argument("--dynamic_template", action="store_true", help="dual-template update (scan runtime)")
    p.add_argument("--update_interval", type=int, default=1,
                   help="consider a template refresh every K-th frame (scan runtime)")
    p.add_argument("--recover_context", type=float, default=0.0,
                   help="zoom-out re-acquisition context after a low-confidence frame (0 = off)")
    args = p.parse_args(argv)

    if len(args.initial_bbox) % 4:
        p.error(f"--initial_bbox takes N×4 ints, got {len(args.initial_bbox)}")
    num_objects = len(args.initial_bbox) // 4
    init_boxes = np.array(args.initial_bbox).reshape(num_objects, 4)
    if not args.output_path.lower().endswith(".npz"):
        require_cv2(f"writing {args.output_path}")  # before the tracking, not after it

    frames = read_video(args.video_path, max_frames=args.max_frames)
    if args.runtime == "scan" or num_objects > 1:
        bboxes = track_scan(args.weights_path, frames, init_boxes if num_objects > 1 else init_boxes[0],
                            smooth=args.smooth, dynamic_template=args.dynamic_template,
                            update_interval=args.update_interval, recover_context=args.recover_context,
                            model_name=args.model, device=args.device, trust_pickle=args.trust_checkpoint)
    else:
        tracker = get_tracker(args.weights_path, smooth=args.smooth, device=args.device,
                              recover_context=args.recover_context, model_name=args.model,
                              trust_pickle=args.trust_checkpoint)
        bboxes = track(tracker, frames, init_boxes[0])

    def draw(frame, per_frame):
        for i, b in enumerate(np.atleast_2d(np.asarray(per_frame))):
            frame = draw_bbox(frame, b, color=COLORS[i % len(COLORS)])
        return frame

    drawn = [draw(f, b) for f, b in zip(frames, bboxes)]
    write_output(args.output_path, drawn, bboxes, video_fps(args.video_path))
    print(f"tracked {len(frames)} frames x {num_objects} object(s) -> {args.output_path}")
    final = np.atleast_2d(np.asarray(bboxes[-1]))
    if num_objects == 1:
        print("final bbox:", list(map(int, final[0])))
    else:
        for i, b in enumerate(final):
            print(f"final bbox [{i}]:", list(map(int, b)))


if __name__ == "__main__":
    main()
