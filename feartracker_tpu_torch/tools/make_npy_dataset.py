"""Write a synthetic training dataset with numpy alone: clips of a textured
object moving on an ellipse and changing scale over a noise background,
each frame an RGB uint8 ``.npy`` file, and the training CSV that names them
with the columns of ``tools/make_synthetic_dataset.py`` (which needs cv2 and
pandas; a host without them trains on this one):

    python -m feartracker_tpu_torch.tools.make_npy_dataset --root /tmp/npy --clips 8 --frames 40

Then point a train dataset at it (``root``: the directory,
``sampling.data_path``: ``<root>/train.csv``).
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Tuple

import numpy as np

SEED = 30  # clip c is rendered from SEED + c
NAME = "rendered"  # the CSV's dataset column
COLUMNS = ("sequence_id", "track_id", "frame_index", "img_path", "bbox", "frame_shape", "dataset",
           "presence", "near_corner", "visible")


def render_clip(seed: int, n_frames: int, hw: Tuple[int, int] = (256, 480)) -> Tuple[List[np.ndarray], np.ndarray]:
    """(frames, boxes): ``n_frames`` (H, W, 3) uint8 frames rendered from
    ``seed``, and the object's true box in each, (n, 4) xywh float64."""
    rng = np.random.RandomState(seed)
    H, W = hw
    coarse = np.kron(rng.randint(0, 256, (H // 16, W // 16, 3)), np.ones((16, 16, 1), np.int64))
    background = coarse // 2 + rng.randint(0, 128, (H, W, 3))
    texture = np.kron(rng.randint(0, 256, (8, 8, 3)), np.ones((8, 8, 1), np.int64))  # 64×64
    phase = rng.rand() * 2 * np.pi
    frames, boxes = [], []
    for t in range(n_frames):
        a = phase + 2 * np.pi * t / 60
        s = 1.0 + 0.35 * np.sin(2 * a)
        w, h = int(56 * s), int(40 * s)
        x0 = int(np.clip(round(W / 2 + 0.35 * W * np.sin(a) - w / 2), 0, W - w))
        y0 = int(np.clip(round(H / 2 + 0.3 * H * np.cos(a) - h / 2), 0, H - h))
        frame = np.clip(background + rng.randint(-8, 9, (H, W, 3)), 0, 255)
        frame[y0:y0 + h, x0:x0 + w] = texture[np.arange(h) * 64 // h][:, np.arange(w) * 64 // w]
        frames.append(frame.astype(np.uint8))
        boxes.append([x0, y0, w, h])
    return frames, np.asarray(boxes, np.float64)


def write_npy_dataset(root: str, clips: int = 8, frames: int = 40, hw: Tuple[int, int] = (256, 480)) -> str:
    """Clip ``c`` rendered from ``SEED + c``, its frames saved as
    ``<root>/c<c>_f<t>.npy``, and ``<root>/train.csv`` naming them (paths
    relative to ``root``; every object present) → the CSV's path."""
    os.makedirs(root, exist_ok=True)
    rows = []
    for c in range(clips):
        imgs, boxes = render_clip(seed=SEED + c, n_frames=frames, hw=hw)
        for f, (img, box) in enumerate(zip(imgs, boxes)):
            path = f"c{c}_f{f:03d}.npy"
            np.save(os.path.join(root, path), img)
            rows.append({"sequence_id": f"c{c}", "track_id": f"c{c}", "frame_index": f, "img_path": path,
                         "bbox": str([int(v) for v in box]), "frame_shape": str([hw[1], hw[0]]),
                         "dataset": NAME, "presence": 1, "near_corner": 0, "visible": 1.0})
    path = os.path.join(root, "train.csv")
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(COLUMNS))
        writer.writeheader()
        writer.writerows(rows)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", required=True)
    p.add_argument("--clips", type=int, default=8)
    p.add_argument("--frames", type=int, default=40)
    args = p.parse_args(argv)
    path = write_npy_dataset(args.root, args.clips, args.frames)
    print(f"wrote {path}: {args.clips} clips of {args.frames} .npy frames")


if __name__ == "__main__":
    main()
