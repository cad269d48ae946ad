"""Generate the synthetic single-object tracking scenarios (train CSV +
GOT-10k style val sequences) with numpy alone: the counterpart of
``tools/make_synthetic_dataset.py``, which draws with cv2, writes JPEG and
writes its CSV with pandas.

The same ``np.random.RandomState(seed)`` stream is drawn in the same order,
so every box, ``presence``, ``near_corner``, ``visible`` and cover label
equals the JAX generator's; the shapes are drawn by cv2's rasterisers
repeated in numpy (:mod:`feartracker_tpu_torch.utils.raster`) and the
texture resized by the integer-exact ``INTER_LINEAR`` twin
(:func:`feartracker_tpu_torch.ops.resize.resize_linear_u8`). Frames are RGB
uint8 ``.npy`` files under the names the JAX generator gives its ``.jpg``
(lossless), or with ``--format jpg`` the JAX generator's JPEG files byte for
byte (``cv2.imwrite``'s quality 95, by :mod:`feartracker_tpu_torch.data.jpeg`).

    python -m feartracker_tpu_torch.tools.make_synthetic_dataset --root /tmp/synth --tracks 40 \\
        --frames 24 --val_sequences 8 --scenario occlusion [--format jpg]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from feartracker_tpu_torch.data.jpeg import encode_jpeg
from feartracker_tpu_torch.data.sequence import GOT10kDataset
from feartracker_tpu_torch.ops.resize import resize_linear_u8
from feartracker_tpu_torch.utils.raster import (
    box_points,
    ellipse_filled,
    fill_poly,
    rectangle_filled,
    resize_nearest,
)

SCENARIOS = ("drift", "occlusion", "pose", "swap")
COLUMNS = ("sequence_id", "track_id", "frame_index", "img_path", "bbox", "frame_shape", "dataset",
           "presence", "near_corner", "visible")


def _textured_background(rng, size, obj_scale=1.0):
    """Texture drawn on the logical (1×) grid, so that the rng's draws, and
    the whole stream after them, do not depend on the resolution."""
    h, w = size
    h0, w0 = int(round(h / obj_scale)), int(round(w / obj_scale))
    base = rng.randint(30, 120, (h0 // 8, w0 // 8, 3)).astype(np.uint8)
    bg = resize_linear_u8(torch.from_numpy(base), (w, h)).numpy()
    noise = rng.randint(-12, 13, (h0, w0, 3))
    if (h0, w0) != (h, w):
        noise = resize_nearest(noise.astype(np.int16), (w, h))
    return np.clip(bg.astype(int) + noise, 0, 255).astype(np.uint8)


def _draw_object(img, rng, cx, cy, w, h, color, kind, angle=0.0):
    """Draw a (possibly rotated) shape; returns its axis-aligned xywh bbox.
    ``rng`` is unused, as in the JAX generator (it draws nothing)."""
    if angle:
        if kind == 1:
            ellipse_filled(img, (int(cx), int(cy)), (int(w / 2), int(h / 2)), angle, color)
            rad = np.deg2rad(angle)
            ex = np.hypot(w / 2 * np.cos(rad), h / 2 * np.sin(rad))
            ey = np.hypot(w / 2 * np.sin(rad), h / 2 * np.cos(rad))
            x1, y1, x2, y2 = cx - ex, cy - ey, cx + ex, cy + ey
        else:
            if kind == 0:
                pts = box_points((float(cx), float(cy)), (float(w), float(h)), float(angle))
            else:
                base = np.array([[0.0, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
                rad = np.deg2rad(angle)
                rot = np.array([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]])
                pts = base @ rot.T + [cx, cy]
            fill_poly(img, pts.astype(np.int32), color)
            x1, y1 = pts.min(axis=0)
            x2, y2 = pts.max(axis=0)
        x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
        return [x1, y1, x2 - x1, y2 - y1]
    x1, y1 = int(cx - w / 2), int(cy - h / 2)
    x2, y2 = int(cx + w / 2), int(cy + h / 2)
    if kind == 0:
        rectangle_filled(img, (x1, y1), (x2, y2), color)
    elif kind == 1:
        ellipse_filled(img, (int(cx), int(cy)), (int(w / 2), int(h / 2)), 0, color)
    else:
        pts = np.array([[cx, y1], [x2, y2], [x1, y2]], np.int32)
        fill_poly(img, pts, color)
    return [x1, y1, x2 - x1, y2 - y1]


def generate_track(rng, out_dir, track_id, n_frames, size=(160, 224), distractors=2,
                   appearance_drift=0.0, scenario="drift", obj_scale=1.0,
                   presence_dropout=0.0, fmt="npy"):
    """One track's frames saved under ``out_dir`` as ``fmt`` (``npy`` or
    ``jpg``, see :func:`save_frame`) → its CSV rows. The
    arguments and the scenarios are the JAX generator's
    (``tools/make_synthetic_dataset.py:generate_track``): ``drift`` (a colour
    morph), ``occlusion`` (two occluder bars sweep over the object),
    ``pose`` (an out-of-plane rotation with foreshortening and shading),
    ``swap`` (a same-looking distractor crosses the object at mid-track);
    ``obj_scale`` scales every absolute-pixel quantity after the draws;
    ``presence_dropout`` leaves the object out of a frame ≥ 2 with that
    probability (an extra draw only when it is on)."""
    h, w = size
    bg = _textured_background(rng, size, obj_scale=obj_scale)
    color = tuple(int(c) for c in rng.randint(120, 255, 3))
    color2 = tuple(int(c) for c in rng.randint(60, 255, 3))
    kind = int(rng.randint(3))
    cx, cy = rng.uniform(0.3 * w, 0.7 * w), rng.uniform(0.3 * h, 0.7 * h)
    ow, oh = rng.uniform(24, 48) * obj_scale, rng.uniform(24, 48) * obj_scale
    vx, vy = rng.uniform(-4, 4) * obj_scale, rng.uniform(-3, 3) * obj_scale
    dis = [
        (tuple(int(c) for c in rng.randint(60, 255, 3)), int(rng.randint(3)),
         rng.uniform(0, w), rng.uniform(0, h), rng.uniform(12, 36) * obj_scale,
         rng.uniform(-3, 3) * obj_scale, rng.uniform(-3, 3) * obj_scale)
        for _ in range(distractors)
    ]
    # occluder bars: (width, color, crossing frame), timed so the bar centre
    # meets the object centre at the crossing frame
    occluders = [
        (rng.uniform(0.8, 1.2), tuple(int(c) for c in rng.randint(40, 220, 3)), n_frames // 3),
        (rng.uniform(0.8, 1.2), tuple(int(c) for c in rng.randint(40, 220, 3)), (2 * n_frames) // 3),
    ]
    rows = []
    for f in range(n_frames):
        img = bg.copy()
        for dcolor, dkind, dx, dy, ds, dvx, dvy in dis:  # distractors first (the object occludes them)
            px = (dx + dvx * f) % w
            py = (dy + dvy * f) % h
            _draw_object(img, rng, px, py, ds, ds, dcolor, dkind)
        scale = 1.0 + 0.25 * np.sin(f / 6.0)
        cxf = np.clip(cx + vx * f, 0.15 * w, 0.85 * w)
        cyf = np.clip(cy + vy * f, 0.15 * h, 0.85 * h)
        t = f / max(n_frames - 1, 1)
        t_drift = appearance_drift * t
        base = tuple((1 - t_drift) * a + t_drift * b for a, b in zip(color, color2))
        angle = 0.0
        w_eff = ow * scale
        if scenario == "pose":
            angle = 140.0 * t
            fore = 0.35 + 0.65 * abs(np.cos(np.deg2rad(angle)))
            w_eff *= fore
            shade = 0.55 + 0.45 * fore
            base = tuple(c * shade for c in base)
        jitter = tuple(int(np.clip(c + rng.randint(-10, 11), 0, 255)) for c in base)
        absent = bool(presence_dropout) and f >= 2 and rng.rand() < presence_dropout
        # an absent object's box is drawn on a scratch canvas
        bbox = _draw_object(img.copy() if absent else img, rng, cxf, cyf, w_eff, oh * scale, jitter, kind,
                            angle=angle)
        visible = 0.0 if absent else 1.0  # the analytic visible fraction, no draws
        if scenario == "swap":
            mid = n_frames / 2.0
            sx = cxf + (f - mid) * 5.0 * obj_scale
            sy = cyf + (f - mid) * 1.5 * obj_scale
            if 0 <= sx < w and 0 <= sy < h:
                _draw_object(img, rng, sx, sy, ow * scale, oh * scale, jitter, kind)
                if not absent:
                    dw, dh = ow * scale, oh * scale
                    ox = max(0.0, min(bbox[0] + bbox[2], sx + dw / 2) - max(bbox[0], sx - dw / 2))
                    oy = max(0.0, min(bbox[1] + bbox[3], sy + dh / 2) - max(bbox[1], sy - dh / 2))
                    visible *= 1.0 - ox * oy / max(bbox[2] * bbox[3], 1.0)
        if scenario == "occlusion":
            covered = []  # x-intervals of full-height bars over the bbox
            for bw_scale, ocolor, f_cross in occluders:
                bar_w = int(ow * bw_scale)
                bx = int(cxf + (f - f_cross) * 6.0 * obj_scale)
                if -bar_w < bx < w + bar_w:
                    rectangle_filled(img, (bx - bar_w // 2, 0), (bx + bar_w // 2, h), ocolor)
                    lo = max(float(bbox[0]), bx - bar_w // 2)
                    hi = min(float(bbox[0] + bbox[2]), bx + bar_w // 2)
                    if hi > lo:
                        covered.append((lo, hi))
            if not absent and covered:
                covered.sort()
                total, cur_lo, cur_hi = 0.0, *covered[0]
                for lo, hi in covered[1:]:  # union of overlapping intervals
                    if lo > cur_hi:
                        total += cur_hi - cur_lo
                        cur_lo, cur_hi = lo, hi
                    else:
                        cur_hi = max(cur_hi, hi)
                total += cur_hi - cur_lo
                visible *= 1.0 - total / max(float(bbox[2]), 1.0)
        path = f"{track_id}_f{f:04d}.{fmt}"
        save_frame(os.path.join(out_dir, path), img)
        near = int(bbox[0] <= 2 or bbox[1] <= 2 or bbox[0] + bbox[2] >= w - 2 or bbox[1] + bbox[3] >= h - 2)
        rows.append(
            dict(
                sequence_id=track_id, track_id=track_id, frame_index=f, img_path=path,
                bbox=str(bbox), frame_shape=str([w, h]), dataset="synthetic",
                presence=0 if absent else 1, near_corner=near,
                visible=round(float(visible), 4),
            )
        )
    return rows


def save_frame(path: str, img: np.ndarray) -> None:
    """An RGB uint8 frame: ``.npy`` by numpy, ``.jpg`` as ``cv2.imwrite`` of
    its BGR twin writes it (quality 95)."""
    if path.endswith(".npy"):
        np.save(path, img)
    elif path.endswith(".jpg"):
        with open(path, "wb") as fh:
            fh.write(encode_jpeg(img, 95))
    else:
        raise ValueError(f"save_frame: {path!r} is neither .npy nor .jpg")


def generate(root, tracks=40, frames=24, val_sequences=8, seed=0, size=(160, 224),
             appearance_drift=0.0, scenario="drift", obj_scale=1.0,
             presence_dropout=0.0, fmt="npy"):
    """``root/images`` + ``root/train.csv`` (``tracks`` tracks) and
    ``root/got10k/val`` (``val_sequences`` sequences with
    ``groundtruth.txt``, ``cover.label`` and ``list.txt``) → the CSV's path.
    ``presence_dropout`` applies to the train tracks only: val sequences are
    scored frame by frame and keep the target visible. ``fmt`` is the frames'
    format, ``npy`` or ``jpg``."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for t in range(tracks):
        rows += generate_track(rng, img_dir, f"track{t:04d}", frames, size=size,
                               appearance_drift=appearance_drift, scenario=scenario,
                               obj_scale=obj_scale, presence_dropout=presence_dropout, fmt=fmt)
    csv_path = os.path.join(root, "train.csv")
    with open(csv_path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(COLUMNS), lineterminator="\n")
        writer.writeheader()
        writer.writerows({**r, "img_path": "images/" + r["img_path"]} for r in rows)

    val_base = os.path.join(root, "got10k", "val")
    os.makedirs(val_base, exist_ok=True)
    names = []
    for s in range(val_sequences):
        seq = f"GOT-10k_Val_{s:06d}"
        seq_dir = os.path.join(val_base, seq)
        os.makedirs(seq_dir, exist_ok=True)
        vrows = generate_track(rng, seq_dir, seq, frames, size=size,
                               appearance_drift=appearance_drift, scenario=scenario,
                               obj_scale=obj_scale, fmt=fmt)
        gt = []
        for i, r in enumerate(vrows):
            os.replace(os.path.join(seq_dir, r["img_path"]), os.path.join(seq_dir, f"{i:08d}.{fmt}"))
            gt.append(",".join(map(str, json.loads(r["bbox"]))))
        with open(os.path.join(seq_dir, "groundtruth.txt"), "w") as fh:
            fh.write("\n".join(gt))
        # GOT-10k's per-frame cover labels (0..8 visible-ratio bins) from the
        # analytic visible fraction
        with open(os.path.join(seq_dir, "cover.label"), "w") as fh:
            fh.write("\n".join(str(int(round(r["visible"] * 8))) for r in vrows))
        names.append(seq)
    with open(os.path.join(val_base, "list.txt"), "w") as fh:
        fh.write("\n".join(names))
    return csv_path


def scenario_datasets(work: str, scenarios: Sequence[str], seeds: Sequence[int], frames: int, sequences: int,
                      drift: float = 1.0, suffix: str = "", **kw) -> Dict[Tuple[str, int], object]:
    """The ablation tools' datasets: ``<work>/<scenario>_s<seed><suffix>``,
    generated with one track and ``sequences`` val sequences of ``frames``
    frames unless the root already holds ``got10k`` (then reused as it is,
    ``.npy`` or JPEG), ``drift`` the appearance drift of the ``drift``
    scenario; ``kw`` go to :func:`generate` (``size``, ``obj_scale``). →
    ``{(scenario, seed): GOT10kDataset}`` of the val subsets."""
    datasets = {}
    for scenario in scenarios:
        for seed in seeds:
            root = os.path.join(work, f"{scenario}_s{seed}{suffix}")
            if not os.path.isdir(os.path.join(root, "got10k")):
                generate(root, tracks=1, frames=frames, val_sequences=sequences, seed=seed,
                         appearance_drift=drift if scenario == "drift" else 0.0, scenario=scenario, **kw)
            datasets[(scenario, seed)] = GOT10kDataset(os.path.join(root, "got10k"), subset="val")
    return datasets


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", required=True)
    p.add_argument("--tracks", type=int, default=40)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--val_sequences", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--appearance_drift", type=float, default=0.0,
                   help="0..1: object color morphs to a second color over the track")
    p.add_argument("--scenario", default="drift", choices=list(SCENARIOS),
                   help="structural-appearance-change regime (see generate_track)")
    p.add_argument("--height", type=int, default=160)
    p.add_argument("--width", type=int, default=224)
    p.add_argument("--obj_scale", type=float, default=1.0,
                   help="multiply object sizes/velocities (pair with size·k "
                   "for a k× resolution render of the same scene)")
    p.add_argument("--presence_dropout", type=float, default=0.0,
                   help="per-frame probability a train frame omits the target "
                   "(presence=0 negative rows; val sequences unaffected)")
    p.add_argument("--format", default="npy", choices=("npy", "jpg"),
                   help="frame files: lossless .npy, or the JAX generator's JPEG (quality 95)")
    args = p.parse_args(argv)
    csv_path = generate(args.root, args.tracks, args.frames, args.val_sequences, args.seed,
                        size=(args.height, args.width), appearance_drift=args.appearance_drift,
                        scenario=args.scenario, obj_scale=args.obj_scale,
                        presence_dropout=args.presence_dropout, fmt=args.format)
    print(f"wrote {csv_path} + val sequences under {args.root}/got10k/val")


if __name__ == "__main__":
    main()
