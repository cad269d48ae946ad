"""Video IO, the counterpart of ``feartracker_tpu/utils/video.py``.

Frames are RGB uint8. A ``.npy`` file of decoded (T, H, W, 3) uint8 frames
is read with numpy alone; any other path (an mp4, ...) is decoded and
written with cv2's video I/O, imported in the functions that need it. The
H100 host this port runs on has cv2 4.13.0 with the FFMPEG backend, which
writes and reads mp4v, so the demo takes and makes mp4 there; the image
readers do not use cv2 (``data/imread.py``). :func:`draw_bbox` is numpy
and draws the pixels ``cv2.rectangle`` draws.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

DEFAULT_FPS = 30.0  # cv2's answer when a file has no frame rate


def require_cv2(what: str):
    """cv2, or ImportError saying ``what`` needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (opencv), which is not installed; "
                          "use a .npy of (T, H, W, 3) uint8 frames instead") from e
    return cv2


def _is_npy(path: str) -> bool:
    return path.lower().endswith(".npy")


def _load_npy(path: str) -> np.ndarray:
    frames = np.load(path, mmap_mode="r")
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"{path}: need (T, H, W, 3) uint8 frames, got {frames.dtype} {frames.shape}")
    return frames


def read_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """A whole video as (T, H, W, 3) RGB uint8: a ``.npy`` of frames, or a
    file cv2 decodes."""
    frames = list(iter_video(path, max_frames))
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def iter_video(path: str, max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """The frames of ``path`` one at a time, as :func:`read_video` reads them."""
    if _is_npy(path):
        for frame in _load_npy(path)[:max_frames]:
            yield np.array(frame)
        return
    cv2 = require_cv2(f"decoding {path}")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    count = 0
    try:
        while max_frames is None or count < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            count += 1
    finally:
        cap.release()


def video_fps(path: str) -> float:
    """The file's frame rate; :data:`DEFAULT_FPS` for a ``.npy`` (it holds
    none) or where cv2 reads none."""
    if _is_npy(path):
        return DEFAULT_FPS
    cv2 = require_cv2(f"reading the frame rate of {path}")
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or DEFAULT_FPS
    cap.release()
    return fps


def write_video(path: str, frames: List[np.ndarray], fps: float = DEFAULT_FPS) -> None:
    """Encode RGB frames as an mp4v video with cv2 (raises without cv2)."""
    cv2 = require_cv2(f"writing {path}")
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    out.release()


def draw_bbox(image: np.ndarray, bbox, color=(0, 255, 0), width: int = 5) -> np.ndarray:
    """A copy of ``image`` with the box's outline drawn, the pixels of
    ``cv2.rectangle(image, (x, y), (x + w, y + h), color, width)`` with
    ``x, y, w, h = map(int, bbox)``: each side of the integer outline
    thickened by a disc of radius ``(width + 1) // 2`` (0 for one-pixel
    lines), clipped to the image."""
    image = image.copy()
    x, y, w, h = map(int, bbox)
    r = 0 if width <= 1 else (width + 1) // 2
    x0, x1, y0, y1 = min(x, x + w), max(x, x + w), min(y, y + h), max(y, y + h)
    H, W = image.shape[:2]
    top, left = max(y0 - r, 0), max(x0 - r, 0)
    bottom, right = min(y1 + r + 1, H), min(x1 + r + 1, W)
    if top >= bottom or left >= right:
        return image
    yy, xx = np.mgrid[top:bottom, left:right]

    def side(ax, ay, bx, by):
        cx, cy = np.clip(xx, ax, bx), np.clip(yy, ay, by)
        return (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r

    mask = side(x0, y0, x1, y0) | side(x0, y1, x1, y1) | side(x0, y0, x0, y1) | side(x1, y0, x1, y1)
    image[top:bottom, left:right][mask] = color
    return image
