"""Frame reading for the evaluation protocols, the counterpart of
``read_img`` in ``feartracker_tpu/data/dataset.py``."""

from __future__ import annotations

from typing import Union

import numpy as np


def read_img(frame: Union[str, np.ndarray]) -> np.ndarray:
    """An RGB uint8 (H, W, 3) frame. A decoded ``np.ndarray`` passes through
    unchanged, so a dataset may hold frames in memory; a path is decoded
    with cv2, which is imported here and only here."""
    if isinstance(frame, np.ndarray):
        return frame
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {frame!r} needs cv2 (opencv), which is not installed; "
                          "pass decoded frames as numpy arrays instead") from e
    img = cv2.imread(frame)
    if img is None:
        raise IOError(f"cannot read image {frame}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
