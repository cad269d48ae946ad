"""Host image helpers (numpy), the counterpart of
``feartracker_tpu/utils/image.py``."""

from __future__ import annotations

import numpy as np

from feartracker_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


def normalize_imagenet_np(image: np.ndarray) -> np.ndarray:
    """[0,255] RGB (uint8 or float) → ImageNet-normalized float32; the host
    twin of ``ops.crop.normalize_imagenet``."""
    mean = np.asarray(IMAGENET_MEAN, np.float32) * 255.0
    std = np.asarray(IMAGENET_STD, np.float32) * 255.0
    return (image.astype(np.float32) - mean) / std
