"""Single-stream online tracker with the reference's ``initialize``/``update``
API, the counterpart of ``feartracker_tpu/tracker/tracker.py``.

Per frame the host uploads the uint8 frame once; the context crop (the
integer-exact cv2 twin, :mod:`feartracker_tpu_torch.data.crops`), the
normalize, the folded trunk (K2), the head and the fused decode (K1) run on
the tracker's device, the same code :class:`ScanTracker` runs at S=1. One
read of the crop-space box and confidence comes back; the rescale and clamp
are the reference's numpy integer geometry on the host.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from feartracker_tpu_torch.core.geometry_np import clamp_bbox, rescale_crop_bbox
from feartracker_tpu_torch.data.crops import get_extended_crop
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.crop import normalize_imagenet
from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda
from feartracker_tpu_torch.ops.resize import pad_color_u8
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker, full_float32
from feartracker_tpu_torch.utils.constants import (
    TARGET_CLASSIFICATION_KEY,
    TARGET_REGRESSION_LABEL_KEY,
)


class FEARTracker:
    """Single-stream online tracker.

    Args:
      model: a float32 ``FEARNet`` with its weights loaded (not changed).
      config: crop and decode constants.
      dtype / device: the model's compute dtype and where the tracker runs,
        as for :class:`ScanTracker`; crop, normalize and decode stay exact
        uint8 / float32.
      native_preprocess: the JAX package's C++ host crop engine; not ported
        (raises ``NotImplementedError``).
      recover_context / recover_threshold: after a frame whose confidence
        fell below ``recover_threshold`` (default
        ``config.confidence_threshold``), crop the next search window at
        context ``recover_context``; 0 disables it.
      dynamic_template / update_threshold / update_rate / update_interval:
        dual-template EMA. Every ``update_interval``-th update whose
        confidence exceeds ``update_threshold`` encodes a candidate template
        at the new box and sets ``dyn ← (1 − rate)·dyn + rate·cand``; the
        classification branch correlates against ``dyn``.
    """

    def __init__(
        self,
        model: FEARNet,
        config: TrackerConfig = TrackerConfig(),
        dtype: torch.dtype = torch.float32,
        device="cuda",
        native_preprocess: bool = False,
        recover_context: float = 0.0,
        recover_threshold: Optional[float] = None,
        dynamic_template: bool = False,
        update_threshold: float = 0.85,
        update_rate: float = 0.1,
        update_interval: int = 1,
    ):
        if recover_context < 0:
            raise ValueError(f"recover_context must be >= 0, got {recover_context}")
        if update_interval < 1:
            raise ValueError(f"update_interval must be >= 1, got {update_interval}")
        if dynamic_template and native_preprocess:
            raise ValueError(
                "dynamic_template is implemented on the cv2 preprocess path; "
                "combine it with native_preprocess=False"
            )
        if native_preprocess:
            raise NotImplementedError("FEARTracker: native_preprocess (the C++ crop engine) is not ported")
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
        self.recover_context = float(recover_context)
        self.recover_threshold = (
            config.confidence_threshold if recover_threshold is None else float(recover_threshold)
        )
        self.dynamic_template = bool(dynamic_template)
        self.update_threshold = float(update_threshold)
        self.update_rate = float(update_rate)
        self.update_interval = int(update_interval)
        self.last_confidence: float = 1.0
        self.bbox: Optional[np.ndarray] = None
        self.mean_color: Optional[np.ndarray] = None
        self.prev_size: Optional[np.ndarray] = None
        self.paths: deque = deque(maxlen=10)
        self.set_variables(model)

    def set_variables(self, model: FEARNet) -> None:
        """Swap in another loaded model: refold its weights and reset the
        cached templates."""
        self._net = ScanTracker(model, self.config, dtype=self.dtype, device=self.device)
        self.reset()

    def reset(self) -> None:
        self._template_features: Optional[torch.Tensor] = None
        self._dyn_features: Optional[torch.Tensor] = None
        self._frame_count = 0

    def _upload(self, image: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def _features(self, crop: torch.Tensor) -> torch.Tensor:
        return self._net._features(normalize_imagenet(crop.float())[None])

    @full_float32
    @torch.inference_mode()
    def initialize(self, image: np.ndarray, rect: np.ndarray) -> None:
        rect = clamp_bbox(np.asarray(rect), image.shape)
        self.bbox = rect
        self.paths = deque([rect], maxlen=10)
        self.last_confidence = 1.0
        self.mean_color = np.mean(image, axis=(0, 1))
        self._pad_color = pad_color_u8(self.mean_color, self.device)
        template_crop, _, _ = get_extended_crop(
            self._upload(image), rect, self.config.template_size,
            self.config.template_bbox_offset, self._pad_color,
        )
        self._template_features = self._features(template_crop)
        self._dyn_features = self._template_features
        self._frame_count = 0

    @full_float32
    @torch.inference_mode()
    def update(self, image: np.ndarray) -> Dict[str, Any]:
        if self._template_features is None:
            raise RuntimeError("call initialize() first")
        cfg = self.config
        context = cfg.search_context
        if self.recover_context and self.last_confidence < self.recover_threshold:
            context = self.recover_context
        frame = self._upload(image)
        search_crop, search_bbox, window = get_extended_crop(
            frame, self.bbox, cfg.instance_size, context, self._pad_color,
        )
        self.prev_size = search_bbox[2:]
        # prev_size is read only by the smoothing decode: uploading it
        # otherwise would be a copy from host memory in mid-frame
        prev = (torch.tensor(self.prev_size, dtype=torch.float32, device=self.device)[None]
                if cfg.smooth else None)
        update = self._dyn_features if self.dynamic_template else None
        out = self._net.model.connector(self._template_features, self._features(search_crop), update)
        res = postprocess_cuda(
            out[TARGET_CLASSIFICATION_KEY].float().contiguous(),
            out[TARGET_REGRESSION_LABEL_KEY].float().contiguous(),
            cfg.postprocess, prev_size=prev,
        )
        # the one read of the frame: crop-space box and confidence together
        box_conf = torch.cat([res.bbox[0], res.confidence]).cpu().numpy()
        confidence = float(box_conf[4])
        pred = rescale_crop_bbox(box_conf[:4], window, cfg.instance_size)
        pred = clamp_bbox(pred, image.shape)
        self.bbox = pred
        self.paths.append(pred)
        self.last_confidence = confidence
        self._frame_count += 1
        if (
            self.dynamic_template
            and confidence > self.update_threshold
            and self._frame_count % self.update_interval == 0
        ):
            # the candidate pads with this frame's mean colour (the crop's
            # default), as in JAX
            cand_crop, _, _ = get_extended_crop(
                frame, pred, cfg.template_size, cfg.template_bbox_offset,
            )
            cand = self._features(cand_crop)
            self._dyn_features = (1.0 - self.update_rate) * self._dyn_features + self.update_rate * cand
        return {"bbox": pred, "confidence": confidence}
