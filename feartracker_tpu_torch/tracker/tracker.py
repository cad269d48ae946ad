"""Single-stream online tracker with the reference's ``initialize``/``update``
API, the counterpart of ``feartracker_tpu/tracker/tracker.py``.

Per frame the host uploads the uint8 frame once; the context crop (the
integer-exact cv2 twin, :mod:`feartracker_tpu_torch.data.crops`), the
normalize, the folded trunk (K2), the head and the fused decode (K1) run on
the tracker's device, the same code :class:`ScanTracker` runs at S=1. One
read of the crop-space box and confidence comes back; the rescale and clamp
are the reference's numpy integer geometry on the host. With
``native_preprocess`` the crop is the batched tracker's bilinear device crop
at S=1 instead of the cv2 twin.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from feartracker_tpu_torch.core.geometry_np import (
    clamp_bbox,
    ensure_bbox_boundaries,
    extend_bbox,
    rescale_crop_bbox,
)
from feartracker_tpu_torch.data.crops import get_extended_crop
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.crop import crop_resize_mm, normalize_imagenet
from feartracker_tpu_torch.ops.cuda.decode import box_and_confidence, postprocess_cuda
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
      native_preprocess: the counterpart of the JAX package's fused C++
        crop engine, which computes the device crop op's bilinear crop and
        normalize rather than the cv2 chain: here the device crop itself at
        S=1 (``ops/crop.py`` ``crop_resize_mm`` on the float32 window of
        ``extend_bbox``, padded with the frame's float mean colour, then
        ``normalize_imagenet``), in place of the ≈20 launches of the
        cv2-exact crop. Not with ``dynamic_template`` (``ValueError``, as
        in JAX).
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
        self.native_preprocess = bool(native_preprocess)
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

    def _head(self, search: torch.Tensor):
        """The head on search features against the template(s) → (cls, reg)."""
        update = self._dyn_features if self.dynamic_template else None
        out = self._net.model.connector(self._template_features, search, update)
        return out[TARGET_CLASSIFICATION_KEY], out[TARGET_REGRESSION_LABEL_KEY]

    def _track(self, search_crop: torch.Tensor):
        """The network's share of an update: a uint8 (S, S, 3) search crop →
        the head's (cls, reg)."""
        return self._head(self._features(search_crop))

    def _native_crop(self, frame: torch.Tensor, window: np.ndarray, out_size: int, prev_size=None):
        """``native_preprocess``'s crop of ``window`` (an ``extend_bbox``
        window, as float32) → (the normalized (1, out, out, 3) crop,
        ``prev_size`` as (1, 2) on the device when the decode smooths, else
        None). The window and ``prev_size`` go to the device in one copy."""
        host = np.concatenate([window, () if prev_size is None else prev_size]).astype(np.float32)[None]
        on_device = torch.from_numpy(host).to(self.device)
        crop = crop_resize_mm(frame[None], on_device[:, :4], out_size, self._pad_float)
        prev = on_device[:, 4:] if prev_size is not None and self.config.smooth else None
        return normalize_imagenet(crop), prev

    @full_float32
    @torch.inference_mode()
    def initialize(self, image: np.ndarray, rect: np.ndarray) -> None:
        rect = clamp_bbox(np.asarray(rect), image.shape)
        self.bbox = rect
        self.paths = deque([rect], maxlen=10)
        self.last_confidence = 1.0
        self.mean_color = np.mean(image, axis=(0, 1))
        if self.native_preprocess:
            self._pad_float = torch.from_numpy(self.mean_color.astype(np.float32)[None]).to(self.device)
            window = extend_bbox(rect, self.config.template_bbox_offset)
            crop, _ = self._native_crop(self._upload(image), window, self.config.template_size)
            self._template_features = self._net._features(crop)
        else:
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
        if self.native_preprocess:
            # JAX's native path: the crop on the float window, the box
            # geometry on its int64 copy
            window = extend_bbox(np.asarray(self.bbox), context).astype(np.int64)
            padded = ensure_bbox_boundaries(
                np.array([self.bbox[0] - window[0], self.bbox[1] - window[1], self.bbox[2], self.bbox[3]]),
                img_shape=(int(window[3]), int(window[2])),
            )
            self.prev_size = padded[2:] * (cfg.instance_size / window[2:4].astype(np.float64))
            search, prev = self._native_crop(frame, window, cfg.instance_size, self.prev_size)
            cls, reg = self._head(self._net._features(search))
        else:
            search_crop, search_bbox, window = get_extended_crop(
                frame, self.bbox, cfg.instance_size, context, self._pad_color,
            )
            self.prev_size = search_bbox[2:]
            # prev_size is read only by the smoothing decode: uploading it
            # otherwise would be a copy from host memory in mid-frame
            prev = (torch.tensor(self.prev_size, dtype=torch.float32, device=self.device)[None]
                    if cfg.smooth else None)
            cls, reg = self._track(search_crop)
        # K1 on the head's outputs in their own dtype
        res = postprocess_cuda(cls, reg, cfg.postprocess, prev_size=prev)
        # the one read of the frame: crop-space box and confidence, one buffer
        box_conf = box_and_confidence(res).cpu().numpy()
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
