"""Multi-stream tracking runtime, the counterpart of
``feartracker_tpu/tracker/runtime.py``.

For S independent streams and a chunk of T uint8 frames, each frame runs
crop → normalize → folded trunk (fused inverted-residual kernel) → neck →
BoxTower head against the cached template → fused decode → rescale → clamp,
and carries the per-stream state. ``lax.scan`` becomes a Python loop over T;
nothing in the loop waits for the device, so frames queue back to back.

Which implementation runs is decided by the device alone: on CUDA the two
kernels (:mod:`feartracker_tpu_torch.ops.cuda`), on the CPU their plain
twins. Precision follows the JAX runtime: the model runs in ``dtype``;
crop, normalize, decode and geometry stay float32.
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from feartracker_tpu_torch.core import postprocess as pp
from feartracker_tpu_torch.core.geometry import clamp_bbox, rescale_crop_bbox
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.crop import (
    crop_bbox_in_window,
    crop_resize,
    crop_resize_mm,
    extended_crop_window,
    normalize_imagenet,
)
from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda
from feartracker_tpu_torch.ops.fused_trunk import fold_fear_net, get_features_folded
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.utils.constants import (
    TARGET_CLASSIFICATION_KEY,
    TARGET_REGRESSION_LABEL_KEY,
)


class StreamState(NamedTuple):
    """Per-stream carried state (leading axis = streams)."""

    template_feats: torch.Tensor  # (S, 8, 8, C) static template, model dtype
    bbox: torch.Tensor  # (S, 4) xywh, frame coords, float32
    mean_color: torch.Tensor  # (S, 3) pad color from the init frame
    confidence: torch.Tensor  # (S,) last classification peak


class ScanTracker:
    """Multi-stream tracker on one device.

    Args:
      model: a float32 ``FEARNet`` with its weights loaded. The tracker folds
        its trunk + neck in float32, then keeps its own copy of the model in
        ``dtype`` on ``device`` for the head; ``model`` itself is not changed.
      config: decode constants.
      dtype: the model's compute dtype (float32 or bfloat16).
      device: where the tracker runs; inputs are moved there.
      crop_impl: "mm" (separable contractions, default) or "gather".

    Not ported yet (raise ``NotImplementedError``): ``dynamic_template``,
    ``update_mode`` other than "ema", ``gate_params``, ``update_interval`` > 1,
    ``recover_context`` > 0 and ``scan_unroll`` other than 1.
    """

    def __init__(
        self,
        model: FEARNet,
        config: TrackerConfig = TrackerConfig(),
        dtype: torch.dtype = torch.float32,
        device="cpu",
        crop_impl: str = "mm",
        dynamic_template: bool = False,
        update_mode: str = "ema",
        gate_params=None,
        update_interval: int = 1,
        recover_context: float = 0.0,
        scan_unroll: int = 1,
    ):
        unported = {
            "dynamic_template": dynamic_template,
            "update_mode": update_mode != "ema",
            "gate_params": gate_params is not None,
            "update_interval": update_interval != 1,
            "recover_context": recover_context != 0.0,
            "scan_unroll": scan_unroll != 1,
        }
        for name, requested in unported.items():
            if requested:
                raise NotImplementedError(f"ScanTracker: {name} is not ported yet")
        if crop_impl not in ("mm", "gather"):
            raise ValueError(f"crop_impl must be 'mm' or 'gather', got {crop_impl!r}")
        self.crop_impl = crop_impl
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
        src = copy.deepcopy(model).float().eval().to(self.device)
        self.specs = src.trunk_blocks
        self.folded = fold_fear_net(src, dtype)
        self.model = src.to(dtype)

    # -- building blocks ---------------------------------------------------

    def _crop(self, frames: torch.Tensor, windows: torch.Tensor, out_size: int,
              mean_color: torch.Tensor) -> torch.Tensor:
        if self.crop_impl == "mm":
            return crop_resize_mm(frames, windows, out_size, mean_color)
        return crop_resize(frames.float(), windows, out_size, mean_color)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return get_features_folded(x.to(self.dtype).contiguous(), self.folded, self.specs)

    def _template_features(self, frames, bboxes, mean_color) -> torch.Tensor:
        cfg = self.config
        windows = extended_crop_window(bboxes, cfg.template_bbox_offset)
        crops = self._crop(frames, windows, cfg.template_size, mean_color)
        return self._features(normalize_imagenet(crops))

    @staticmethod
    def _broadcast_shared(frames: torch.Tensor, num_streams: int) -> torch.Tensor:
        """Multi-object mode: a rank-3 (H, W, 3) frame is one video shared by
        all S streams; expanded as a view, so it is stored once."""
        if frames.dim() == 3:
            return frames[None].expand(num_streams, *frames.shape)
        return frames

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- public API --------------------------------------------------------

    @torch.inference_mode()
    def init(self, frames, bboxes, mean_color=None) -> StreamState:
        """First frame of every stream + initial boxes → carried state.

        ``frames``: (S, H, W, 3) uint8, or (H, W, 3) shared by the S objects
        of ``bboxes`` (S, 4) xywh. ``mean_color`` (S, 3) overrides the pad
        color (default: the float32 mean of the init frame)."""
        bboxes = self._to_device(bboxes).float()
        frames = self._broadcast_shared(self._to_device(frames), bboxes.shape[0])
        H, W = frames.shape[1], frames.shape[2]
        bboxes = clamp_bbox(bboxes, (H, W))
        if mean_color is None:
            mean_color = frames.float().mean(dim=(1, 2))
        else:
            mean_color = self._to_device(mean_color).float()
        feats = self._template_features(frames, bboxes, mean_color)
        return StreamState(
            template_feats=feats,
            bbox=bboxes,
            mean_color=mean_color,
            confidence=torch.ones(frames.shape[0], dtype=torch.float32, device=self.device),
        )

    @torch.inference_mode()
    def step(self, state: StreamState, frames) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
        """One frame for every stream: (S, H, W, 3), or (H, W, 3) shared."""
        cfg = self.config
        frames = self._broadcast_shared(self._to_device(frames), state.bbox.shape[0])
        H, W = frames.shape[1], frames.shape[2]

        windows = extended_crop_window(state.bbox, cfg.search_context)
        crops = self._crop(frames, windows, cfg.instance_size, state.mean_color)
        search = self._features(normalize_imagenet(crops))
        out = self.model.connector(state.template_feats, search)
        cls = out[TARGET_CLASSIFICATION_KEY].float().contiguous()
        reg = out[TARGET_REGRESSION_LABEL_KEY].float().contiguous()

        prev_size = crop_bbox_in_window(state.bbox, windows, cfg.instance_size)[:, 2:].contiguous()
        res = postprocess_cuda(cls, reg, cfg.postprocess, prev_size=prev_size)
        bbox = clamp_bbox(rescale_crop_bbox(res.bbox, windows, cfg.instance_size), (H, W))
        # per-frame map-sharpness diagnostic
        apce = pp.apce(torch.sigmoid(cls[..., 0]))

        new_state = state._replace(bbox=bbox, confidence=res.confidence)
        outputs = {
            "bbox": bbox,
            "confidence": res.confidence,
            "apce": apce,
            "failure": res.confidence < cfg.confidence_threshold,
        }
        return new_state, outputs

    def track(self, state: StreamState, frames) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
        """A chunk of frames (T, S, H, W, 3) — or (T, H, W, 3) shared by all
        streams — tracked frame by frame → (state, outputs stacked over T)."""
        frames = self._to_device(frames)
        per_frame = []
        for t in range(frames.shape[0]):
            state, out = self.step(state, frames[t])
            per_frame.append(out)
        stacked = {k: torch.stack([o[k] for o in per_frame]) for k in per_frame[0]}
        return state, stacked
