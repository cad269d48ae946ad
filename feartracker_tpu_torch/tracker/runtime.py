"""Multi-stream tracking runtime, the counterpart of
``feartracker_tpu/tracker/runtime.py``.

For S independent streams and a chunk of T uint8 frames, each frame runs
crop → normalize → folded trunk (fused inverted-residual kernel) → neck →
BoxTower head against the cached template → fused decode → rescale → clamp,
and carries the per-stream state. ``lax.scan`` becomes a Python loop over T;
nothing in the loop waits for the device, so frames queue back to back.
With ``dynamic_template`` a refresh frame also crops and encodes a candidate
template at the new box (the 128² crop through the same trunk kernels) and
blends it into the dynamic template.

Which implementation runs is decided by the device alone: on CUDA the two
kernels (:mod:`feartracker_tpu_torch.ops.cuda`), on the CPU their plain
twins. Precision follows the JAX runtime: the model runs in ``dtype``;
crop, normalize, decode and geometry stay float32. In float32 the card runs
full float32, as JAX does on the CPU: torch's default lets cuDNN take TF32
for float32 convolutions (the stem, the head), which moved the sequential
tracker's boxes by 3 px over 59 frames on the H100 (``chip_smoke.py`` phase
9d); :func:`full_float32` turns TF32 off around each float32 call.
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from feartracker_tpu_torch.convert.load import resolve_weights
from feartracker_tpu_torch.core import postprocess as pp
from feartracker_tpu_torch.core.geometry import clamp_bbox, rescale_crop_bbox
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.models.gate import (
    N_OBS,
    gate_observables,
    gate_params_to,
    gate_rate,
    load_gate,
)
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


def full_float32(method):
    """Run a tracker method whose ``self.dtype`` is float32 with TF32 off for
    cuDNN convolutions and matmuls, restoring the caller's flags after;
    bfloat16 trackers run under the caller's flags."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        if self.dtype != torch.float32:
            return method(self, *args, **kwargs)
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = (cudnn.allow_tf32, matmul.allow_tf32)
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        try:
            return method(self, *args, **kwargs)
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = saved

    return wrapped


class StreamState(NamedTuple):
    """Per-stream carried state (leading axis = streams)."""

    template_feats: torch.Tensor  # (S, 8, 8, C) static template, model dtype
    dyn_feats: torch.Tensor  # (S, 8, 8, C) dynamic (dual) template, model dtype
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
      device: where the tracker runs (default the card; ``"cpu"`` runs the
        kernels' plain twins); inputs are moved there.
      crop_impl: "mm" (separable contractions, default) or "gather".
      dynamic_template: refresh a dynamic template each eligible frame: a
        candidate template is cropped at the new box, encoded, and blended
        into ``dyn_feats``, which the classification branch correlates
        against.
      update_mode: "ema" (``dyn ← (1−r)·dyn + r·cand`` where confidence >
        ``update_threshold``), "gated" (``(1−g)·template + g·cand`` with
        ``g = sigmoid(template_gate)`` of the loaded weights, same threshold)
        or "feature" (gate v2: a per-stream rate
        ``gate_rate(gate_params, obs)·update_rate``, no threshold).
      gate_params: the gate v2 weights (``models/gate.py``), a dict, an
        ``.npz`` path or a bare zoo name ("fear_xs_feature_gate"); only with
        ``update_mode="feature"``.
      update_interval: refresh only on frames whose index is a multiple of
        it (``step_index`` / ``track(start_step=…)``); off-cadence frames
        skip the candidate encode and emit zero ``gate_obs``.
      recover_context / recover_threshold: zoom-out re-acquisition; after a
        frame whose confidence fell below ``recover_threshold`` (default
        ``config.confidence_threshold``) that stream's next search window
        uses context ``recover_context`` instead of ``search_context``.
        0 disables it.
      scan_unroll: 1 only; other values raise ``NotImplementedError`` (the
        JAX option is an XLA fusion knob).
    """

    def __init__(
        self,
        model: FEARNet,
        config: TrackerConfig = TrackerConfig(),
        dtype: torch.dtype = torch.float32,
        device="cuda",
        crop_impl: str = "mm",
        dynamic_template: bool = False,
        update_threshold: float = 0.85,
        update_rate: float = 0.1,
        update_mode: str = "ema",
        gate_params=None,
        update_interval: int = 1,
        recover_context: float = 0.0,
        recover_threshold: Optional[float] = None,
        scan_unroll: int = 1,
    ):
        if crop_impl not in ("mm", "gather"):
            raise ValueError(f"crop_impl must be 'mm' or 'gather', got {crop_impl!r}")
        if update_mode not in ("ema", "gated", "feature"):
            raise ValueError(f"update_mode must be 'ema', 'gated' or 'feature', got {update_mode!r}")
        if update_mode == "feature" and gate_params is None:
            raise ValueError("update_mode='feature' requires gate_params")
        if update_mode != "feature" and gate_params is not None:
            raise ValueError("gate_params is only meaningful with update_mode='feature'")
        if update_interval < 1:
            raise ValueError(f"update_interval must be >= 1, got {update_interval}")
        if recover_context < 0:
            raise ValueError(f"recover_context must be >= 0, got {recover_context}")
        if scan_unroll < 1:
            raise ValueError(f"scan_unroll must be >= 1, got {scan_unroll}")
        if scan_unroll != 1:
            raise NotImplementedError("ScanTracker: scan_unroll other than 1 is not ported")
        self.crop_impl = crop_impl
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
        self.dynamic_template = dynamic_template
        self.update_threshold = update_threshold
        self.update_rate = update_rate
        self.update_mode = update_mode
        self.update_interval = int(update_interval)
        self.recover_context = float(recover_context)
        self.recover_threshold = (
            config.confidence_threshold if recover_threshold is None else float(recover_threshold)
        )
        self._gate = None
        if update_mode == "feature":
            if isinstance(gate_params, str):
                gate_params = load_gate(resolve_weights(gate_params))
            self._gate = gate_params_to(gate_params, self.device)
        src = copy.deepcopy(model).float().eval().to(self.device)
        self.specs = src.trunk_blocks
        self.folded = fold_fear_net(src, dtype)
        # the "gated" blend weight: sigmoid of the float32 parameter, then
        # cast, as in JAX (the model copy below is cast to ``dtype`` whole)
        with torch.no_grad():
            self._template_gate = torch.sigmoid(src.template_gate.float()).to(dtype)
        self.template_shape = (
            config.template_size // src.encoder.stride,
            config.template_size // src.encoder.stride,
            self.folded["neck"]["w"].shape[-1],
        )
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

    def _refresh(self, state: StreamState, frames, bbox, res, apce):
        """Dual-template refresh: (new dyn_feats, gate observables (S, N_OBS)).
        The candidate is encoded for every stream and the threshold applied
        per stream with ``torch.where``, so nothing waits for the card."""
        dyn = state.dyn_feats
        cand = self._template_features(frames, bbox, state.mean_color)
        obs = gate_observables(res.confidence, apce, cand, state.template_feats, dyn, bbox, state.bbox)
        if self.update_mode == "feature":
            r = (gate_rate(self._gate, obs) * self.update_rate)[:, None, None, None].to(dyn.dtype)
            return (1.0 - r) * dyn + r * cand, obs
        ok = (res.confidence > self.update_threshold)[:, None, None, None]
        if self.update_mode == "gated":
            g = self._template_gate
            blended = (1.0 - g) * state.template_feats + g * cand
        else:
            blended = (1.0 - self.update_rate) * dyn + self.update_rate * cand
        return torch.where(ok, blended, dyn), obs

    # -- public API --------------------------------------------------------

    @full_float32
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
            dyn_feats=feats,
            bbox=bboxes,
            mean_color=mean_color,
            confidence=torch.ones(frames.shape[0], dtype=torch.float32, device=self.device),
        )

    @full_float32
    @torch.inference_mode()
    def step(self, state: StreamState, frames, step_index: Optional[int] = None
             ) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
        """One frame for every stream: (S, H, W, 3), or (H, W, 3) shared.

        ``step_index`` (a Python int, the running frame count) paces the
        dual-template ``update_interval``; None = refresh-eligible on this
        frame. Nothing here waits for the card."""
        cfg = self.config
        frames = self._broadcast_shared(self._to_device(frames), state.bbox.shape[0])
        H, W = frames.shape[1], frames.shape[2]

        if self.recover_context:
            # per-stream context: widen the window after a low-confidence frame
            ctx = torch.where(state.confidence < self.recover_threshold,
                              self.recover_context, cfg.search_context)
        else:
            ctx = cfg.search_context
        windows = extended_crop_window(state.bbox, ctx)
        crops = self._crop(frames, windows, cfg.instance_size, state.mean_color)
        search = self._features(normalize_imagenet(crops))
        update = state.dyn_feats if self.dynamic_template else None
        out = self.model.connector(state.template_feats, search, update)
        cls = out[TARGET_CLASSIFICATION_KEY].float().contiguous()
        reg = out[TARGET_REGRESSION_LABEL_KEY].float().contiguous()

        prev_size = crop_bbox_in_window(state.bbox, windows, cfg.instance_size)[:, 2:].contiguous()
        res = postprocess_cuda(cls, reg, cfg.postprocess, prev_size=prev_size)
        bbox = clamp_bbox(rescale_crop_bbox(res.bbox, windows, cfg.instance_size), (H, W))
        # per-frame map-sharpness diagnostic
        apce = pp.apce(torch.sigmoid(cls[..., 0]))

        dyn, gate_obs = state.dyn_feats, None
        if self.dynamic_template:
            # the cadence is a host-side integer test (JAX: lax.cond)
            if step_index is None or step_index % self.update_interval == 0:
                dyn, gate_obs = self._refresh(state, frames, bbox, res, apce)
            else:
                gate_obs = torch.zeros((bbox.shape[0], N_OBS), dtype=torch.float32, device=self.device)

        new_state = StreamState(
            template_feats=state.template_feats,
            dyn_feats=dyn,
            bbox=bbox,
            mean_color=state.mean_color,
            confidence=res.confidence,
        )
        outputs = {
            "bbox": bbox,
            "confidence": res.confidence,
            "apce": apce,
            "failure": res.confidence < cfg.confidence_threshold,
        }
        if gate_obs is not None:
            outputs["gate_obs"] = gate_obs
        return new_state, outputs

    def track(self, state: StreamState, frames, start_step: int = 0
              ) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
        """A chunk of frames (T, S, H, W, 3) — or (T, H, W, 3) shared by all
        streams — tracked frame by frame → (state, outputs stacked over T).

        ``start_step``: the global index of the chunk's first frame, which
        keeps the ``update_interval`` cadence steady across chunks."""
        frames = self._to_device(frames)
        per_frame = []
        for t in range(frames.shape[0]):
            state, out = self.step(state, frames[t], step_index=start_step + t)
            per_frame.append(out)
        stacked = {k: torch.stack([o[k] for o in per_frame]) for k in per_frame[0]}
        return state, stacked
