"""Multi-stream tracking runtime, the counterpart of
``feartracker_tpu/tracker/runtime.py``.

For S independent streams and a chunk of T uint8 frames, each frame runs
crop + normalize (by default one kernel, K3, that writes the trunk's dtype)
→ trunk + neck (by default the folded trunk with the fused
inverted-residual kernel; ``trunk_impl="xla"`` runs the model's own
unfolded ``get_features``) → BoxTower head against the cached template →
the decode region (fused decode, rescale, clamp and APCE in one kernel),
and carries the per-stream state. ``lax.scan`` becomes a Python loop over
T; nothing in the loop waits for the device, so frames queue back to back.
With ``dynamic_template`` a refresh frame also crops and encodes a candidate
template at the new box (the 128² crop through the same trunk kernels) and
blends it into the dynamic template.

Which implementation runs is decided by the device alone: on CUDA the three
kernels (:mod:`feartracker_tpu_torch.ops.cuda`), on the CPU their plain
twins. Precision follows the JAX runtime: the model runs in ``dtype``;
crop, normalize, decode and geometry compute in float32 (the crop kernel
rounds its normalized float32 values to ``dtype`` once, as it writes them,
where JAX casts the normalized crop; the decode kernel widens the head's
bfloat16 outputs as it reads them). In float32 the card runs
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
from feartracker_tpu_torch.core.geometry import clamp_bbox
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.models.gate import (
    N_OBS,
    gate_observables,
    gate_params_to,
    gate_rate,
    load_gate,
)
from feartracker_tpu_torch.ops.crop import (
    crop_resize,
    crop_resize_mm,
    extended_crop_window,
    normalize_imagenet,
)
from feartracker_tpu_torch.ops.cuda.crop import crop_cuda
from feartracker_tpu_torch.ops.cuda.decode import decode_step_cuda, postprocess_cuda
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block, stream_tickets
from feartracker_tpu_torch.ops.fused_trunk import fold_fear_net, get_features_folded
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.utils import tracing
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


def _copy_tensors(dst, src, path: str) -> None:
    """Copy every tensor of the nested dicts/lists ``src`` into the tensor
    at the same place in ``dst``, in place; raises where the two differ in
    structure, shape or dtype (``copy_`` would broadcast or cast)."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"set_variables: {path} differs in shape or dtype")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError(f"set_variables: {path} differs in structure")
        for k in dst:
            _copy_tensors(dst[k], src[k], f"{path}.{k}")
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise ValueError(f"set_variables: {path} differs in structure")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_tensors(d, s, f"{path}.{i}")
    elif dst is not None or src is not None:
        raise ValueError(f"set_variables: {path} differs in structure")


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
      crop_impl: "kernel" (default): K3 (``ops/cuda/crop.py``), one launch
        for all streams that reads each output's bilinear taps from the
        frame, mixes in the pad colour, normalizes and writes the crop in
        ``dtype``; on the CPU its plain twin (the gather crop, normalize,
        cast). "mm": ``crop_resize_mm``, separable contractions with dense
        per-stream operators over the whole frame cast to float32; "gather":
        ``crop_resize`` on the frame cast to float32. "mm" and "gather" are
        the JAX runtime's two routes, normalized and cast after the crop.
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
      scan_unroll: K frames per unit of ``track`` (JAX: ``lax.scan``'s
        unroll). 1 runs ``step`` frame by frame. K > 1 on the card captures
        K consecutive steps into one CUDA graph and replays it over the
        chunk (see :class:`_Unrolled`); on the CPU the same K-step units run
        eagerly, as graphs exist only on the card. Results do not depend on
        K. ``step`` (one frame) always runs eagerly.
      trunk_impl: "fused" (default): the trunk and neck folded with their
        BatchNorms (``fold_fear_net``), every block with expansion > 1 in
        the fused kernel (K2); "xla": the model's own ``get_features`` in
        ``dtype``, the unfolded convolutions (cuDNN on the card) with
        eval-mode BatchNorm, and no K2 launch (JAX's default, and its
        yardstick for the kernel). Both run K1.
    """

    def __init__(
        self,
        model: FEARNet,
        config: TrackerConfig = TrackerConfig(),
        dtype: torch.dtype = torch.float32,
        device="cuda",
        crop_impl: str = "kernel",
        dynamic_template: bool = False,
        update_threshold: float = 0.85,
        update_rate: float = 0.1,
        update_mode: str = "ema",
        gate_params=None,
        update_interval: int = 1,
        recover_context: float = 0.0,
        recover_threshold: Optional[float] = None,
        scan_unroll: int = 1,
        trunk_impl: str = "fused",
    ):
        if trunk_impl not in ("xla", "fused"):
            raise ValueError(f"trunk_impl must be 'xla' or 'fused', got {trunk_impl!r}")
        if crop_impl not in ("kernel", "mm", "gather"):
            raise ValueError(f"crop_impl must be 'kernel', 'mm' or 'gather', got {crop_impl!r}")
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
        self.scan_unroll = int(scan_unroll)
        self._unrolled: Dict[tuple, _Unrolled] = {}
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # kernel launches made by graph replays (the wrappers' own counters
        # count eager launches, and the kernels recorded at capture, which
        # run nothing)
        self.replayed_launches = {"K1": 0, "K2": 0, "K3": 0}
        self.crop_impl = crop_impl
        self.trunk_impl = trunk_impl
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
        # fold only for the fused trunk, as JAX does; "xla" reads self.model
        self.folded = fold_fear_net(src, dtype) if trunk_impl == "fused" else None
        # the "gated" blend weight: sigmoid of the float32 parameter, then
        # cast, as in JAX (the model copy below is cast to ``dtype`` whole)
        with torch.no_grad():
            self._template_gate = torch.sigmoid(src.template_gate.float()).to(dtype)
        self.template_shape = (
            config.template_size // src.encoder.stride,
            config.template_size // src.encoder.stride,
            src.neck.downsample.conv.out_channels,
        )
        self.model = src.to(dtype)

    @torch.inference_mode()
    def set_variables(self, model: FEARNet) -> None:
        """Take another loaded model of the same architecture (JAX:
        ``set_variables``, no recompile): its folded trunk and neck (with
        K2's packed bf16 weights; the fused trunk only), the model's copy in
        ``dtype`` (the head, and the xla trunk) and the
        "gated" blend weight are copied *into* the tensors the tracker holds.
        The storage stays where it was, so CUDA graphs captured under
        ``scan_unroll`` read the new weights at their next replay. Carried
        ``StreamState``\\ s are the caller's: their templates were encoded
        with the old weights. ``model`` itself is not changed."""
        src = copy.deepcopy(model).float().eval().to(self.device)
        if tuple(src.trunk_blocks) != tuple(self.specs):
            raise ValueError("set_variables: the model's trunk differs from the tracker's")
        if self.folded is not None:
            _copy_tensors(self.folded, fold_fear_net(src, self.dtype), "folded")
        self._template_gate.copy_(torch.sigmoid(src.template_gate.float()).to(self.dtype))
        _copy_tensors(self.model.state_dict(), src.to(self.dtype).state_dict(), "model")

    # -- building blocks ---------------------------------------------------

    def _crop(self, frames: torch.Tensor, windows: torch.Tensor, out_size: int,
              mean_color: torch.Tensor) -> torch.Tensor:
        """The normalized crops the trunk takes, (S, out_size, out_size, 3):
        K3's in ``dtype``, or the JAX routes' in float32."""
        if self.crop_impl == "kernel":
            return crop_cuda(frames, windows, out_size, mean_color, self.dtype)
        if self.crop_impl == "mm":
            return normalize_imagenet(crop_resize_mm(frames, windows, out_size, mean_color))
        return normalize_imagenet(crop_resize(frames.float(), windows, out_size, mean_color))

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous()
        if self.folded is None:
            return self.model.get_features(x)
        return get_features_folded(x, self.folded, self.specs)

    def _template_features(self, frames, bboxes, mean_color) -> torch.Tensor:
        cfg = self.config
        windows = extended_crop_window(bboxes, cfg.template_bbox_offset)
        return self._features(self._crop(frames, windows, cfg.template_size, mean_color))

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
        with tracing.span("fear.step"):
            return self._step(state, frames, step_index)

    def _step(self, state: StreamState, frames, step_index: Optional[int]):
        # each layer a span, and inside a graph capture a mark, so that every
        # kernel of a replay follows its layer's mark (utils/tracing.py)
        cfg = self.config
        with tracing.layer("fear.crop"):
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
        with tracing.layer("fear.trunk"):
            search = self._features(crops)
        with tracing.layer("fear.head"):
            update = state.dyn_feats if self.dynamic_template else None
            out = self.model.connector(state.template_feats, search, update)
        with tracing.layer("fear.decode"):
            # K1, one launch: the head's outputs in their own dtype → decode,
            # frame-space box, per-frame map-sharpness diagnostic (APCE)
            res, bbox, apce = decode_step_cuda(out[TARGET_CLASSIFICATION_KEY], out[TARGET_REGRESSION_LABEL_KEY],
                                               cfg.postprocess, state.bbox, windows, (H, W))

        dyn, gate_obs = state.dyn_feats, None
        # the dual template's cadence is a host-side integer test (JAX: lax.cond)
        refresh = self.dynamic_template and (step_index is None or step_index % self.update_interval == 0)
        if refresh:
            with tracing.layer("fear.refresh"):
                if tracing.enabled() and not tracing.capturing():
                    # a graph's refreshes are counted at its replays (_Unrolled.run)
                    tracing.count("step.refreshes")
                dyn, gate_obs = self._refresh(state, frames, bbox, res, apce)

        with tracing.layer("fear.state"):
            if self.dynamic_template and not refresh:
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
        keeps the ``update_interval`` cadence steady across chunks. With
        ``scan_unroll`` K > 1 the chunk runs in units of K frames (a CUDA
        graph each on the card) and the last T mod K frames run eagerly,
        frame by frame. Returned tensors never alias a graph's memory."""
        with tracing.span("fear.track"):
            if self.scan_unroll > 1:
                state, stacked = self._track_unrolled(state, frames, start_step)
            else:
                frames = self._to_device(frames)
                per_frame = []
                for t in range(frames.shape[0]):
                    state, out = self.step(state, frames[t], step_index=start_step + t)
                    per_frame.append(out)
                stacked = {k: torch.stack([o[k] for o in per_frame]) for k in per_frame[0]}
        return state, stacked

    # -- scan_unroll > 1 -----------------------------------------------------

    def _graph_stream(self) -> torch.cuda.Stream:
        """The tracker's own stream, on which every unit captures and replays."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        return self._capture_stream

    @full_float32
    @torch.inference_mode()
    def _track_unrolled(self, state: StreamState, frames, start_step: int):
        K, S = self.scan_unroll, state.bbox.shape[0]
        frames = torch.as_tensor(frames)
        if frames.dim() == 5 and frames.stride(1) == 0:
            frames = frames[:, 0]  # one video expanded over S: keep it stored once
        frames = self._to_device(frames)
        T = frames.shape[0]
        full = T - T % K
        out: Dict[str, torch.Tensor] = {}

        def write(t, got, stacked):
            for k, v in got.items():
                if k not in out:
                    out[k] = v.new_empty((T,) + (v.shape[1:] if stacked else v.shape))
                out[k][t].copy_(v)

        for t0 in range(0, full, K):
            # the dual template's cadence is baked into a unit's steps
            phase = (start_step + t0) % self.update_interval if self.dynamic_template else 0
            # a traced unit is captured with its layer marks, apart from the unmarked one
            traced = tracing.enabled()
            key = (S, tuple(frames.shape[1:]), frames.dtype, traced, phase)
            unit = self._unrolled.get(key)
            if unit is None:
                # the other flag's units go, and their graphs' memory with them
                for other in [k for k in self._unrolled if k[3] != traced]:
                    del self._unrolled[other]
                with tracing.span("fear.graph.capture"):
                    unit = self._unrolled[key] = _Unrolled(self, state, frames[t0:t0 + K], phase)
            state, got = unit.run(state, frames[t0:t0 + K])
            write(slice(t0, t0 + K), got, True)
        for t in range(full, T):
            state, got = self.step(state, frames[t], step_index=start_step + t)
            write(t, got, False)
        return state, out


class _Unrolled:
    """K consecutive :meth:`ScanTracker.step` calls over static buffers, the
    counterpart of the body of JAX's ``lax.scan(..., unroll=K)``.

    On the card the K steps are captured into one CUDA graph at construction
    and replayed by every :meth:`run` of K frames that shares the unit's key.
    ``run`` copies the state and frames into the static input buffers,
    replays, and returns the new state copied out of graph memory (a replay
    overwrites it) and the stacked outputs, valid until the next ``run``. On
    the CPU ``run`` calls the same K steps on the same buffers eagerly.

    Capture rules, each against a fault it would otherwise hit:

    * Eager steps first. Device constants made at first use from host memory
      (``_tables`` in ``ops/cuda/decode.py``, ``_imagenet_stats`` in
      ``ops/crop.py``), cuBLAS's workspace for a new stream and the caching
      allocator's first blocks are illegal under capture, or would freeze a
      stale host buffer into the graph; K eager steps on the capture stream
      make them all, as torch's CUDA-graph notes prescribe.
    * One stream per tracker (:meth:`ScanTracker._graph_stream`) for every
      capture and replay. K2 float32's tickets are keyed by (device, stream)
      and made lazily with ``torch.zeros``; made first inside a capture they
      would live in that graph's private pool, zeroed only at its replay
      (so ``_tickets`` raises there). The eager steps on the capture stream
      make them at the size the captured launches need, and each unit holds
      the buffer its kernels captured (:func:`stream_tickets`), which a
      later unit's larger launch may replace in the cache.
    * The dual template's ``update_interval`` is a host branch in ``step``,
      baked in at capture: a unit serves the chunks whose first frame has
      its index mod ``update_interval`` (``phase``).
    * Frames shared by all streams stay one (K, H, W, 3) buffer, broadcast
      inside the graph.
    * The wrappers' ``launches`` counters go up at capture, where a kernel
      is recorded as a graph node and nothing runs: ``kernels`` holds those
      node counts. Each replay launches them, and adds them to
      ``tracker.replayed_launches``; the wrappers count eager launches only.
    * With tracing on (``utils/tracing.py``) each layer of each captured
      step begins with a ``fear_mark`` kernel, the only way a replay's
      kernels can be told apart by layer. The tracker keys its units by the
      tracing flag, so an unmarked unit never holds a mark, and keeps the
      units of one flag value at a time. A replay counts its unit's
      dual-template refreshes (``refreshes``), which its Python ran once, at
      capture.

    A failed capture or replay raises; nothing falls back to eager steps.
    """

    def __init__(self, tracker: ScanTracker, state: StreamState, frames: torch.Tensor, phase: int):
        self.tracker = tracker
        self.K = frames.shape[0]
        self.phase = phase
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tickets: Optional[torch.Tensor] = None
        self.kernels = {"K1": 0, "K2": 0, "K3": 0}
        self.refreshes = sum(tracker.dynamic_template and (phase + k) % tracker.update_interval == 0
                             for k in range(self.K))
        dev = tracker.device
        if dev.type != "cuda":
            self.state_in = StreamState(*(t.clone() for t in state))
            self.frames = frames.clone()
            return
        stream = tracker._graph_stream()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.state_in = StreamState(*(t.clone() for t in state))
            self.frames = frames.clone()
            self._body()  # warm-up
            # keyed by the tensors' device ("cuda:0"), as the launches look it up
            self.tickets = stream_tickets(self.frames.device, stream.cuda_stream)
            self.graph = torch.cuda.CUDAGraph()
            before = (postprocess_cuda.launches, fused_ir_block.launches, crop_cuda.launches)
            with torch.cuda.graph(self.graph, stream=stream):
                self.state_out, self.outputs = self._body()
            tracing.count("graph.captures")
            self.kernels = {"K1": postprocess_cuda.launches - before[0],
                            "K2": fused_ir_block.launches - before[1],
                            "K3": crop_cuda.launches - before[2]}
        torch.cuda.current_stream(dev).wait_stream(stream)

    def _body(self):
        state, per_frame = self.state_in, []
        for k in range(self.K):
            state, out = self.tracker.step(state, self.frames[k], step_index=self.phase + k)
            per_frame.append(out)
        return state, {key: torch.stack([o[key] for o in per_frame]) for key in per_frame[0]}

    def run(self, state: StreamState, frames: torch.Tensor):
        with tracing.span("fear.graph.copy_in"):
            for buf, src in zip(self.state_in, state):
                buf.copy_(src)
            self.frames.copy_(frames)
        if tracing.enabled():
            tracing.count("graph.copy_in_bytes", frames.nbytes + sum(t.nbytes for t in state))
        with tracing.span("fear.graph.replay"):
            if self.graph is None:
                state_out, outputs = self._body()
            else:
                dev, stream = self.tracker.device, self.tracker._graph_stream()
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    self.graph.replay()
                torch.cuda.current_stream(dev).wait_stream(stream)
                state_out, outputs = self.state_out, self.outputs
                for k, n in self.kernels.items():
                    self.tracker.replayed_launches[k] += n
                tracing.count("step.refreshes", self.refreshes)
        # a field that passed through unchanged is the caller's own tensor
        new_state = StreamState(*(src if out is buf else out.clone()
                                  for src, buf, out in zip(state, self.state_in, state_out)))
        return new_state, outputs
