"""K1: the decode region of a tracking step as one CUDA kernel (``csrc/decode.cu``).

Replaces ``_decode_kernel`` of ``feartracker_tpu/ops/pallas/decode.py`` and,
in the batched step, the torch ops around it. Bound on the H100 by launch
latency, not by bytes (~340 KB at S=128 in bfloat16): one block per stream
and one thread per score cell do in one launch what the step ran as about 67
(the decode kernel and ≈66 small torch kernels around it).

Two entry points launch the same kernel and count in
``postprocess_cuda.launches``:

* :func:`decode_step_cuda`, the batched step's region: from the head's
  outputs, the stream boxes and the search windows to the crop-space decode,
  the frame-space box and the APCE;
* :func:`postprocess_cuda`, the decode alone (the sequential tracker, whose
  geometry is host numpy).

Both read ``cls`` and ``reg`` in the head's own dtype (float32 or bfloat16)
at their strides, and write one float32 and one int32 buffer per call, of
which the results are views. For CPU tensors they run their plain twins;
for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from feartracker_tpu_torch.core import postprocess as pp
from feartracker_tpu_torch.core.geometry import clamp_bbox, rescale_crop_bbox
from feartracker_tpu_torch.core.grids import make_grid_np
from feartracker_tpu_torch.ops.crop import crop_bbox_in_window
from feartracker_tpu_torch.ops.cuda.build import check_launch, load_library

MIN_SIDE = 3.0  # clamp_bbox's and rescale_crop_bbox's default


class DecodeStep(NamedTuple):
    result: pp.PostprocessResult  # crop-space bbox, confidence, coords
    bbox: torch.Tensor  # (S, 4) frame-space xywh, rescaled and clamped
    apce: torch.Tensor  # (S,) APCE of the sigmoid score map


@lru_cache(maxsize=8)
def _tables(cfg: pp.PostprocessConfig, device: torch.device):
    """(window, grid_x, grid_y), (H, W) float32 on ``device``, built once."""
    gx, gy = make_grid_np(cfg.score_size, cfg.total_stride, cfg.instance_size)
    win = pp._window_np(cfg.windowing, cfg.score_size)
    return tuple(torch.from_numpy(a).to(device) for a in (win, gx, gy))


def _head_maps(cls_logits: torch.Tensor, regression_map: torch.Tensor, cfg: pp.PostprocessConfig):
    """Check the head's outputs for the kernel → (cls (S, H, W), reg, dev)."""
    if cls_logits.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {cls_logits.device}")
    if cls_logits.dim() == 4:
        cls_logits = cls_logits[..., 0]
    S, H, W = cls_logits.shape
    dev = cls_logits.device
    if H != cfg.score_size or W != cfg.score_size or H * W > 256:
        raise ValueError(f"K1: score map {H}x{W} does not fit score_size={cfg.score_size} (at most 256 cells)")
    if cls_logits.dtype not in (torch.float32, torch.bfloat16) or regression_map.dtype != cls_logits.dtype:
        raise ValueError(f"K1: need cls and reg both float32 or both bfloat16, got {cls_logits.dtype} and "
                         f"{regression_map.dtype}")
    if regression_map.device != dev or tuple(regression_map.shape) != (S, H, W, 4):
        raise ValueError(f"K1: regression_map {tuple(regression_map.shape)} on {regression_map.device}, "
                         f"need {(S, H, W, 4)} on {dev}")
    return cls_logits, regression_map, dev


def _f32(t: torch.Tensor, name: str, shape, dev) -> torch.Tensor:
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"K1: {name} needs float32 {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()  # (S, 2) and (S, 4) rows: a no-op on the tracker's tensors


def _launch(cls, reg, cfg, dev, prev=None, state=None, windows=None, frame_hw=(0, 0)):
    """One K1 launch → (float32 buffer, int32 coords (S, 2)). The float32
    buffer holds, in this order, [frame box (S, 4) | crop box (S, 4) |
    confidence (S,) | APCE (S,)] in step mode (``windows`` given), else
    [crop box (S, 4) | confidence (S,)]."""
    S, H, W = cls.shape
    step = windows is not None
    out = torch.empty((10 if step else 5) * S, dtype=torch.float32, device=dev)
    coords = torch.empty((S, 2), dtype=torch.int32, device=dev)
    frame, bbox = (out[:4 * S], out[4 * S:8 * S]) if step else (None, out[:4 * S])
    conf = out[8 * S:9 * S] if step else out[4 * S:]
    apce = out[9 * S:] if step else None
    win, gx, gy = _tables(cfg, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load_library().fear_decode(
            cls.data_ptr(), reg.data_ptr(), int(cls.dtype == torch.bfloat16), *cls.stride(), *reg.stride(),
            ptr(prev), ptr(state), ptr(windows), win.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            bbox.data_ptr(), conf.data_ptr(), coords.data_ptr(), ptr(frame), ptr(apce),
            S, H, W, int(cfg.smooth), cfg.penalty_k, 1.0 - cfg.window_influence, cfg.window_influence,
            cfg.lr, float(cfg.instance_size), float(frame_hw[0]), float(frame_hw[1]), MIN_SIDE, stream,
        )
    check_launch(rc, "fear_decode")
    postprocess_cuda.launches += 1
    return out, coords


def decode_step_plain(
    cls_logits: torch.Tensor,
    regression_map: torch.Tensor,
    cfg: pp.PostprocessConfig,
    state_bbox: torch.Tensor,
    windows: torch.Tensor,
    frame_hw: Tuple[int, int],
) -> DecodeStep:
    """The plain twin of :func:`decode_step_cuda`: the batched step's decode
    region as torch ops, in the order the step ran them before K1 took it."""
    cls_logits, regression_map = cls_logits.float(), regression_map.float()
    prev_size = crop_bbox_in_window(state_bbox, windows, cfg.instance_size)[:, 2:]
    res = pp.postprocess(cls_logits, regression_map, cfg, prev_size=prev_size)
    bbox = clamp_bbox(rescale_crop_bbox(res.bbox, windows, cfg.instance_size, MIN_SIDE), frame_hw, MIN_SIDE)
    score = cls_logits[..., 0] if cls_logits.dim() == 4 else cls_logits
    return DecodeStep(res, bbox, pp.apce(torch.sigmoid(score)))


def decode_step_cuda(
    cls_logits: torch.Tensor,
    regression_map: torch.Tensor,
    cfg: pp.PostprocessConfig,
    state_bbox: torch.Tensor,
    windows: torch.Tensor,
    frame_hw: Tuple[int, int],
) -> DecodeStep:
    """The batched step's decode region in one launch: ``cls_logits`` (S, H,
    W[, 1]) and ``regression_map`` (S, H, W, 4) as the head emits them
    (float32 or bfloat16, any strides), ``state_bbox`` (S, 4) the streams'
    frame-space boxes, ``windows`` (S, 4) their search windows, ``frame_hw``
    the frame's (H, W). Same result as :func:`decode_step_plain`."""
    if cls_logits.device.type == "cpu":
        return decode_step_plain(cls_logits, regression_map, cfg, state_bbox, windows, frame_hw)
    cls, reg, dev = _head_maps(cls_logits, regression_map, cfg)
    S = cls.shape[0]
    state = _f32(state_bbox, "state_bbox", (S, 4), dev)
    windows = _f32(windows, "windows", (S, 4), dev)
    out, coords = _launch(cls, reg, cfg, dev, state=state, windows=windows, frame_hw=frame_hw)
    res = pp.PostprocessResult(bbox=out[4 * S:8 * S].view(S, 4), confidence=out[8 * S:9 * S], pred_coords=coords)
    return DecodeStep(res, out[:4 * S].view(S, 4), out[9 * S:])


def postprocess_cuda(
    cls_logits: torch.Tensor,
    regression_map: torch.Tensor,
    cfg: pp.PostprocessConfig,
    prev_size: Optional[torch.Tensor] = None,
) -> pp.PostprocessResult:
    """Fused decode: ``cls_logits`` (S, H, W[, 1]) and ``regression_map``
    (S, H, W, 4), float32 or bfloat16, ``prev_size`` (S, 2) (used when
    ``cfg.smooth``). Same result as ``pp.postprocess``; ``bbox`` and
    ``confidence`` view one buffer (:func:`box_and_confidence`)."""
    if cls_logits.device.type == "cpu":
        res = pp.postprocess(cls_logits, regression_map, cfg, prev_size)
        S = res.bbox.shape[0]
        out = torch.cat([res.bbox.reshape(-1), res.confidence])
        return pp.PostprocessResult(out[:4 * S].view(S, 4), out[4 * S:], res.pred_coords)
    cls, reg, dev = _head_maps(cls_logits, regression_map, cfg)
    S = cls.shape[0]
    prev = None
    if cfg.smooth:
        if prev_size is None:
            raise ValueError("smooth postprocess needs prev_size")
        prev = _f32(prev_size, "prev_size", (S, 2), dev)
    out, coords = _launch(cls, reg, cfg, dev, prev=prev)
    return pp.PostprocessResult(bbox=out[:4 * S].view(S, 4), confidence=out[4 * S:], pred_coords=coords)


postprocess_cuda.launches = 0


def box_and_confidence(res: pp.PostprocessResult) -> torch.Tensor:
    """The (5·S,) float32 buffer that ``res.bbox`` and ``res.confidence`` of
    :func:`postprocess_cuda` view: the S boxes, then the S confidences (at
    S=1: x, y, w, h, confidence), for one device-to-host copy."""
    S = res.bbox.shape[0]
    if not res.bbox.is_contiguous() or res.confidence.data_ptr() != res.bbox.data_ptr() + 16 * S:
        raise ValueError("box_and_confidence: bbox and confidence are not postprocess_cuda's one buffer")
    return res.bbox.as_strided((5 * S,), (1,))
