"""K1: the fused decode as a CUDA kernel (``csrc/decode.cu``).

Replaces ``_decode_kernel`` of ``feartracker_tpu/ops/pallas/decode.py``.
Bound on the H100 by launch latency, not by bytes or operations (~650 KB at
S=128): one warp per stream does the whole decode in one launch, where the
plain twin (:func:`feartracker_tpu_torch.core.postprocess.postprocess`) runs
a dozen small kernels. For CPU tensors :func:`postprocess_cuda` runs that
plain twin; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from feartracker_tpu_torch.core import postprocess as pp
from feartracker_tpu_torch.core.grids import make_grid_np
from feartracker_tpu_torch.ops.cuda.build import check_launch, load_library


@lru_cache(maxsize=8)
def _tables(cfg: pp.PostprocessConfig, device: torch.device):
    """(window, grid_x, grid_y), (H, W) float32 on ``device``, built once."""
    gx, gy = make_grid_np(cfg.score_size, cfg.total_stride, cfg.instance_size)
    win = pp._window_np(cfg.windowing, cfg.score_size)
    return tuple(torch.from_numpy(a).to(device) for a in (win, gx, gy))


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def postprocess_cuda(
    cls_logits: torch.Tensor,
    regression_map: torch.Tensor,
    cfg: pp.PostprocessConfig,
    prev_size: Optional[torch.Tensor] = None,
) -> pp.PostprocessResult:
    """Fused decode: ``cls_logits`` (S, H, W[, 1]) and ``regression_map``
    (S, H, W, 4) float32, ``prev_size`` (S, 2) (used when ``cfg.smooth``).
    Same result as ``pp.postprocess``."""
    if cls_logits.device.type == "cpu":
        return pp.postprocess(cls_logits, regression_map, cfg, prev_size)
    if cls_logits.device.type != "cuda":
        raise ValueError(f"postprocess_cuda: unsupported device {cls_logits.device}")
    if cls_logits.dim() == 4:
        cls_logits = cls_logits[..., 0]
    S, H, W = cls_logits.shape
    dev = cls_logits.device
    if H != cfg.score_size or W != cfg.score_size or H * W > 256:
        raise ValueError(f"postprocess_cuda: score map {H}x{W} does not fit "
                         f"score_size={cfg.score_size} (at most 256 cells)")
    if prev_size is None:
        prev_size = torch.ones((S, 2), dtype=torch.float32, device=dev)
    _check(cls_logits, "cls_logits", (S, H, W), dev)
    _check(regression_map, "regression_map", (S, H, W, 4), dev)
    _check(prev_size, "prev_size", (S, 2), dev)
    if regression_map.data_ptr() % 16:
        raise ValueError("regression_map: the kernel reads float4, need 16-byte alignment")

    win, gx, gy = _tables(cfg, dev)
    bbox = torch.empty((S, 4), dtype=torch.float32, device=dev)
    conf = torch.empty((S,), dtype=torch.float32, device=dev)
    coords = torch.empty((S, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load_library().fear_decode(
            cls_logits.data_ptr(), regression_map.data_ptr(), prev_size.data_ptr(),
            win.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            bbox.data_ptr(), conf.data_ptr(), coords.data_ptr(),
            S, H, W, int(cfg.smooth), cfg.penalty_k, cfg.window_influence, cfg.lr, stream,
        )
    check_launch(rc, "fear_decode")
    postprocess_cuda.launches += 1
    return pp.PostprocessResult(bbox=bbox, confidence=conf, pred_coords=coords)


postprocess_cuda.launches = 0
