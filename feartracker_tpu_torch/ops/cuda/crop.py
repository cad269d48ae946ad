"""K3: the tracking step's crop as one CUDA kernel (``csrc/crop.cu``).

For all S streams in one launch: the bilinear ``out_size``² crop of each
stream's window from its whole frame (uint8 or float32, at its strides: a
frame shared by every stream may be expanded with stream stride 0), the
stream's pad colour where a tap falls outside the frame, ImageNet
normalization, and the write in the trunk's dtype (float32 or bfloat16). It
replaces ``crop_resize_mm``'s dense operators, whole-frame cast and
contractions, and the normalize and cast after them, on ``ScanTracker``'s
default route (``crop_impl="kernel"``). Bound on the H100 by bytes: ≤ 150
MB at S=128, 256², bf16.

:func:`crop_cuda` launches the kernel for CUDA tensors and raises where it
cannot, and runs the plain twin :func:`crop_plain` for CPU tensors; on the
card the kernel's float32 output equals the twin's bit for bit, its bfloat16
output the twin's float32 result rounded once. Launches count in
``crop_cuda.launches``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from feartracker_tpu_torch.ops.crop import _imagenet_stats, crop_resize, normalize_imagenet
from feartracker_tpu_torch.ops.cuda.build import check_launch, load_library

FRAME_DTYPES = (torch.uint8, torch.float32)
OUT_DTYPES = (torch.float32, torch.bfloat16)


def crop_plain(frames: torch.Tensor, windows: torch.Tensor, out_size: int, pad_value: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The plain twin of :func:`crop_cuda`, in the kernel's order: the
    gather crop, ImageNet normalization, then one cast to ``dtype``."""
    return normalize_imagenet(crop_resize(frames, windows, out_size, pad_value)).to(dtype)


@lru_cache(maxsize=1)
def _stats():
    """ImageNet mean and std × 255 as the float32 values that
    ``normalize_imagenet`` subtracts and divides by, for the launch."""
    return tuple(torch.cat(_imagenet_stats(torch.device("cpu"))).tolist())


def _check(frames: torch.Tensor, windows: torch.Tensor, pad_value: torch.Tensor, dtype: torch.dtype):
    """Check the inputs for the kernel → (windows, pad), float32 contiguous."""
    if frames.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {frames.device}")
    if frames.dim() != 4 or frames.shape[-1] != 3 or frames.dtype not in FRAME_DTYPES:
        raise ValueError(f"K3: frames need (S, H, W, 3) uint8 or float32, got {frames.dtype} {tuple(frames.shape)}")
    if dtype not in OUT_DTYPES:
        raise ValueError(f"K3: the output dtype must be float32 or bfloat16, got {dtype}")
    S, dev = frames.shape[0], frames.device
    for name, t, width in (("windows", windows, 4), ("pad_value", pad_value, 3)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (S, width):
            raise ValueError(f"K3: {name} needs float32 {(S, width)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    # (S, 4) and (S, 3) rows: a no-op on the tracker's tensors
    return windows.contiguous(), pad_value.contiguous()


def _launch(frames: torch.Tensor, windows: torch.Tensor, out_size: int, pad: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """One K3 launch into a new (S, out_size, out_size, 3) ``dtype`` tensor."""
    S, H, W, _ = frames.shape
    dev = frames.device
    out = torch.empty((S, out_size, out_size, 3), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load_library().fear_crop(
            frames.data_ptr(), int(frames.dtype == torch.uint8), *frames.stride(), windows.data_ptr(),
            pad.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16), S, H, W, out_size, *_stats(), stream,
        )
    check_launch(rc, "fear_crop")
    crop_cuda.launches += 1
    return out


def crop_cuda(frames: torch.Tensor, windows: torch.Tensor, out_size: int, pad_value: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The normalized ``out_size``² crops the trunk takes, in one launch:
    ``frames`` (S, H, W, 3) uint8 or float32 at any strides, ``windows``
    (S, 4) float32 integer-valued xywh (may extend past the frame),
    ``pad_value`` (S, 3) float32 → (S, out_size, out_size, 3) contiguous
    ``dtype``. Same result as :func:`crop_plain`."""
    if frames.device.type == "cpu":
        return crop_plain(frames, windows, out_size, pad_value, dtype)
    windows, pad = _check(frames, windows, pad_value, dtype)
    return _launch(frames, windows, out_size, pad, dtype)


crop_cuda.launches = 0
