"""K2: the fused inverted-residual block as a CUDA kernel (``csrc/ir_block.cu``).

Replaces ``_block_kernel`` of ``feartracker_tpu/ops/pallas/ir_block.py``.
Bound on the H100 by memory traffic when done the plain way: the expanded
tensor (3-6x the block's width) would go to device memory and back twice.
The kernel keeps it in shared memory, one 8x8 output tile of one stream per
block, walking the expanded channels in chunks of 32; in bfloat16 the expand
and project products run on the tensor cores (see the source's header).
For CPU tensors :func:`fused_ir_block` runs the plain twin
:func:`feartracker_tpu_torch.ops.fused_trunk.plain_ir_block`; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from feartracker_tpu_torch.models.fbnet import IRBlockSpec
from feartracker_tpu_torch.ops.cuda.build import check_launch, load_library
from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block

MAX_SMEM_BYTES = 232448  # opt-in dynamic shared memory per block on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def fused_ir_block(
    x: torch.Tensor,
    blk: Dict[str, Any],
    spec: IRBlockSpec,
    relu_dw: bool = True,
    relu_out: bool = False,
) -> torch.Tensor:
    """One folded inverted-residual block: ``x`` (S, H, W, Cin) NHWC,
    float32 or bfloat16 → (S, H/stride, W/stride, Cout) in x's dtype.
    ``blk`` comes from ``fold_fear_net`` with ``dtype=x.dtype``."""
    if x.device.type == "cpu":
        return plain_ir_block(x, blk, spec, relu_dw, relu_out)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ir_block: unsupported device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"fused_ir_block: need (S,H,W,C) float32/bfloat16, got {x.dtype} {tuple(x.shape)}")
    S, H, W, Cin = x.shape
    k, s = spec.kernel, spec.stride
    if k not in (3, 5) or s not in (1, 2):
        raise ValueError(f"fused_ir_block: kernel {k} stride {s} not supported (k 3/5, stride 1/2)")
    if s == 2 and (H % 2 or W % 2):
        raise ValueError(f"fused_ir_block: stride 2 needs even H and W, got {H}x{W}")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    has_expand = blk["expand"] is not None
    Ce = blk["dw"]["w"].shape[-1]
    Cout = blk["project"]["w"].shape[-1]
    _check(x, "x", (S, H, W, Cin), dt, dev)
    if has_expand:
        _check(blk["expand"]["w"], "expand.w", (Cin, Ce), dt, dev)
        _check(blk["expand"]["b"], "expand.b", (Ce,), f32, dev)
    elif Ce != Cin:
        raise ValueError(f"fused_ir_block: no expand needs Ce == Cin, got {Ce} != {Cin}")
    _check(blk["dw"]["w"], "dw.w", (k, k, Ce), f32, dev)
    _check(blk["dw"]["b"], "dw.b", (Ce,), f32, dev)
    _check(blk["project"]["w"], "project.w", (Ce, Cout), dt, dev)
    _check(blk["project"]["b"], "project.b", (Cout,), f32, dev)

    lib = load_library()
    smem = lib.fear_ir_block_smem_bytes(k, s, Cin, Cout, _DTYPES[dt])
    if not 0 <= smem <= MAX_SMEM_BYTES:
        raise ValueError(f"fused_ir_block: Cin={Cin}, Cout={Cout} at k{k} s{s} {dt} does not fit "
                         f"the kernel ({smem} bytes of shared memory, at most {MAX_SMEM_BYTES}; "
                         f"bfloat16 takes Cout <= 224)")
    residual = s == 1 and Cin == Cout
    out = torch.empty((S, H // s, W // s, Cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fear_ir_block(
            x.data_ptr(),
            blk["expand"]["w"].data_ptr() if has_expand else None,
            blk["expand"]["b"].data_ptr() if has_expand else None,
            blk["dw"]["w"].data_ptr(), blk["dw"]["b"].data_ptr(),
            blk["project"]["w"].data_ptr(), blk["project"]["b"].data_ptr(), out.data_ptr(),
            S, H, W, Cin, Ce, Cout, k, s,
            int(has_expand), int(relu_dw), int(relu_out), int(residual), _DTYPES[dt], stream,
        )
    check_launch(rc, "fear_ir_block")
    fused_ir_block.launches += 1
    return out


fused_ir_block.launches = 0
