"""Profiling utilities: a ``torch.profiler`` trace, the counterpart of
``feartracker_tpu/evaluate/profiling.py`` (its ``StepTimer`` is not ported:
``utils/tracing.py`` holds the port's spans and counters); the card's
device timer (:func:`time_ms`) and the H100's published peaks, with the
bound of one fused block (:func:`ir_block_bound`) priced against them."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

# the H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W): HBM
# bytes/s, bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block (host, and the card's kernels
    when CUDA is available) and write ``<log_dir>/trace.json``, a Chrome
    trace (chrome://tracing, Perfetto), with each op's input shapes
    (``tools/parse_trace.py`` reads them). Yields the profiler, whose
    ``key_averages()`` sums time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities, record_shapes=True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def spin_cycles_per_ms() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin, timed on the card."""
    if not hasattr(spin_cycles_per_ms, "value"):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(50_000_000)
        e1.record()
        torch.cuda.synchronize()
        spin_cycles_per_ms.value = 50_000_000 / e0.elapsed_time(e1)
    return spin_cycles_per_ms.value


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls that
    a spin kernel holds back until the host has queued them all, so that
    the host's cost per call leaves no gap between them on the card. Raises
    without a card: a host clock is no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms: no CUDA card; the device timer times the card only")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3  # host and device, an upper bound on the host's share
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_cycles_per_ms() * (1.5 * iters * call_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ir_block_bound(S: int, h: int, cin: int, spec, dtype: str = "bfloat16"):
    """(bound ms, its larger term, every term) of one fused block on x
    (S, h, h, cin) in ``dtype``: the block's input and output and its
    weights each moved once over the memory rate (activations and matmul
    weights 2 bytes in bfloat16, 4 in float32; biases and taps 4). bfloat16:
    the expand and project products over the tensor cores' rate and the
    depthwise over the CUDA cores' float32 rate, two units side by side;
    float32: every product an FMA on the CUDA cores, so the products and the
    depthwise add up ("fmas") over the float32 rate (no TF32)."""
    ce, k, ho, cout = cin * spec.expansion, spec.kernel, h // spec.stride, spec.out_channels
    itemsize = 4 if dtype == "float32" else 2
    nbytes = (S * (h * h * cin + ho * ho * cout) + ce * (cin + cout)) * itemsize + (k * k * ce + 2 * ce + cout) * 4
    products = 2 * S * (h * h * cin * ce + ho * ho * ce * cout)
    depthwise = 2 * S * ho * ho * ce * k * k
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    if dtype == "float32":
        terms["fmas"] = (products + depthwise) / F32_FLOPS * 1e3
    else:
        terms["products"] = products / BF16_FLOPS * 1e3
        terms["depthwise"] = depthwise / F32_FLOPS * 1e3
    by = max(terms, key=terms.get)
    return terms[by], by, terms
