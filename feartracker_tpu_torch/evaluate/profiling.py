"""Profiling utilities: a ``torch.profiler`` trace and per-step wall timers,
the counterpart of ``feartracker_tpu/evaluate/profiling.py``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block (host, and the card's kernels
    when CUDA is available) and write ``<log_dir>/trace.json``, a Chrome
    trace (chrome://tracing, Perfetto). Yields the profiler, whose
    ``key_averages()`` sums time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling wall-time stats for a repeated step (host clock; on a card,
    end the timed block with ``torch.cuda.synchronize()``)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.time() - self._t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        d = np.asarray(self.samples)
        return {
            "mean_ms": float(d.mean() * 1e3),
            "p50_ms": float(np.percentile(d, 50) * 1e3),
            "p99_ms": float(np.percentile(d, 99) * 1e3),
            "steps_per_sec": float(1.0 / d.mean()),
        }
