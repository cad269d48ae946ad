"""FPS / endurance benchmark protocols, the counterpart of
``feartracker_tpu/evaluate/fps.py``:

  * ``fps_benchmark``     — 20 warmup + 100 timed calls;
  * ``online_benchmark``  — fixed input cadence (default 30 FPS) for a
    duration, with dropped-frame accounting;
  * ``pipelined_online_benchmark`` — the same cadence with up to ``depth``
    calls in flight (dispatch now, fetch later);
  * ``offline_benchmark`` — duration·fps calls back to back.

Each call's wall time, host RSS and device memory go to an optional CSV.
Device memory is ``torch.cuda.memory_allocated`` / ``max_memory_allocated``
of the CUDA device the caller names (``device``); a CPU device reads zeros.
The protocols time host wall clock around ``call`` + ``sync``: on a card,
``sync`` must wait for the device (e.g. ``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _device_memory_mb(device=None) -> Dict[str, float]:
    """Device memory in use and its peak (MiB) of ``device``: zeros unless
    it is a CUDA device."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return {"device_mem_mb": 0.0, "device_peak_mb": 0.0}
    return {
        "device_mem_mb": torch.cuda.memory_allocated(device) / 2**20,
        "device_peak_mb": torch.cuda.max_memory_allocated(device) / 2**20,
    }


class Telemetry:
    def __init__(self, csv_path: Optional[str] = None, mem_every: int = 0, device=None):
        self.rows: List[Dict[str, Any]] = []
        self.csv_path = csv_path
        # device memory is sampled once here, once in save() and, with
        # ``mem_every`` > 0, every Nth record after that call's duration was
        # taken, so the CSV carries a high-watermark trend without touching
        # the timed section. Rows between samples repeat the last sample.
        self.mem_every = int(mem_every)
        self.device = device
        self._device_mem = _device_memory_mb(device)

    def record(self, call_idx: int, duration_s: float) -> None:
        self.rows.append(
            {
                "call": call_idx,
                "duration_ms": duration_s * 1e3,
                "rss_mb": _rss_mb(),
                **self._device_mem,
                "timestamp": time.time(),
            }
        )
        if self.mem_every and (call_idx + 1) % self.mem_every == 0:
            self._device_mem = _device_memory_mb(self.device)

    def save(self) -> None:
        if not self.csv_path or not self.rows:
            return
        self.rows[-1].update(_device_memory_mb(self.device))
        os.makedirs(os.path.dirname(self.csv_path) or ".", exist_ok=True)
        with open(self.csv_path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(self.rows[0]))
            writer.writeheader()
            writer.writerows(self.rows)

    def summary(self) -> Dict[str, float]:
        """Endurance drift statistics over the recorded rows:

        * ``step_time_drift_pct`` — mean of the last decile of call
          durations vs the first decile, as a % change (a leak or thermal
          throttle shows up as positive drift);
        * ``rss_drift_mb`` — host RSS change first→last row;
        * ``hbm_high_watermark_mb`` — max sampled device peak (the card's
          HBM);
        * ``hbm_trend_mb`` — last sampled device peak minus first (0 for a
          steady-state loop; growth means a state leak).
        """
        if not self.rows:
            return {}
        d = np.asarray([r["duration_ms"] for r in self.rows])
        k = max(1, len(d) // 10)
        first, last = float(d[:k].mean()), float(d[-k:].mean())
        peaks = np.asarray([r.get("device_peak_mb", 0.0) for r in self.rows])
        return {
            "step_time_drift_pct": (last / first - 1.0) * 100.0 if first else 0.0,
            "rss_drift_mb": float(self.rows[-1]["rss_mb"] - self.rows[0]["rss_mb"]),
            "hbm_high_watermark_mb": float(peaks.max()),
            "hbm_trend_mb": float(peaks[-1] - peaks[0]),
        }


def fps_benchmark(
    call: Callable[[], Any],
    sync: Callable[[Any], None],
    warmup: int = 20,
    timed: int = 100,
    csv_path: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """20 warmup + 100 timed calls; returns mean/percentile latencies and FPS."""
    tele = Telemetry(csv_path, device=device)
    for _ in range(warmup):
        out = call()
    sync(out)
    durations = []
    for i in range(timed):
        t0 = time.time()
        out = call()
        sync(out)
        dt = time.time() - t0
        durations.append(dt)
        tele.record(i, dt)
    tele.save()
    d = np.asarray(durations)
    return {
        "mean_ms": float(d.mean() * 1e3),
        "p50_ms": float(np.percentile(d, 50) * 1e3),
        "p99_ms": float(np.percentile(d, 99) * 1e3),
        "fps": float(1.0 / d.mean()),
    }


def online_benchmark(
    call: Callable[[], Any],
    sync: Callable[[Any], None],
    duration_s: float = 30.0,
    input_fps: float = 30.0,
    csv_path: Optional[str] = None,
    mem_every: int = 256,
    device=None,
) -> Dict[str, float]:
    """Fixed-cadence serving: one call scheduled every 1/input_fps; a call
    that would start while the previous is still running counts as dropped
    (serial-queue semantics). ``mem_every`` samples device memory every
    Nth call (after its timing), giving the CSV a high-watermark trend."""
    tele = Telemetry(csv_path, mem_every=mem_every, device=device)
    period = 1.0 / input_fps
    start = time.time()
    completed = dropped = 0
    next_t = start
    while time.time() - start < duration_s:
        now = time.time()
        if now < next_t:
            time.sleep(next_t - now)
        t0 = time.time()
        out = call()
        sync(out)
        dt = time.time() - t0
        tele.record(completed, dt)
        completed += 1
        missed = int(dt // period)
        dropped += missed
        next_t += period * (1 + missed)
    tele.save()
    return {
        "completed": float(completed),
        "dropped": float(dropped),
        "drop_rate": float(dropped / max(completed + dropped, 1)),
        "duration_s": float(time.time() - start),
        **tele.summary(),
    }


def pipelined_online_benchmark(
    dispatch: Callable[[], Any],
    fetch: Callable[[Any], None],
    duration_s: float = 30.0,
    input_fps: float = 30.0,
    depth: int = 2,
    csv_path: Optional[str] = None,
    mem_every: int = 256,
    device=None,
) -> Dict[str, float]:
    """Fixed-cadence serving with a bounded in-flight pipeline.

    The serial protocol blocks on every call, so cadence is bounded by
    round-trip latency. Here ``dispatch`` only enqueues (e.g.
    ``StreamPool.step_async``) and ``fetch`` blocks on a prior call's
    outputs (``PendingStep.result``); up to ``depth`` calls
    ride in flight, hiding host↔device latency behind device compute. A tick
    that would exceed ``depth`` in-flight calls blocks on the oldest first;
    ticks missed while blocked count as dropped (same accounting as the
    serial protocol). Recorded latency per call = dispatch → fetch complete,
    pipeline queueing included.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    tele = Telemetry(csv_path, mem_every=mem_every, device=device)
    period = 1.0 / input_fps
    start = time.time()
    completed = dropped = 0
    latencies: List[float] = []
    inflight: List[Any] = []  # (dispatch_time, handle), oldest first
    next_t = start
    while time.time() - start < duration_s:
        now = time.time()
        if now < next_t:
            time.sleep(next_t - now)
        if len(inflight) >= depth:
            t0, handle = inflight.pop(0)
            fetch(handle)
            lat = time.time() - t0
            latencies.append(lat)
            tele.record(completed, lat)
            completed += 1
        inflight.append((time.time(), dispatch()))
        missed = int((time.time() - next_t) // period)
        dropped += missed
        next_t += period * (1 + missed)
    for t0, handle in inflight:
        fetch(handle)
        lat = time.time() - t0
        latencies.append(lat)
        tele.record(completed, lat)
        completed += 1
    tele.save()
    lat_arr = np.asarray(latencies) if latencies else np.zeros(1)
    return {
        "completed": float(completed),
        "dropped": float(dropped),
        "drop_rate": float(dropped / max(completed + dropped, 1)),
        "latency_p50_ms": float(np.percentile(lat_arr, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(lat_arr, 99) * 1e3),
        "depth": float(depth),
        "duration_s": float(time.time() - start),
        **tele.summary(),
    }


def offline_benchmark(
    call: Callable[[], Any],
    sync: Callable[[Any], None],
    duration_s: float = 30.0,
    fps: float = 30.0,
    csv_path: Optional[str] = None,
    mem_every: int = 256,
    device=None,
) -> Dict[str, float]:
    """duration·fps calls back to back. ``mem_every`` samples device memory
    every Nth call (after its timing) for the high-watermark trend."""
    tele = Telemetry(csv_path, mem_every=mem_every, device=device)
    n_calls = int(duration_s * fps)
    t_start = time.time()
    for i in range(n_calls):
        t0 = time.time()
        out = call()
        sync(out)
        tele.record(i, time.time() - t0)
    tele.save()
    total = time.time() - t_start
    return {
        "calls": float(n_calls),
        "total_s": float(total),
        "achieved_fps": float(n_calls / total),
        **tele.summary(),
    }
