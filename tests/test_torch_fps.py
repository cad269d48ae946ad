"""The port's benchmark protocols (``evaluate/fps.py``) and profiling
helpers (``evaluate/profiling.py``) on trivial callables on the CPU, with the
same result keys and CSV columns as the JAX package's. The protocols time
the host clock; on the CPU the device-memory columns read zeros."""

import json
import os
import time

import pytest
import torch

from feartracker_tpu.evaluate import fps as JF
from feartracker_tpu_torch.evaluate import fps as F
from feartracker_tpu_torch.evaluate.profiling import trace


def _counter():
    calls = {"n": 0}

    def call():
        calls["n"] += 1
        return calls["n"]

    return calls, call


def test_fps_benchmark_counts_keys_and_csv(tmp_path):
    calls, call = _counter()
    csv_path = str(tmp_path / "tele.csv")
    res = F.fps_benchmark(call, sync=lambda x: None, warmup=3, timed=10, csv_path=csv_path, device="cpu")
    assert calls["n"] == 13
    assert res.keys() == JF.fps_benchmark(lambda: 0, lambda x: None, warmup=1, timed=2).keys()
    assert res["fps"] > 0 and res["p99_ms"] >= res["p50_ms"] >= 0
    lines = open(csv_path).read().splitlines()
    assert len(lines) == 11  # header + 10 rows
    assert lines[0].split(",") == ["call", "duration_ms", "rss_mb", "device_mem_mb", "device_peak_mb",
                                   "timestamp"]


def test_online_benchmark_drop_accounting():
    res = F.online_benchmark(lambda: time.sleep(0.025), sync=lambda x: None, duration_s=0.3,
                             input_fps=100)
    # a 25 ms call against a 10 ms period drops about two ticks per call
    assert res["dropped"] > 0 and 0 < res["drop_rate"] < 1
    assert res.keys() == JF.online_benchmark(lambda: 0, lambda x: None, duration_s=0.01).keys()


def test_pipelined_online_benchmark_overlaps_fetch():
    """dispatch is instant and fetch waits 25 ms: at depth 2 the wait
    overlaps the next tick, and latency includes it."""

    class Handle:
        def __init__(self):
            self.ready_at = time.time() + 0.025

        def wait(self):
            time.sleep(max(0.0, self.ready_at - time.time()))

    res = F.pipelined_online_benchmark(dispatch=Handle, fetch=lambda h: h.wait(), duration_s=0.3,
                                       input_fps=30, depth=2)
    assert res["completed"] >= 5 and res["depth"] == 2.0
    assert res["latency_p50_ms"] >= 25.0
    assert res.keys() == JF.pipelined_online_benchmark(Handle, lambda h: None, duration_s=0.01).keys()
    with pytest.raises(ValueError):
        F.pipelined_online_benchmark(Handle, fetch=lambda h: None, duration_s=0.1, depth=0)


def test_offline_benchmark_runs_exact_calls_and_stays_flat(tmp_path):
    calls, call = _counter()
    csv_path = str(tmp_path / "soak.csv")
    res = F.offline_benchmark(call, sync=lambda x: None, duration_s=0.1, fps=50, csv_path=csv_path,
                              mem_every=2)
    assert calls["n"] == 5 and res["achieved_fps"] > 0
    assert res.keys() == JF.offline_benchmark(lambda: 0, lambda x: None, duration_s=0.01, fps=100).keys()
    assert res["hbm_high_watermark_mb"] == 0.0 and res["hbm_trend_mb"] == 0.0


def test_telemetry_device_memory_and_drift():
    assert F._device_memory_mb() == F._device_memory_mb("cpu") == {"device_mem_mb": 0.0,
                                                                    "device_peak_mb": 0.0}
    tele = F.Telemetry(device=torch.device("cpu"))
    for i in range(100):
        tele.record(i, 0.001 * (1 + i / 50))  # a 1 ms -> 3 ms ramp
    assert tele.summary()["step_time_drift_pct"] > 100.0
    flat = F.Telemetry()
    for i in range(100):
        flat.record(i, 0.002)
    assert abs(flat.summary()["step_time_drift_pct"]) < 1e-9
    assert F.Telemetry().summary() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        for _ in range(5):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.load(open(os.path.join(tmp_path, "prof", "trace.json")))["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in a.key for a in prof.key_averages())
