"""The program's traced slice (``portbench/program_trace.py``): the reduction
of a hand-built Chrome trace, its readers, a small run of each cell on the
CPU, and on the card a marked graph against the unmarked one."""

import json
import math
import os
import statistics

import pytest
import torch

from portbench import harness, program_trace
from portbench.program_trace import OUTSIDE, reduce_program_trace

LAYERS = ("fear.crop", "fear.trunk", "fear.head", "fear.decode", "fear.refresh", "fear.state")
# the readers of the program's slice, by driver
READERS = {
    "track_chunks": ("crop_ms.track", "trunk_ms.track", "head_ms.track", "decode_ms.track", "copy_in_ms.track"),
    "pool_pipelined": ("stage_ms.pool", "launch_ms.pool", "wait_ms.pool", "refresh_ms.pool"),
}
NEW = [name for names in READERS.values() for name in names]


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path):
    """A slice of one ``track`` call: an eager copy in, a graph replay of
    two marked frames (the second with a refresh), an eager write of the
    outputs in ``fear.track`` itself; a device op no runtime call launched;
    a launch outside the program's spans, then the host alone in a
    ``portbench.`` span."""
    host = [
        _x("user_annotation", "portbench.slice", 0, 1000),
        _x("user_annotation", "portbench.track_call", 10, 600),
        _x("user_annotation", "fear.track", 20, 320),
        _x("user_annotation", "fear.graph.copy_in", 30, 40),
        _x("cuda_runtime", "cudaMemcpyAsync", 40, 5, corr=1),
        _x("user_annotation", "fear.graph.replay", 80, 30),
        _x("cuda_runtime", "cudaGraphLaunch", 90, 10, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 345, 2, corr=4),
        _x("user_annotation", "portbench.result", 700, 250),
        _x("cpu_op", "aten::copy_", 40, 6),
    ]
    # the replay's ops, out of time order as a trace may list them
    k = 100
    replay = []
    for name, dur in [("void fear_mark<0>()", 2), ("crop_a", 10), ("crop_b", 20), ("void fear_mark<1>()", 2),
                      ("ir_block", 30), ("void fear_mark<2>()", 2), ("conv", 8), ("void fear_mark<3>()", 2),
                      ("decode", 4), ("void fear_mark<5>()", 2), ("stack", 1),
                      ("void fear_mark<0>()", 2), ("crop_a", 11), ("void fear_mark<1>()", 2), ("ir_block", 31),
                      ("void fear_mark<2>()", 2), ("conv", 9), ("void fear_mark<3>()", 2), ("decode", 5),
                      ("void fear_mark<4>()", 2), ("encode", 40), ("void fear_mark<5>()", 2), ("stack", 3)]:
        replay.append(_x("kernel", name, k, dur, corr=2, tid=99))
        k += dur + 1
    device = [_x("gpu_memcpy", "Memcpy DtoD", 50, 25, corr=1, tid=98)] + replay[::-1] + [
        _x("kernel", "copy_out_kernel", k + 5, 6, corr=3, tid=99),
        _x("kernel", "orphan", k + 20, 7, corr=77, tid=99),
        _x("kernel", "outside", k + 30, 3, corr=4, tid=99),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": host + device}))
    return str(path), k


def test_reduce_program_trace_sums_and_names(tmp_path):
    path, end = _trace(tmp_path)
    r = reduce_program_trace(path, LAYERS)
    us = 1e-6
    assert r["segments"] == {
        "fear.crop": [pytest.approx(30 * us), pytest.approx(11 * us)],
        "fear.trunk": [pytest.approx(30 * us), pytest.approx(31 * us)],
        "fear.head": [pytest.approx(8 * us), pytest.approx(9 * us)],
        "fear.decode": [pytest.approx(4 * us), pytest.approx(5 * us)],
        "fear.refresh": [pytest.approx(40 * us)],
        "fear.state": [pytest.approx(1 * us), pytest.approx(3 * us)],
    }
    assert r["marks"] == 11 and r["marks_s"] == pytest.approx(22 * us)
    assert r["self_device_s"] == {"fear.graph.copy_in": pytest.approx(25 * us),
                                  "fear.track": pytest.approx(6 * us), OUTSIDE: pytest.approx(3 * us)}
    # a span's device time holds what its children launched
    assert r["span_device_s"]["fear.track"] == [pytest.approx((25 + 6 + 194) * us)]
    assert r["span_device_s"]["fear.graph.replay"] == [pytest.approx(194 * us)]
    assert r["unattributed_s"] == pytest.approx(7 * us)
    parts = (sum(r["self_device_s"].values()) + sum(sum(v) for v in r["segments"].values()) + r["marks_s"]
             + r["unattributed_s"])
    assert parts == pytest.approx(r["device_s"]) and r["device_s"] == pytest.approx((25 + 194 + 6 + 7 + 3) * us)
    assert r["kernels"] == 26 and r["kernel_s"] == pytest.approx((194 + 6 + 7 + 3) * us)
    assert r["spans"]["fear.graph.copy_in"] == [pytest.approx(40 * us)]
    assert r["top_ops"]["fear.crop"] == [("crop_a", pytest.approx(21 * us)), ("crop_b", pytest.approx(20 * us))]
    assert r["top_ops"]["fear.graph.copy_in"] == [("Memcpy DtoD", pytest.approx(25 * us))]
    assert r["spans"]["portbench.result"] == [pytest.approx(250 * us)]
    # the longest gap begins after the last kernel, the host in the benchmark's
    # span; the next, from the slice's start to the first copy, in none
    assert r["idle_gaps"][0] == ["portbench.track_call", pytest.approx((1000 - (end + 33)) * us)]
    assert r["idle_gaps"][1] == ["(between spans)", pytest.approx(50 * us)]


def test_reduce_program_trace_needs_the_slice(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_x("user_annotation", "fear.track", 0, 5)]}))
    with pytest.raises(ValueError):
        reduce_program_trace(str(path), LAYERS)


def _program(**kw):
    p = {"steps": 4, "segments": {}, "span_device_s": {}, "host_s": {}, "counters": {}}
    p.update(kw)
    return {"window": {}, "counts": {}, "program": p}


@pytest.mark.parametrize("name", NEW)
def test_new_readers(name):
    mod = harness.reader(name)
    bench = harness.benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert mod.NAME == name and mod.UNIT == "ms" and mod.MOVES in e2e
    assert mod.SOURCE in ("device_trace", "host_clock") and mod.LAYER
    assert mod.read({"window": {}, "counts": {}}) is None
    assert mod.read(_program()) is None
    rec = _program(segments={layer: [0.001, 0.003] for layer in LAYERS},
                   span_device_s={"fear.graph.copy_in": [0.002, 0.002], "fear.refresh": [0.003, 0.005]},
                   host_s={"fear.pool.stage": [0.010, 0.030, 0.020], "fear.step": [0.006, 0.004, 0.005],
                           "fear.pool.wait": [0.050, 0.070, 0.060]},
                   counters={"step.refreshes": 2})
    want = {"crop_ms.track": 1.0, "trunk_ms.track": 1.0, "head_ms.track": 1.0, "decode_ms.track": 1.0,
            "copy_in_ms.track": 1.0, "stage_ms.pool": 20.0, "launch_ms.pool": 5.0, "wait_ms.pool": 60.0,
            "refresh_ms.pool": 4.0}
    assert mod.read(rec) == pytest.approx(want[name])


@pytest.mark.parametrize("kind", ["track", "pool"])
def test_program_slice_on_the_cpu(small_cells, tmp_path, kind):
    """A driver's run, then :func:`trace_program` before ``free_program``:
    the spans timed with no profiler and under it, the counters, the
    readers; the window's outputs still judge correct after it."""
    from feartracker_tpu_torch.utils import tracing

    cell = {"track": "fear_xs.track.s128", "pool": "fear_xs.pool.c128"}[kind]
    wl, cfg, mix = harness.cell(cell)
    run = harness.driver(mix["driver"]).Run(cfg, mix, 5, torch.device("cpu"))
    run.window(0.5)
    rec = {"program": program_trace.trace_program(run, str(tmp_path / "program.json"))}
    assert not tracing.enabled() and not os.path.exists(tmp_path / "program.json")
    p = rec["program"]
    run.free_program()
    limits = harness.limits(wl["name"])
    assert all(v <= limits[k] for k, v in run.judge().items())
    if kind == "track":
        assert {"fear.track", "fear.step", "fear.crop", "fear.state", "fear.graph.replay"} <= set(p["host_s"])
        assert len(p["host_s"]["fear.track"]) == len(p["spans"]["fear.track"]) == mix["trace_calls"]
        assert p["steps"] == mix["trace_calls"] * mix["chunk"]
    else:
        assert {"fear.pool.step_async", "fear.pool.stage", "fear.pool.fetch"} <= set(p["host_s"])
        # four steps in a row hold one refresh: in one of the two slices
        assert "fear.refresh" in set(p["host_s"]) | set(p["spans"])
        c = p["counters"]
        assert len(p["host_s"]["fear.pool.step_async"]) == mix["trace_steps"]
        assert c["pool.steps"] == mix["trace_steps"]
        assert c["pool.staged_bytes"] == mix["trace_steps"] * mix["capacity"] * math.prod(mix["frame_hw"]) * 3
        # the counters are the profiled slice's, which may hold no refresh
        assert c.get("step.refreshes", 0) == len(p["spans"].get("fear.refresh", []))
        for name in READERS["pool_pipelined"][:2]:
            assert harness.reader(name).read(rec) > 0
        # the host readers read the slice with no profiler running
        assert harness.reader("stage_ms.pool").read(rec) == pytest.approx(
            statistics.median(p["host_s"]["fear.pool.stage"]) * 1e3)


@pytest.mark.card
@pytest.mark.parametrize("dual", [False, True], ids=["static", "dual"])
def test_marked_replay_equals_unmarked(tmp_path, dual):
    """A unit captured with tracing on replays to the unmarked unit's
    outputs and state, bit for bit, and its replay holds one ``fear_mark``
    per layer per frame (and one ``fear.refresh`` a refresh frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from feartracker_tpu_torch.tracker.runtime import ScanTracker
    from feartracker_tpu_torch.utils import tracing
    from portbench import clips, weights

    cfg = harness.cell("fear_xs.track.s128")[1]
    S, T, K, dev = 8, 8, 4, torch.device("cuda", 0)
    kw = dict(dynamic_template=True, update_mode="ema", update_interval=2) if dual else {}
    tracker = ScanTracker(weights.program_model(cfg, weights.read_npz(cfg["weights"])), dtype=torch.bfloat16,
                          device=dev, scan_unroll=K, **kw)
    c = clips.make_clips(S, T + 1, (256, 480), 3, dev, 8, (40, 120))
    state0 = tracker.init(c.frames[0], c.boxes[0])
    chunk = c.frames[1:]
    runs = []
    try:
        for on in (False, True):
            (tracing.enable if on else tracing.disable)()
            tracker.track(state0, chunk)  # captures this flag's units
            torch.cuda.synchronize()
            tracing.reset()
            path = str(tmp_path / f"trace_{on}.json")
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("portbench.slice"):
                    state, out = tracker.track(state0, chunk)
                    torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            runs.append((state, out, reduce_program_trace(path, tracing.LAYERS), tracing.counters()))
    finally:
        tracing.disable()
    (s0, o0, r0, _), (s1, o1, r1, c1) = runs
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k
    assert r0["marks"] == 0 and not r0["segments"]
    layers = {"fear.crop", "fear.trunk", "fear.head", "fear.decode", "fear.state"}
    assert {k: len(v) for k, v in r1["segments"].items()} == {
        **{k: T for k in layers}, **({"fear.refresh": T // 2} if dual else {})}
    assert r1["kernels"] - r0["kernels"] == r1["marks"] == 5 * T + (T // 2 if dual else 0)
    # a replay counts its unit's refreshes, which its Python ran only at capture
    assert c1.get("graph.captures", 0) == 0 and c1.get("step.refreshes", 0) == (T // 2 if dual else 0)
    assert len(r1["spans"]["fear.graph.replay"]) == T // K
    assert r1["unattributed_s"] == pytest.approx(0.0, abs=1e-9)
