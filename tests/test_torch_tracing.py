"""The port's tracing (``utils/tracing.py``) on the CPU: off, it records
nothing and changes nothing; on, ``ScanTracker`` and ``StreamPool`` open
their layer spans in order, nested in the call, time them on the host's
clock, and count staged bytes, refreshes, recovering slots and re-inits as
the work they describe; outputs and state are bit-equal either way; a
tracker keeps the graph units of one tracing flag value at a time. The marks inside CUDA graphs are the
card's (``portbench/tests/test_portbench_program_trace.py``)."""

import json
import math

import jax
import numpy as np
import pytest
import torch

from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.tracker.serving import StreamPool
from feartracker_tpu_torch.utils import tracing

CFG = TrackerConfig(template_size=32, instance_size=64, score_size=8, total_stride=8)
HW = (96, 128)
S, T = 3, 5
STEP_LAYERS = ["fear.crop", "fear.trunk", "fear.head", "fear.decode", "fear.state"]
DUAL = dict(dynamic_template=True, update_mode="ema", update_threshold=0.0, update_interval=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def model():
    """The tiny FEAR with weights from JAX's initialiser (as
    ``test_torch_serving.py``'s): its score maps have peaks."""
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    v = jmodel.init(jax.random.PRNGKey(0),
                    (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)), train=False)
    v = jax.tree.map(np.asarray, v)
    # O(1) logits, so confidences spread across the thresholds
    v["params"]["connect_model"]["cls_scale"] = np.array([300.0], np.float32)
    return load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), v).eval()


@pytest.fixture(scope="module")
def clip():
    rng = np.random.RandomState(9)
    frames0 = rng.randint(0, 255, (S, *HW, 3)).astype(np.uint8)
    chunk = rng.randint(0, 255, (T, S, *HW, 3)).astype(np.uint8)
    boxes = np.array([[40.0, 30, 30, 24], [60, 20, 24, 30], [20, 40, 28, 28]], np.float32)
    return frames0, chunk, boxes


def _fear_spans(tmp_path, fn):
    """``fn()`` under a CPU ``torch.profiler`` → its ``fear.`` ranges as
    (name, start, end), in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = json.load(open(path))["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("fear.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_records_nothing(tmp_path, model, clip):
    frames0, chunk, boxes = clip
    assert tracing.span("fear.a") is tracing.span("fear.b") is tracing.layer("fear.crop")
    tracing.count("pool.steps", 5)
    assert "pool.steps" not in tracing.counters()
    tracker = ScanTracker(model, CFG, device="cpu", scan_unroll=2)
    state = tracker.init(frames0, boxes)
    assert _fear_spans(tmp_path, lambda: tracker.track(state, chunk)) == []
    assert tracing.host_times() == {}


def test_counters_hold_the_launch_counters_and_reset():
    tracing.enable()
    tracing.count("graph.captures")
    tracing.count("graph.captures", 2)
    with tracing.span("fear.a"):
        pass
    got = tracing.counters()
    assert got["graph.captures"] == 3 and len(tracing.host_times()["fear.a"]) == 1
    assert {"postprocess_cuda.launches", "fused_ir_block.launches", "crop_cuda.launches"} <= set(got)
    tracing.reset()
    assert "graph.captures" not in tracing.counters() and tracing.host_times() == {}
    assert not tracing.capturing()
    tracing.mark("fear.crop")  # on the CPU, nothing to mark


@pytest.mark.parametrize("dual", [False, True], ids=["static", "dual"])
@pytest.mark.parametrize("K", [1, 2])
def test_track_spans_in_layer_order(tmp_path, model, clip, K, dual):
    frames0, chunk, boxes = clip
    tracker = ScanTracker(model, CFG, device="cpu", scan_unroll=K, **(DUAL if dual else {}))
    state = tracker.init(frames0, boxes)
    tracing.enable()
    spans = _fear_spans(tmp_path, lambda: tracker.track(state, chunk, start_step=1))
    tracks = [s for s in spans if s[0] == "fear.track"]
    steps = [s for s in spans if s[0] == "fear.step"]
    assert len(tracks) == 1 and len(steps) == T
    host = tracing.host_times()
    assert len(host["fear.track"]) == 1 and len(host["fear.step"]) == len(host["fear.crop"]) == T
    assert sum(host["fear.step"]) <= host["fear.track"][0]
    for i, step in enumerate(steps):
        assert _inside(step, tracks[0])
        layers = [s for s in spans if s[0] in tracing.LAYERS and _inside(s, step)]
        want = list(STEP_LAYERS)
        if dual and (1 + i) % DUAL["update_interval"] == 0:
            want.insert(4, "fear.refresh")
        assert [s[0] for s in layers] == want
        # consecutive: each layer ends before the next begins
        assert all(a[2] <= b[1] for a, b in zip(layers, layers[1:]))
    if K > 1:
        # T = 5 at K = 2: two units, each copied in, replayed and copied out;
        # the dual template's starts 1 and 3 fall in two cadence phases
        names = [s[0] for s in spans]
        assert names.count("fear.graph.copy_in") == names.count("fear.graph.replay") == 2
        assert names.count("fear.graph.capture") == (2 if dual else 1)
    refreshes = sum((1 + t) % DUAL["update_interval"] == 0 for t in range(T)) if dual else 0
    assert tracing.counters().get("step.refreshes", 0) == refreshes


@pytest.mark.parametrize("K", [1, 2])
def test_outputs_and_state_bit_equal_on_and_off(model, clip, K):
    frames0, chunk, boxes = clip
    runs = []
    for on in (False, True, False):
        (tracing.enable if on else tracing.disable)()
        tracker = ScanTracker(model, CFG, device="cpu", scan_unroll=K, **DUAL)
        state, out = tracker.track(tracker.init(frames0, boxes), chunk, start_step=2)
        runs.append((state, out))
    for state, out in runs[1:]:
        for a, b in zip(runs[0][0], state):
            assert torch.equal(a, b)
        assert sorted(out) == sorted(runs[0][1])
        for k in out:
            assert torch.equal(out[k], runs[0][1][k]), k


@pytest.mark.parametrize("policy", ["notify", "reinit"])
def test_pool_counters(model, clip, policy):
    frames0, chunk, boxes = clip
    tracker = ScanTracker(model, CFG, device="cpu", recover_context=2.0, recover_threshold=0.7, **DUAL)
    pool = StreamPool(tracker, capacity=S + 1, frame_hw=HW, failure_policy=policy)
    for s in range(S):
        pool.add(frames0[s], boxes[s])
    tracing.enable()
    steps, pending, results = 7, [], []
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 255, (S + 1, *HW, 3)).astype(np.uint8) for _ in range(steps)]
    frames[3][:] = 0  # a blank frame: failures
    for f in frames:
        pending.append(pool.step_async(f))
        if len(pending) == 2:
            results.append(pending.pop(0).result())
    results += [p.result() for p in pending]
    got = tracing.counters()
    assert got["pool.steps"] == steps
    assert got["pool.staged_bytes"] == steps * frames[0].nbytes
    assert got["step.refreshes"] == math.ceil(steps / DUAL["update_interval"])
    low = [int(((r["confidence"] < 0.7) & r["active"]).sum()) for r in results]
    assert got.get("pool.recovering_slots", 0) == sum(low)
    assert 0 < sum(low) < steps * S, "the drained confidences lie on both sides of the threshold"
    failures = sum(int(r["failure"].sum()) for r in results)
    assert failures > 0, "the blank frame fails slots"
    # "reinit" re-templates each failed slot as its step is drained
    assert got.get("pool.reinits", 0) == (failures if policy == "reinit" else 0)


def test_pool_spans(tmp_path, model, clip):
    frames0, chunk, boxes = clip
    pool = StreamPool(ScanTracker(model, CFG, device="cpu"), capacity=S, frame_hw=HW)
    for s in range(S):
        pool.add(frames0[s], boxes[s])
    tracing.enable()
    spans = _fear_spans(tmp_path, lambda: pool.step_async(chunk[0]).result())
    outer = [s for s in spans if s[0] == "fear.pool.step_async"]
    assert len(outer) == 1
    inside = [s[0] for s in spans if s is not outer[0] and _inside(s, outer[0])]
    assert inside[:2] == ["fear.pool.stage", "fear.step"] and inside[-1] == "fear.pool.fetch"
    assert "fear.pool.drain" in [s[0] for s in spans if not _inside(s, outer[0])]


def test_units_of_one_flag_value_at_a_time(model, clip):
    """Tracing on captures marked units beside nothing: the unmarked units
    go, and come back when tracing is off again."""
    frames0, chunk, boxes = clip
    tracker = ScanTracker(model, CFG, device="cpu", scan_unroll=2, **DUAL)
    state = tracker.init(frames0, boxes)
    flags = []
    for on in (False, True, False):
        (tracing.enable if on else tracing.disable)()
        tracker.track(state, chunk, start_step=1)
        flags.append({key[3] for key in tracker._unrolled})
    assert flags == [{False}, {True}, {False}]


def test_every_layer_has_its_mark(tmp_path):
    """Each index of ``LAYERS`` has its case in ``csrc/mark.cu``'s launch
    switch, OSTrack's ``fear.vit`` (6) and ``fear.ce`` (7) included, and a
    replay's ``fear_mark<6>`` and ``fear_mark<7>`` kernels name their
    segments in a trace by those layers."""
    import os
    import re

    from portbench.program_trace import reduce_program_trace

    src = open(os.path.join(os.path.dirname(tracing.__file__), "..", "csrc", "mark.cu")).read()
    cases = {int(k) for k in re.findall(r"case (\d+): fear_mark<\1>", src)}
    assert cases == set(range(len(tracing.LAYERS)))
    assert tracing.LAYERS[6:] == ("fear.vit", "fear.ce")

    def x(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
                "args": {"correlation": corr}}

    events = [x("user_annotation", "portbench.slice", 0, 500, None), x("cuda_runtime", "cudaGraphLaunch", 5, 2, 9)]
    t = 10
    for name, dur in [("void fear_mark<0>()", 1), ("crop", 4), ("void fear_mark<6>()", 1), ("gemm", 30),
                      ("void fear_mark<7>()", 1), ("sort", 5), ("void fear_mark<6>()", 1), ("gemm", 20),
                      ("void fear_mark<7>()", 1), ("scatter", 2), ("void fear_mark<2>()", 1), ("conv", 6)]:
        events.append(x("kernel", name, t, dur, 9))
        t += dur + 1
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = reduce_program_trace(str(path), tracing.LAYERS)
    us = 1e-6
    want = {"fear.crop": [4], "fear.vit": [30, 20], "fear.ce": [5, 2], "fear.head": [6]}
    assert r["segments"] == {k: [pytest.approx(v * us) for v in vs] for k, vs in want.items()}
