"""The port's ``StreamPool`` on the CPU: against the JAX ``StreamPool`` on
the tiny model (same schedule of adds, removes, steps and chunks, equal
failure/active flags, boxes within 1e-3 px), and the pool's own contract:
slot lifecycle, capacity guard, policy validation, pipelined = serial,
shared frame = tiled, churn isolation with the dual template."""

import jax
import numpy as np
import pytest
import torch

from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.tracker.config import TrackerConfig as JTrackerConfig
from feartracker_tpu.tracker.runtime import ScanTracker as JScanTracker
from feartracker_tpu.tracker.serving import StreamPool as JStreamPool
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.tracker.serving import StreamPool

TINY_CFG = dict(template_size=32, instance_size=64, score_size=8, total_stride=8)
CFG = TrackerConfig(**TINY_CFG)
HW = (96, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    v = jmodel.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    v = jax.tree.map(np.asarray, v)
    # O(1) logits, so confidences spread across the failure threshold
    v["params"]["connect_model"]["cls_scale"] = np.array([300.0], np.float32)
    model = load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), v)
    return jmodel, v, model.eval()


@pytest.fixture(scope="module")
def tracker(models):
    return ScanTracker(models[2], CFG, device="cpu")


def _frames(rng, n=1):
    return rng.randint(0, 255, (n, *HW, 3)).astype(np.uint8)


def _tile(frame, n):
    return np.broadcast_to(frame, (n, *HW, 3))


def _feats(pool):
    return pool.state.template_feats.numpy()


DUAL = dict(dynamic_template=True, update_mode="ema", update_threshold=0.3, update_rate=0.3,
            update_interval=2)


def _run_schedule(pool, seq):
    """A fixed schedule of adds, removes, steps (serial and pipelined),
    chunks, shared frames and blank frames; the list of results."""
    cap = pool.capacity
    out = []
    pool.add(seq[0], [40, 30, 30, 40])
    pool.add(seq[1], [10, 10, 20, 20])
    out.append(pool.step(_tile(seq[2], cap)))
    out.append(pool.step_chunk(np.stack([_tile(seq[3], cap), _tile(seq[4], cap)])))
    pool.add(seq[5], [60, 40, 24, 30])
    pool.remove(0)
    pending = [pool.step_async(_tile(seq[t], cap)) for t in (6, 7)]
    pool.add(seq[8], [20, 50, 30, 30])  # joins while two steps are in flight
    out += [p.result() for p in pending]
    out.append(pool.step(np.zeros((cap, *HW, 3), np.uint8)))  # blank: failures
    out.append(pool.step(seq[9]))  # one frame shared by every slot
    out.append(pool.step_chunk(seq[10:12]))  # a shared chunk
    return out


@pytest.mark.parametrize("policy", ["notify", "reinit"])
def test_pool_matches_jax_pool(models, policy):
    jmodel, v, model = models
    seq = _frames(np.random.RandomState(20), 12)
    jpool = JStreamPool(JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG), **DUAL), 4, HW,
                        failure_policy=policy)
    pool = StreamPool(ScanTracker(model, CFG, device="cpu", **DUAL), 4, HW, failure_policy=policy)
    jres, res = _run_schedule(jpool, seq), _run_schedule(pool, seq)
    assert len(res) == len(jres)
    failures = 0
    for a, b in zip(res, jres):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["bbox"], np.asarray(b["bbox"]), atol=1e-3)
        np.testing.assert_allclose(a["confidence"], np.asarray(b["confidence"]), atol=1e-4)
        np.testing.assert_array_equal(a["failure"], b["failure"])
        np.testing.assert_array_equal(a["active"], b["active"])
        failures += int(a["failure"].sum())
    assert failures > 0
    assert pool._step_count == jpool._step_count == 9
    np.testing.assert_array_equal(pool.active, jpool.active)
    for name in ("template_feats", "dyn_feats", "bbox", "confidence"):
        np.testing.assert_allclose(getattr(pool.state, name).numpy(),
                                   np.asarray(getattr(jpool.state, name)), atol=1e-3, err_msg=name)


def test_slot_lifecycle(tracker):
    rng = np.random.RandomState(0)
    pool = StreamPool(tracker, capacity=4, frame_hw=HW)
    assert pool.state.template_feats.shape == (4, 4, 4, 16)
    f = _frames(rng)[0]
    s0 = pool.add(f, [40, 30, 30, 40])
    s1 = pool.add(f, [10, 10, 20, 20])
    assert (s0, s1) == (0, 1) and pool.num_active == 2

    out = pool.step(_tile(f, 4))
    assert out["bbox"].shape == (4, 4) and isinstance(out["bbox"], np.ndarray)
    assert out["active"].tolist() == [True, True, False, False]
    assert not out["failure"][2:].any()  # inactive slots never flag failure

    pool.remove(s0)
    pool.remove(s0)  # removing a free slot is a no-op
    assert pool.num_active == 1
    assert pool.add(f, [50, 50, 20, 20]) == 2  # FIFO free list: next unused slot
    pool.add(f, [5, 5, 10, 10])
    assert pool.add(f, [6, 6, 10, 10]) == s0  # the freed slot 0 comes back around


def test_pool_capacity_and_frame_guards(tracker):
    f = _frames(np.random.RandomState(1))[0]
    pool = StreamPool(tracker, capacity=2, frame_hw=HW)
    pool.add(f, [40, 30, 30, 40])
    pool.add(f, [10, 10, 20, 20])
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.add(f, [5, 5, 10, 10])
    with pytest.raises(ValueError, match="pool takes"):
        StreamPool(tracker, capacity=2, frame_hw=HW).add(f[:50], [5, 5, 10, 10])


def test_failure_policy_selectable(tracker):
    """'notify' (default) surfaces the failure and leaves the template;
    'reinit' re-templates from the current prediction."""
    f = _frames(np.random.RandomState(3))[0]
    notify = StreamPool(tracker, capacity=1, frame_hw=HW)
    assert notify.failure_policy == "notify" and not notify.auto_reinit
    reinit = StreamPool(tracker, capacity=1, frame_hw=HW, failure_policy="reinit")
    assert reinit.auto_reinit
    legacy = StreamPool(tracker, capacity=1, frame_hw=HW, auto_reinit=True)
    assert legacy.failure_policy == "reinit"
    with pytest.raises(ValueError):
        StreamPool(tracker, capacity=1, frame_hw=HW, failure_policy="panic")

    for pool, retemplates in [(notify, False), (reinit, True)]:
        pool.add(f, [40, 30, 30, 40])
        before = _feats(pool).copy()
        out = pool.step(np.zeros((1, *HW, 3), np.uint8))  # blank frame: failure
        assert out["failure"][0]
        assert (not np.allclose(before, _feats(pool))) == retemplates


def test_pipelined_steps_match_serial(tracker):
    """step_async with k steps in flight gives the per-step results of the
    blocking step(); result() is cached."""
    seq = _frames(np.random.RandomState(4), 6)
    serial = StreamPool(tracker, capacity=2, frame_hw=HW)
    serial.add(seq[0], [40, 30, 30, 40])
    serial_out = [serial.step(_tile(seq[t], 2)) for t in range(1, 6)]

    piped = StreamPool(tracker, capacity=2, frame_hw=HW)
    piped.add(seq[0], [40, 30, 30, 40])
    pending = [piped.step_async(_tile(seq[t], 2)) for t in range(1, 6)]
    piped_out = [p.result() for p in pending]
    for a, b in zip(serial_out, piped_out):
        np.testing.assert_array_equal(a["bbox"], b["bbox"])
        np.testing.assert_array_equal(a["failure"], b["failure"])
    assert pending[0].result() is piped_out[0]
    assert pending[0].done is None  # events are recorded on a card only


def test_pipelined_reinit_applies_on_drain(tracker):
    f = _frames(np.random.RandomState(5))[0]
    pool = StreamPool(tracker, capacity=1, frame_hw=HW, failure_policy="reinit")
    pool.add(f, [40, 30, 30, 40])
    before = _feats(pool).copy()
    pending = pool.step_async(np.zeros((1, *HW, 3), np.uint8))
    np.testing.assert_array_equal(_feats(pool), before)  # not drained yet
    assert pending.result()["failure"][0]
    assert not np.allclose(_feats(pool), before)


def test_pipelined_slot_churn_uses_dispatch_snapshot(tracker):
    """The masks of an in-flight step are the slots active at dispatch, and
    a slot written after dispatch leaves the step's outputs as they were."""
    f = _frames(np.random.RandomState(6))[0]
    pool = StreamPool(tracker, capacity=3, frame_hw=HW)
    s0 = pool.add(f, [40, 30, 30, 40])
    pending = pool.step_async(_tile(f, 3))
    boxes = pending._out["bbox"].clone()
    s1 = pool.add(f, [10, 10, 20, 20])  # joins after dispatch
    pool.remove(s0)                     # leaves after dispatch
    out = pending.result()
    assert out["active"].tolist() == [True, False, False]
    assert not out["failure"][s1]
    np.testing.assert_array_equal(out["bbox"], boxes.numpy())
    assert pool.step(_tile(f, 3))["active"].tolist() == [False, True, False]


def test_step_chunk_matches_per_frame(tracker):
    """One chunk over T frames equals T steps; outputs carry the leading T
    axis; the step counter advances by T."""
    seq = _frames(np.random.RandomState(7), 7)
    ref = StreamPool(tracker, capacity=2, frame_hw=HW)
    ref.add(seq[0], [40, 30, 30, 40])
    ref_boxes = [ref.step(_tile(seq[t], 2))["bbox"] for t in range(1, 7)]
    pool = StreamPool(tracker, capacity=2, frame_hw=HW)
    pool.add(seq[0], [40, 30, 30, 40])
    out = pool.step_chunk(np.stack([_tile(seq[t], 2) for t in range(1, 7)]))
    assert out["bbox"].shape == (6, 2, 4) and pool._step_count == 6
    np.testing.assert_allclose(out["bbox"], np.stack(ref_boxes), atol=1e-3)


def test_step_chunk_reinit_catches_mid_chunk_failure(tracker):
    """A slot whose failure clears by the chunk's last frame is still
    re-templated: the failure mask is OR-ed over T."""
    f = _frames(np.random.RandomState(9))[0]
    pool = StreamPool(tracker, capacity=1, frame_hw=HW, failure_policy="reinit")
    pool.add(f, [40, 30, 30, 40])
    before = _feats(pool).copy()
    fake_out = {
        "bbox": np.broadcast_to(np.float32([62.0, 48.0, 24.0, 30.0]), (3, 1, 4)),
        "confidence": np.full((3, 1), 0.9, np.float32),
        "failure": np.array([[False], [True], [False]]),
    }
    out = pool._drain(fake_out, pool.active.copy(), _tile(f, 3)[:, None])
    assert out["failure"][1, 0] and not out["failure"][-1, 0]
    assert not np.allclose(_feats(pool), before)


def test_pool_matches_dedicated_stream(tracker):
    """A slot in the pool follows the trajectory of a 1-stream tracker."""
    seq = _frames(np.random.RandomState(2), 6)
    pool = StreamPool(tracker, capacity=3, frame_hw=HW)
    slot = pool.add(seq[0], [40, 30, 30, 40])
    pool_boxes = [pool.step(_tile(seq[t], 3))["bbox"][slot] for t in range(1, 6)]
    state = tracker.init(seq[0][None], np.array([[40, 30, 30, 40]], np.float32))
    single = []
    for t in range(1, 6):
        state, out = tracker.step(state, seq[t][None])
        single.append(out["bbox"][0].numpy())
    np.testing.assert_allclose(np.asarray(pool_boxes), np.asarray(single), atol=1e-3)


def test_pool_shared_frame_multiobject(tracker):
    """A single (H, W, 3) frame / (T, H, W, 3) chunk shared by every slot
    equals per-slot tiling, the reinit policy's re-template source included."""
    frames = _frames(np.random.RandomState(11), 4)

    def run(shared):
        pool = StreamPool(tracker, capacity=3, frame_hw=HW, failure_policy="reinit")
        pool.add(frames[0], [40, 30, 30, 40])
        pool.add(frames[0], [20, 20, 30, 30])
        outs = [pool.step(frames[1] if shared else _tile(frames[1], 3).copy())]
        chunk = frames[2:] if shared else np.broadcast_to(frames[2:, None], (2, 3, *HW, 3)).copy()
        outs.append(pool.step_chunk(chunk))
        return outs, pool

    (o_s, p_s), (o_t, p_t) = run(True), run(False)
    for a, b in zip(o_s, o_t):
        np.testing.assert_array_equal(a["bbox"], b["bbox"])
        np.testing.assert_array_equal(a["failure"], b["failure"])
    np.testing.assert_array_equal(_feats(p_s), _feats(p_t))


# -- randomized slot churn ----------------------------------------------------


def _churn_schedule(rng, capacity, steps):
    """Add/remove events and per-slot frames, replayed exactly by each run."""
    return [{
        "add": rng.rand() < 0.3,
        "add_bbox": [float(rng.randint(10, 60)), float(rng.randint(10, 50)),
                     float(rng.randint(15, 40)), float(rng.randint(15, 40))],
        "remove_draw": rng.rand(),
        "remove_pick": int(rng.randint(1 << 30)),
        "frames": rng.randint(0, 255, (capacity, *HW, 3)).astype(np.uint8),
    } for _ in range(steps)]


def _run_churn(tracker, events, capacity, pipeline_depth=0, dedicated=None):
    """Replay a churn schedule through a pool. With ``dedicated`` (a dict),
    every live slot is mirrored by its own 1-stream state on the same
    tracker, and each drained box must equal its mirror's. With
    ``pipeline_depth`` > 0 results are drained that many steps late."""
    pool = StreamPool(tracker, capacity=capacity, frame_hw=HW)
    next_id, slot_owner, results, inflight = 0, {}, [], []

    def drain_one():
        handle, active_owner = inflight.pop(0)
        res = handle.result()
        results.append(res["bbox"].copy())
        if dedicated is not None:
            for slot, sid in active_owner.items():
                st, ded_out = tracker.step(dedicated[sid]["state"], dedicated[sid]["frame"][None],
                                           step_index=dedicated[sid]["t"])
                dedicated[sid].update(state=st, t=dedicated[sid]["t"] + 1)
                np.testing.assert_allclose(res["bbox"][slot], ded_out["bbox"][0].numpy(), atol=1e-3,
                                           err_msg=f"slot {slot} (stream {sid}) left its mirror")

    for step, ev in enumerate(events):
        if ev["add"] and pool._free:
            claim = pool._free[0]
            slot = pool.add(ev["frames"][claim], ev["add_bbox"])
            assert slot == claim
            slot_owner[slot] = next_id
            if dedicated is not None:
                # the mirror starts at the pool's step count: same cadence
                dedicated[next_id] = {"state": tracker.init(
                    ev["frames"][slot][None], np.asarray([ev["add_bbox"]], np.float32)),
                    "frame": None, "t": step}
            next_id += 1
        if ev["remove_draw"] < 0.15 and pool.num_active > 0:
            active_slots = sorted(s for s in slot_owner if pool.active[s])
            victim = active_slots[ev["remove_pick"] % len(active_slots)]
            pool.remove(victim)
            sid = slot_owner.pop(victim)
            if dedicated is not None:
                dedicated.pop(sid)
        assert pool.num_active + len(pool._free) == capacity
        assert not (set(np.nonzero(pool.active)[0]) & set(pool._free))
        if dedicated is not None:
            for slot, sid in slot_owner.items():
                dedicated[sid]["frame"] = ev["frames"][slot]
        handle = pool.step_async(ev["frames"])
        inflight.append((handle, {s: i for s, i in slot_owner.items() if pool.active[s]}))
        while len(inflight) > pipeline_depth:
            drain_one()
    while inflight:
        drain_one()
    return results


@pytest.mark.parametrize("update_interval", [1, 2])
def test_soak_dual_template_churn_isolation(models, update_interval):
    """Randomized add/remove/step events with the dual template live
    (refresh on every eligible frame): each slot's trajectory equals its
    own 1-stream mirror, so no template leaks across slot reuse."""
    dual = ScanTracker(models[2], CFG, device="cpu", dynamic_template=True, update_mode="ema",
                       update_threshold=-1.0, update_rate=0.3, update_interval=update_interval)
    events = _churn_schedule(np.random.RandomState(13), capacity=3, steps=60)
    _run_churn(dual, events, capacity=3, dedicated={})


def test_soak_pipelined_matches_serial(tracker):
    """The same churn schedule drained serially and with 2 steps in flight
    gives identical outputs."""
    events = _churn_schedule(np.random.RandomState(12), capacity=4, steps=80)
    serial = _run_churn(tracker, events, capacity=4, pipeline_depth=0)
    piped = _run_churn(tracker, events, capacity=4, pipeline_depth=2)
    assert len(serial) == len(piped) == 80
    for a, b in zip(serial, piped):
        np.testing.assert_array_equal(a, b)


def test_slot_writes_are_out_of_place(tracker):
    """Adding a slot builds new state tensors: an earlier state, or outputs
    already handed out, never change."""
    f = _frames(np.random.RandomState(14))[0]
    pool = StreamPool(tracker, capacity=2, frame_hw=HW)
    pool.add(f, [40, 30, 30, 40])
    old = pool.state
    snapshot = [t.clone() for t in old]
    pool.add(f, [10, 10, 20, 20])
    for a, b in zip(old, snapshot):
        assert torch.equal(a, b)
    assert not torch.equal(pool.state.bbox, old.bbox)


def test_step_reads_no_tensor_value_on_the_host(models, monkeypatch):
    """Dispatching a step never reads a tensor's value on the host (on a
    card each such read waits for every queued step): ``item``,
    ``bool(tensor)``, ``tolist``, ``numpy`` and ``cpu`` are made to raise
    while the dual-template tracker with recovery and gate v2 steps, tracks
    and is dispatched through the pool."""
    from feartracker_tpu_torch.models.gate import init_gate_params

    tr = ScanTracker(models[2], CFG, device="cpu", dynamic_template=True, update_mode="feature",
                     gate_params=init_gate_params(np.random.RandomState(0)), update_interval=2,
                     recover_context=3.0)
    pool = StreamPool(tr, capacity=2, frame_hw=HW)
    seq = _frames(np.random.RandomState(15), 4)
    pool.add(seq[0], [40, 30, 30, 40])
    state = tr.init(_tile(seq[0], 2), np.array([[40, 30, 30, 40], [20, 20, 30, 30]], np.float32))

    def host_read(*args, **kwargs):
        raise AssertionError("a tensor value was read on the host while dispatching")

    for name in ("item", "__bool__", "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    state, _ = tr.step(state, _tile(seq[1], 2))
    state, _ = tr.step(state, _tile(seq[1], 2), step_index=1)
    state, _ = tr.track(state, np.stack([_tile(seq[2], 2), _tile(seq[3], 2)]), start_step=2)
    pending = [pool.step_async(_tile(seq[t], 2)) for t in (1, 2)] + [pool.step_chunk_async(seq[2:4])]
    monkeypatch.undo()
    assert [p.result()["bbox"].shape for p in pending] == [(2, 4), (2, 4), (2, 2, 4)]
