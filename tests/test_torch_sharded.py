"""The port's stream-sharded tracker (``parallel/inference.py``) on two and
four CPU "devices" (``devices=["cpu"] * N``) against JAX's
``ShardedScanTracker`` on ``make_mesh(2)`` and against the port's own
``ScanTracker``; ``StreamPool`` over it; ``batched_evaluate`` padding a
group to the device count. The tiny model (TINY_TRUNK, 16 channels, one
tower), 96×128 uint8 frames.

Tolerances: against JAX, boxes atol 1e-3 (JAX's own sharded test's) and
confidence atol 1e-4 (``tests/test_torch_runtime.py``'s); against the port's
``ScanTracker``, equal bit for bit: on the CPU every shard runs the same
plain ops on its block of rows, and no op of the step mixes streams."""

import jax
import numpy as np
import pytest
import torch
from test_trainer_integration import _make_val_sequences

from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.models.gate import init_gate_params as j_init_gate_params
from feartracker_tpu.parallel.inference import ShardedScanTracker as JShardedScanTracker
from feartracker_tpu.parallel.mesh import make_mesh as j_make_mesh
from feartracker_tpu.tracker.config import TrackerConfig as JTrackerConfig
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.models.gate import init_gate_params
from feartracker_tpu_torch.parallel.inference import ShardedScanTracker, ShardedState
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker, StreamState
from feartracker_tpu_torch.tracker.serving import StreamPool

TINY_CFG = dict(score_size=8, total_stride=8, instance_size=64, template_size=32)
CFG, JCFG = TrackerConfig(**TINY_CFG), JTrackerConfig(**TINY_CFG)
HW = (96, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _biased_gate(init, bias: float):
    """A gate whose output is pinned by the final bias (w2 = 0), as
    ``tests/test_feature_gate.py`` builds it."""
    params = init(np.random.RandomState(0))
    params["w2"][:] = 0.0
    params["b2"][:] = bias
    return params


MODES = {
    "static": {},
    "dynamic": dict(dynamic_template=True, update_threshold=0.0),
    "update_interval": dict(dynamic_template=True, update_threshold=-1.0, update_interval=2),
    "gated": dict(dynamic_template=True, update_threshold=-1.0, update_mode="gated"),
    "feature": dict(dynamic_template=True, update_mode="feature", update_rate=0.2),
}


def _kw(mode, init):
    kw = dict(MODES[mode])
    if mode == "feature":
        kw["gate_params"] = _biased_gate(init, 0.0)
    return kw


@pytest.fixture(scope="module")
def setup():
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    v = jmodel.init(jax.random.PRNGKey(0), (np.zeros((1, 32, 32, 3), np.float32),
                                             np.zeros((1, 64, 64, 3), np.float32)), train=False)
    v = jax.tree.map(np.asarray, v)
    model = load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), v)
    rng = np.random.RandomState(0)
    S, T = 4, 4
    frames0 = rng.randint(0, 255, (S,) + HW + (3,)).astype(np.uint8)
    chunk = rng.randint(0, 255, (T, S) + HW + (3,)).astype(np.uint8)
    bboxes = np.stack([[40 + 2 * i, 30 + i, 30, 40] for i in range(S)]).astype(np.float32)
    return jmodel, v, model, frames0, chunk, bboxes


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sharded_matches_jax_and_the_single_tracker(setup, mode):
    jmodel, v, model, frames0, chunk, bboxes = setup
    jtr = JShardedScanTracker(jmodel, v, JCFG, mesh=j_make_mesh(2), **_kw(mode, j_init_gate_params))
    jstate, jout = jtr.track(jtr.init(frames0, bboxes), chunk)

    sharded = ShardedScanTracker(model, CFG, devices=["cpu", "cpu"], **_kw(mode, init_gate_params))
    state, out = sharded.track(sharded.init(frames0, bboxes), chunk)
    assert isinstance(state, ShardedState) and len(state) == 2 and state[0].bbox.shape == (2, 4)
    np.testing.assert_allclose(out["bbox"].numpy(), np.asarray(jout["bbox"]), atol=1e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)
    np.testing.assert_allclose(state.bbox.numpy(), np.asarray(jstate.bbox), atol=1e-3)

    single = ScanTracker(model, CFG, device="cpu", **_kw(mode, init_gate_params))
    s_state, s_out = single.track(single.init(frames0, bboxes), chunk)
    _equal(out, s_out)
    for f in StreamState._fields:
        assert torch.equal(getattr(state, f), getattr(s_state, f)), f
    if mode != "static":
        assert not torch.equal(state.dyn_feats, state.template_feats)
    # one more frame through step, with the cadence index
    state, out = sharded.step(state, chunk[0], step_index=4)
    s_state, s_out = single.step(s_state, chunk[0], step_index=4)
    _equal(out, s_out)


def test_four_shards_and_scan_unroll(setup):
    _, _, model, frames0, chunk, bboxes = setup
    single = ScanTracker(model, CFG, device="cpu")
    _, s_out = single.track(single.init(frames0, bboxes), chunk)
    for kw in (dict(devices=["cpu"] * 4), dict(devices=["cpu"] * 2, scan_unroll=2)):
        sharded = ShardedScanTracker(model, CFG, **kw)
        _, out = sharded.track(sharded.init(frames0, bboxes), chunk)
        _equal(out, s_out)


def test_shared_frames_match_tiled(setup):
    """Multi-object mode: one video for all S objects equals the same video
    tiled per stream, in track and in step (JAX's sharded test's check)."""
    _, _, model, frames0, chunk, bboxes = setup
    sharded = ShardedScanTracker(model, CFG, devices=["cpu", "cpu"])
    video0, video = frames0[0], chunk[:, 0]
    S = len(bboxes)
    st_shared, out_shared = sharded.track(sharded.init(video0, bboxes), video)
    tiled0 = np.broadcast_to(video0, (S,) + video0.shape).copy()
    tiled = np.broadcast_to(video[:, None], (video.shape[0], S) + video0.shape).copy()
    st_tiled, out_tiled = sharded.track(sharded.init(tiled0, bboxes), tiled)
    _equal(out_shared, out_tiled)
    _, o1 = sharded.step(st_shared, video0)
    _, o2 = sharded.step(st_tiled, tiled0)
    _equal(o1, o2)


def test_streams_must_divide_and_state_must_match(setup):
    _, _, model, frames0, chunk, bboxes = setup
    sharded = ShardedScanTracker(model, CFG, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="divide"):
        sharded.init(frames0[:3], bboxes[:3])
    single = ScanTracker(model, CFG, device="cpu")
    with pytest.raises(ValueError, match="ShardedState"):
        sharded.track(single.init(frames0, bboxes), chunk)


def test_set_variables_reaches_every_replica(setup):
    _, _, model, frames0, chunk, bboxes = setup
    other = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    torch.manual_seed(5)
    with torch.no_grad():
        for p in other.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    sharded = ShardedScanTracker(model, CFG, devices=["cpu", "cpu"])
    sharded.set_variables(other)
    fresh = ScanTracker(other, CFG, device="cpu")
    _, out = sharded.track(sharded.init(frames0, bboxes), chunk)
    _, want = fresh.track(fresh.init(frames0, bboxes), chunk)
    _equal(out, want)


def test_pool_on_sharded_tracker_matches_single(setup):
    """StreamPool over the sharded tracker, slots on both shards: each slot's
    boxes equal the pool over ScanTracker's (``tests/test_serving.py``)."""
    _, _, model, frames0, chunk, _ = setup
    pools = {}
    for name, tr in (("single", ScanTracker(model, CFG, device="cpu")),
                     ("sharded", ShardedScanTracker(model, CFG, devices=["cpu", "cpu"]))):
        pool = StreamPool(tr, capacity=4, frame_hw=HW)
        for f, box in zip(frames0, ([40, 30, 30, 40], [10, 10, 20, 20], [50, 40, 24, 30])):
            pool.add(f, box)
        outs = [pool.step(chunk[t]) for t in range(2)]
        outs.append(pool.step(chunk[2, 0]))  # one frame shared by every slot
        pool.remove(1)
        chunk_out = pool.step_chunk(chunk[:2])
        pools[name] = (np.stack([o["bbox"] for o in outs]), chunk_out["bbox"], chunk_out["failure"])
        if name == "sharded":
            assert isinstance(pool.state, ShardedState) and pool.state[1].bbox.shape == (2, 4)
    for a, b in zip(pools["single"], pools["sharded"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        StreamPool(ShardedScanTracker(model, CFG, devices=["cpu", "cpu"]), capacity=3, frame_hw=HW)


@pytest.mark.parametrize("streams", [3, 4])
def test_batched_evaluate_pads_to_the_device_count(setup, tmp_path, streams):
    """Three sequences over two shards: a group of 3 is tracked as 4 (the
    last sequence repeated), and the scores equal ScanTracker's."""
    from feartracker_tpu_torch.data.sequence import get_sequence_datasets

    _, _, model, *_ = setup
    _make_val_sequences(str(tmp_path / "got10k" / "val"), n_seq=3, n_frames=6)
    (ds,) = get_sequence_datasets([{"name": "got10k", "root_dir": str(tmp_path / "got10k"), "subset": "val"}])
    sharded = ShardedScanTracker(model, CFG, devices=["cpu", "cpu"])
    tracked = []
    track = sharded.track

    def spy(state, frames, start_step=0):
        tracked.append(frames.shape[1])
        return track(state, frames, start_step)

    sharded.track = spy
    got = batched_evaluate(sharded, ds, streams=streams, frame_hw=HW)
    want = batched_evaluate(ScanTracker(model, CFG, device="cpu"), ds, streams=streams, frame_hw=HW)
    assert set(tracked) == {4}
    assert got["num_sequences"] == want["num_sequences"] == 3
    assert sorted(got["per_sequence"]) == sorted(want["per_sequence"])
    for name in want["per_sequence"]:
        np.testing.assert_array_equal(got["per_sequence"][name], want["per_sequence"][name])
    assert got["ao"] == want["ao"]
