"""``ScanTracker(scan_unroll=K)`` on the CPU: units of K frames (CUDA graphs
on the card, the same steps run eagerly here) give exactly the outputs and
state of the frame-by-frame loop, static and dual-template, with a remainder
of T mod K frames; the tiny model at K=2 matches JAX's
``ScanTracker(scan_unroll=2)`` within ``tests/test_torch_runtime.py``'s
tolerances (bbox 1e-3 px, confidence 1e-4)."""

import jax
import numpy as np
import pytest
import torch

from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.tracker.config import TrackerConfig as JTrackerConfig
from feartracker_tpu.tracker.runtime import ScanTracker as JScanTracker
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker

TINY_CFG = dict(template_size=32, instance_size=64, score_size=8, total_stride=8)
T = 7  # a multiple of none of K = 2, 3, 4
DUAL = dict(dynamic_template=True, update_mode="ema", update_threshold=0.0, update_interval=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    v = jmodel.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    load_fear_net(model, jax.tree.map(np.asarray, v))
    rng = np.random.RandomState(5)
    frames0 = rng.randint(0, 255, (2, 96, 128, 3), np.uint8)
    chunk = rng.randint(0, 255, (T, 2, 96, 128, 3), np.uint8)
    boxes = np.array([[40.0, 30, 30, 24], [60, 20, 24, 30]], np.float32)
    return jmodel, v, model, frames0, chunk, boxes


def _two_chunks(tracker, frames0, chunk, boxes, start_step):
    """Two ``track`` calls back to back; call 1's outputs are copied before
    call 2 and must not have changed after it."""
    state, out1 = tracker.track(tracker.init(frames0, boxes), chunk, start_step=start_step)
    kept = {k: v.clone() for k, v in out1.items()}
    state, out2 = tracker.track(state, chunk[::-1].copy(), start_step=start_step + T)
    for k in kept:
        assert torch.equal(out1[k], kept[k]), k
    return state, out1, out2


@pytest.mark.parametrize("dual", [False, True], ids=["static", "dual"])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_unrolled_equals_frame_by_frame(tiny, K, dual):
    _, _, model, frames0, chunk, boxes = tiny
    kw = DUAL if dual else {}
    ref = _two_chunks(ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", **kw),
                      frames0, chunk, boxes, start_step=1)
    tracker = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", scan_unroll=K, **kw)
    got = _two_chunks(tracker, frames0, chunk, boxes, start_step=1)
    for a, b in zip(ref[0], got[0]):
        assert torch.equal(a, b)
    for want, have in zip(ref[1:], got[1:]):
        assert sorted(want) == sorted(have)
        for k in want:
            assert have[k].shape[0] == T and torch.equal(want[k], have[k]), k
    # one unit per cadence phase met: start frames 1, 1+K, ... mod 4
    phases = {(s + t0) % 4 for s in (1, 1 + T) for t0 in range(0, T - T % K, K)} if dual else {0}
    assert sorted(key[-1] for key in tracker._unrolled) == sorted(phases)
    if dual:
        assert not torch.equal(got[0].dyn_feats, got[0].template_feats)


def test_shared_and_expanded_frames_keep_one_copy(tiny):
    """A (T, H, W, 3) chunk and its expanded (T, S, H, W, 3) view run as one
    shared buffer, with the per-stream result."""
    _, _, model, frames0, chunk, boxes = tiny
    tracker = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", scan_unroll=2)
    video = torch.from_numpy(chunk[:, 0].copy())
    state = tracker.init(frames0[0], boxes)
    _, shared = tracker.track(state, video)
    _, expanded = tracker.track(state, video[:, None].expand(T, 2, *video.shape[1:]))
    _, per_stream = tracker.track(state, np.stack([chunk[:, 0]] * 2, axis=1))
    units = list(tracker._unrolled.values())
    assert len(units) == 2  # shared (both calls), then per-stream
    assert tuple(units[0].frames.shape) == (2, 96, 128, 3)
    for k in shared:
        assert torch.equal(shared[k], expanded[k]) and torch.equal(shared[k], per_stream[k]), k


def test_tiny_unroll_matches_jax(tiny):
    jmodel, v, model, frames0, chunk, boxes = tiny
    jtr = JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG), scan_unroll=2)
    _, jout = jtr.track(jtr.init(frames0, boxes), chunk)
    tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", scan_unroll=2)
    _, out = tr.track(tr.init(frames0, boxes), chunk)
    np.testing.assert_allclose(out["bbox"].numpy(), np.asarray(jout["bbox"]), atol=1e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)


@pytest.mark.parametrize("K", [0, -1])
def test_unroll_below_one_raises(tiny, K):
    with pytest.raises(ValueError):
        ScanTracker(tiny[2], TrackerConfig(**TINY_CFG), device="cpu", scan_unroll=K)
