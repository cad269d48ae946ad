"""The port's dual-template path against the JAX package on the CPU at
float32: ``FEARNet.forward``/``forward_dual``, and ``ScanTracker`` with
``dynamic_template`` in each ``update_mode``, ``update_interval``,
``recover_context`` and chunked ``track(start_step=…)``.

Tolerances: 1e-4 for the tiny model's maps and template features (float32
sums in other orders); for the tiny tracker, boxes within 1e-3 px and
confidence / gate observables within 1e-4, as the static tracker is held in
tests/test_torch_runtime.py. For full-width FEAR-XS, boxes within 1 px
(boxes are rounded to integers, so a float32 difference can flip one
rounding), confidence within 1e-4 and gate observables within 1e-3 (cosines
over 16,384 features)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.evaluate import harness as jharness
from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.tracker.config import TrackerConfig as JTrackerConfig
from feartracker_tpu.tracker.runtime import ScanTracker as JScanTracker
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net
from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams
from feartracker_tpu_torch.models import gate
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.utils.constants import (
    TARGET_CLASSIFICATION_KEY as CLS,
    TARGET_REGRESSION_LABEL_KEY as REG,
)

TINY_CFG = dict(template_size=32, instance_size=64, score_size=8, total_stride=8)
WEIGHTS = os.path.dirname(PACKAGED_FEAR_XS)
FEATURE_GATE = os.path.join(WEIGHTS, "fear_xs_feature_gate.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """Tiny Flax FEARNet variables with a trained-looking ``template_gate``
    (sigmoid 0.79) and a ``cls_scale`` that lifts the random head's logits
    to O(1) (so confidences differ across streams), the port's copy, and
    S=4 streams of T=5 frames."""
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    v = jmodel.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    rng = np.random.RandomState(7)
    v = jax.tree.map(np.asarray, v)
    v["params"]["template_gate"] = np.array([1.3], np.float32)
    v["params"]["connect_model"]["cls_scale"] = np.array([300.0], np.float32)
    model = load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), v).eval()
    frames0 = rng.randint(0, 255, (4, 96, 128, 3), np.uint8)
    chunk = rng.randint(0, 255, (5, 4, 96, 128, 3), np.uint8)
    boxes = np.array([[40.0, 30, 30, 24], [60, 20, 24, 30], [20, 40, 36, 28], [70, 50, 20, 20]],
                     np.float32)
    return jmodel, v, model, frames0, chunk, boxes


def _split_threshold(confidence):
    """A threshold between the middle two of (S,) distinct confidences."""
    c = np.sort(np.asarray(confidence))
    assert len(np.unique(c)) == len(c), c
    return float((c[1] + c[2]) / 2)


@pytest.fixture(scope="module")
def frame0_threshold(tiny):
    """Midpoint of the static tracker's first-frame confidences: a refresh
    on frame 0 sees exactly these (the dynamic template still equals the
    static one), so the threshold splits the streams there."""
    jmodel, v, _, frames0, chunk, boxes = tiny
    jtr = JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG))
    _, out = jtr.step(jtr.init(frames0, boxes), chunk[0])
    return _split_threshold(out["confidence"])


def _assert_matches(out, state, jout, jstate):
    np.testing.assert_allclose(out["bbox"].numpy(), np.asarray(jout["bbox"]), atol=1e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)
    np.testing.assert_array_equal(out["failure"].numpy(), np.asarray(jout["failure"]))
    if "gate_obs" in jout:
        np.testing.assert_allclose(out["gate_obs"].numpy(), np.asarray(jout["gate_obs"]), atol=1e-4)
    np.testing.assert_allclose(state.dyn_feats.numpy(), np.asarray(jstate.dyn_feats), atol=1e-4)
    np.testing.assert_allclose(state.template_feats.numpy(), np.asarray(jstate.template_feats), atol=1e-4)


def test_tiny_forward_and_forward_dual_match_flax(tiny):
    jmodel, v, model = tiny[:3]
    rng = np.random.RandomState(8)
    template, aux = rng.rand(2, 2, 32, 32, 3).astype(np.float32)
    search = rng.rand(2, 64, 64, 3).astype(np.float32)
    ref = jmodel.apply(v, (template, search))
    ref_dual = jmodel.apply(v, (template, search, aux), method=jmodel.forward_dual)
    t, s, a = map(torch.from_numpy, (template, search, aux))
    with torch.no_grad():
        got = model((t, s))
        got_dual = model.forward_dual((t, s, a))
    for key in (CLS, REG):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(got_dual[key].numpy(), np.asarray(ref_dual[key]), atol=1e-4, rtol=1e-5)
    # the learned blend moves the classification map, and only it
    assert not np.allclose(got_dual[CLS].numpy(), got[CLS].numpy(), atol=1e-4)
    np.testing.assert_allclose(got_dual[REG].numpy(), got[REG].numpy(), atol=1e-6)


@pytest.mark.parametrize("update_interval", [1, 3])
@pytest.mark.parametrize("update_mode", ["ema", "gated", "feature"])
def test_tiny_dual_template_matches_jax(tiny, frame0_threshold, update_mode, update_interval):
    jmodel, v, model, frames0, chunk, boxes = tiny
    kw = dict(dynamic_template=True, update_mode=update_mode, update_interval=update_interval,
              update_rate=0.4)
    if update_mode == "feature":
        params = gate.init_gate_params(np.random.RandomState(9))
        params["b2"][:] = 0.5
        kw["gate_params"] = params
    else:
        kw["update_threshold"] = frame0_threshold
    jtr = JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG), **kw)
    jstate, jout = jtr.track(jtr.init(frames0, boxes), chunk)
    tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", **kw)
    state, out = tr.track(tr.init(frames0, boxes), chunk)
    _assert_matches(out, state, jout, jstate)
    if update_mode != "feature":
        # the threshold splits the streams on the first refresh frame
        above = out["confidence"][0].numpy() > kw["update_threshold"]
        assert above.any() and not above.all()
    # refresh frames carry observables; off-cadence frames carry zeros
    obs = out["gate_obs"].numpy()
    assert obs.shape == (5, 4, gate.N_OBS)
    on = [t % update_interval == 0 for t in range(5)]
    assert all(np.abs(obs[t]).sum() > 0 if o else not obs[t].any() for t, o in enumerate(on))
    assert not torch.equal(state.dyn_feats, state.template_feats)


def test_tiny_recover_context_matches_jax(tiny, frame0_threshold):
    """Zoom-out re-acquisition with a threshold that splits the streams."""
    jmodel, v, model, frames0, chunk, boxes = tiny
    thr = frame0_threshold
    kw = dict(recover_context=3.0, recover_threshold=thr)
    jtr = JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG), **kw)
    jstate, jout = jtr.track(jtr.init(frames0, boxes), chunk)
    tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", **kw)
    state, out = tr.track(tr.init(frames0, boxes), chunk)
    _assert_matches(out, state, jout, jstate)
    low = out["confidence"][0].numpy() < thr
    assert low.any() and not low.all()
    # the widened streams, and only they, leave the static trajectory
    base = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu")
    _, bout = base.track(base.init(frames0, boxes), chunk)
    np.testing.assert_array_equal(out["bbox"][:2, ~low].numpy(), bout["bbox"][:2, ~low].numpy())
    assert not np.allclose(out["bbox"][1, low].numpy(), bout["bbox"][1, low].numpy())


def test_tiny_chunked_track_equals_one_call(tiny):
    """Chunks carried with ``start_step`` keep the ``update_interval``
    cadence: two calls give what one call gives."""
    _, _, model, frames0, chunk, boxes = tiny
    tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", dynamic_template=True,
                     update_threshold=0.0, update_interval=3, recover_context=3.0)
    whole_state, whole = tr.track(tr.init(frames0, boxes), chunk)
    state, first = tr.track(tr.init(frames0, boxes), chunk[:2])
    state, second = tr.track(state, chunk[2:], start_step=2)
    for k in whole:
        np.testing.assert_array_equal(torch.cat([first[k], second[k]]).numpy(), whole[k].numpy())
    for a, b in zip(state, whole_state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # step(step_index=None) is always refresh-eligible
    _, out = tr.step(tr.init(frames0, boxes), chunk[0])
    _, out1 = tr.step(tr.init(frames0, boxes), chunk[0], step_index=1)
    assert out["gate_obs"].abs().sum() > 0 and not out1["gate_obs"].any()


def test_gate_params_dict_path_or_zoo_name(tiny):
    """``gate_params`` as a dict, an ``.npz`` path or a bare zoo name loads
    the same gate, as float32 tensors on the tracker's device."""
    model = tiny[2]
    ref = gate.load_gate(FEATURE_GATE)
    for given in (ref, FEATURE_GATE, "fear_xs_feature_gate"):
        tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", dynamic_template=True, update_mode="feature",
                         gate_params=given)
        for k in gate.GATE_KEYS:
            assert tr._gate[k].dtype == torch.float32
            np.testing.assert_array_equal(tr._gate[k].numpy(), ref[k])


@pytest.mark.parametrize("mode", ["feature_recover", "gated"])
def test_fear_xs_dual_matches_jax(mode):
    """Full-width FEAR-XS with the packaged weights, S=2, T=3."""
    if mode == "feature_recover":
        weights = PACKAGED_FEAR_XS
        kw = dict(dynamic_template=True, update_mode="feature", gate_params=FEATURE_GATE,
                  recover_context=3.0, recover_threshold=0.7, update_interval=2)
    else:
        # "gated" needs a trained template_gate; threshold 0 so the blend runs
        weights = "fear_xs_gate"
        kw = dict(dynamic_template=True, update_mode="gated", update_threshold=0.0)
    jtr, jprov = jharness.build_scan_tracker(os.path.join(WEIGHTS, f"{weights}.npz")
                                             if os.sep not in weights else weights,
                                             dtype=jnp.float32, **kw)
    f0, ch, bb = jharness.synthetic_streams(2, 3)
    jstate, jout = jtr.track(jtr.init(f0, bb), ch)
    tr, prov = build_scan_tracker(weights, torch.float32, "cpu", **kw)
    f0, ch, bb = synthetic_streams(2, 3, device="cpu")
    state, out = tr.track(tr.init(f0, bb), ch)
    assert prov == ("fear_xs" if mode == "feature_recover" else "fear_xs_gate.npz")
    assert np.abs(out["bbox"].numpy() - np.asarray(jout["bbox"])).max() <= 1.0
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)
    np.testing.assert_allclose(out["gate_obs"].numpy(), np.asarray(jout["gate_obs"]), atol=1e-3)
    np.testing.assert_allclose(state.dyn_feats.numpy(), np.asarray(jstate.dyn_feats), atol=1e-3)
    assert tuple(out["gate_obs"].shape) == (3, 2, gate.N_OBS)
