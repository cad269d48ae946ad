"""The port's host tracker ``FEARTracker`` against the JAX package's on the
CPU, float32.

* A small trunk with the same random weights, in the static, smoothing,
  dual-template EMA and zoom-out recovery configurations: boxes equal,
  confidence within 1e-5 (the port folds BatchNorm into the convolutions,
  JAX applies it; boxes are integers after the reference's rounding).
* Full-width FEAR-XS with ``fear_xs.npz`` on the synthetic golden clip: the
  first 40 boxes equal the reference tracker's own trajectory
  (``tests/golden/reference_trajectory_synthetic.json``) exactly.
* The constructor's errors are JAX's."""

import inspect
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.tracker.config import TrackerConfig as JTrackerConfig
from feartracker_tpu.tracker.tracker import FEARTracker as JFEARTracker
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net, variables_from_npz
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet, build_family_model
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.tracker import FEARTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = dict(template_size=32, instance_size=64, score_size=8, total_stride=8)


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
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    v = jmodel.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    load_fear_net(model, jax.tree.map(np.asarray, v))
    frames = np.random.RandomState(3).randint(0, 255, (8, 96, 128, 3)).astype(np.uint8)
    return jmodel, v, model, frames


def _run(tracker, frames, box):
    tracker.initialize(frames[0], np.asarray(box, np.float32))
    outs = [tracker.update(f) for f in frames[1:]]
    return np.array([o["bbox"] for o in outs]), np.array([o["confidence"] for o in outs])


CONFIGS = {
    "static": ({}, {}),
    "smooth": ({"smooth": True}, {}),
    "dual_ema": ({}, dict(dynamic_template=True, update_threshold=-1.0, update_rate=0.5, update_interval=2)),
    "recover": ({}, dict(recover_context=4.0, recover_threshold=2.0)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("box", [(40, 30, 30, 40), (2, 60, 20, 30)], ids=["inside", "at_edge"])
def test_tiny_tracker_matches_jax(tiny, name, box):
    jmodel, v, model, frames = tiny
    cfg_kw, kw = CONFIGS[name]
    jboxes, jconf = _run(JFEARTracker(jmodel, v, JTrackerConfig(**TINY_CFG, **cfg_kw), **kw), frames, box)
    tracker = FEARTracker(model, TrackerConfig(**TINY_CFG, **cfg_kw), device="cpu", **kw)
    boxes, conf = _run(tracker, frames, box)
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_allclose(conf, jconf, atol=1e-5)
    if name == "dual_ema":
        assert not torch.equal(tracker._dyn_features, tracker._template_features)


def test_set_variables_refolds_and_resets(tiny):
    jmodel, v, model, frames = tiny
    tracker = FEARTracker(model, TrackerConfig(**TINY_CFG), device="cpu")
    tracker.initialize(frames[0], np.array([40, 30, 30, 40]))
    tracker.update(frames[1])
    other = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    load_fear_net(other, jax.tree.map(lambda a: np.asarray(a) * 0.5, v))
    tracker.set_variables(other)
    assert tracker._template_features is None
    with pytest.raises(RuntimeError):
        tracker.update(frames[2])
    jhalf = jax.tree.map(lambda a: np.asarray(a) * 0.5, v)
    jboxes, _ = _run(JFEARTracker(jmodel, jhalf, JTrackerConfig(**TINY_CFG)), frames, (40, 30, 30, 40))
    boxes, _ = _run(tracker, frames, (40, 30, 30, 40))
    np.testing.assert_array_equal(boxes, jboxes)


def test_fear_xs_reproduces_reference_trajectory():
    """The first 40 updates on the synthetic golden clip equal the reference
    tracker's own boxes."""
    sys.path.insert(0, REPO)
    from tools.reference_oracle import synthetic_video

    with open(os.path.join(REPO, "tests", "golden", "reference_trajectory_synthetic.json")) as fh:
        golden = json.load(fh)
    frames, init_bbox = synthetic_video(golden["synth_spec"])
    assert init_bbox == golden["initial_bbox"]
    model = load_fear_net(build_family_model("fear_xs"), variables_from_npz(PACKAGED_FEAR_XS))
    tracker = FEARTracker(model, device="cpu")
    tracker.initialize(frames[0], np.array(init_bbox))
    outs = [tracker.update(frames[i]) for i in range(1, 41)]
    boxes = [list(map(int, o["bbox"])) for o in outs]
    np.testing.assert_array_equal(np.asarray(boxes), np.asarray(golden["boxes"][:40]))
    assert min(o["confidence"] for o in outs) > 0.9
    assert len(tracker.paths) == 10 and list(tracker.paths[-1]) == boxes[-1]


@pytest.mark.parametrize("dual", [False, True], ids=["static", "dual_ema"])
def test_update_runs_through_kernel_dispatchers(tiny, monkeypatch, dual):
    """What phase 9 of chip_smoke.py counts on the card: ``initialize`` runs
    the K2 dispatcher once per expansion > 1 block, each update that many
    more plus one K1 dispatch, and a dual refresh that many again."""
    import feartracker_tpu_torch.ops.cuda.ir_block as k2
    import feartracker_tpu_torch.tracker.tracker as tracker_mod

    calls = {"K1": 0, "K2": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(k2, "fused_ir_block", counted("K2", k2.fused_ir_block))
    monkeypatch.setattr(tracker_mod, "postprocess_cuda", counted("K1", tracker_mod.postprocess_cuda))
    _, _, model, frames = tiny
    kw = CONFIGS["dual_ema"][1] if dual else {}
    n_fused = sum(s.expansion > 1 for s in TINY_TRUNK)
    _run(FEARTracker(model, TrackerConfig(**TINY_CFG), device="cpu", **kw), frames, (40, 30, 30, 40))
    n, refreshes = len(frames) - 1, (len(frames) - 1) // 2 if dual else 0
    assert calls == {"K1": n, "K2": n_fused * (1 + n + refreshes)}


@pytest.mark.parametrize("kw,err", [
    ({"recover_context": -1.0}, ValueError),
    ({"dynamic_template": True, "update_interval": 0}, ValueError),
    ({"dynamic_template": True, "native_preprocess": True}, ValueError),
    ({"native_preprocess": True}, None),
], ids=["negative_recover_context", "update_interval_0", "dual_with_native", "native"])
def test_bad_options_raise(tiny, kw, err):
    """JAX's ValueErrors for the same arguments; ``native_preprocess`` alone
    is ported now and builds (``tests/test_torch_native.py`` holds it)."""
    jmodel, v, model, _ = tiny
    if err is None:
        assert FEARTracker(model, TrackerConfig(**TINY_CFG), device="cpu", **kw).native_preprocess
        return
    with pytest.raises(err):
        FEARTracker(model, TrackerConfig(**TINY_CFG), **kw)
    if err is ValueError:
        with pytest.raises(ValueError):
            JFEARTracker(jmodel, v, JTrackerConfig(**TINY_CFG), **kw)


def test_fear_tracker_defaults_to_the_card():
    assert inspect.signature(FEARTracker).parameters["device"].default == "cuda"
