"""``FEARTracker(native_preprocess=True)`` against the JAX package's, whose
fused C++ crop engine computes the device crop op (bilinear crop of the
``extend_bbox`` window, padded with the frame's mean colour, normalized):
the port runs its own device crop at S=1. FEAR-XS in float32 on the
synthetic golden clip, 24 updates: boxes within 1 px (boxes are integers
after the reference's rounding, and the C++ engine and the two float32
contractions round the crop differently, within 1e-3), confidence within
1e-3."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from feartracker_tpu import native
from feartracker_tpu.convert.load import load_variables
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.tracker.tracker import FEARTracker as JFEARTracker
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net, variables_from_npz
from feartracker_tpu_torch.models.fear_net import build_family_model
from feartracker_tpu_torch.tracker.tracker import FEARTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_UPDATES = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    sys.path.insert(0, REPO)
    from tools.reference_oracle import synthetic_video

    with open(os.path.join(REPO, "tests", "golden", "reference_trajectory_synthetic.json")) as fh:
        spec = json.load(fh)["synth_spec"]
    frames, init_bbox = synthetic_video(spec)
    return frames[:N_UPDATES + 1], np.asarray(init_bbox)


def _run(tracker, frames, box):
    tracker.initialize(frames[0], box)
    outs = [tracker.update(f) for f in frames[1:]]
    return np.array([o["bbox"] for o in outs], np.float64), np.array([o["confidence"] for o in outs])


@pytest.mark.parametrize("recover", [False, True], ids=["static", "recover"])
def test_native_preprocess_matches_jax(clip, recover):
    if not native.available():
        pytest.skip("the JAX package's C++ crop engine did not build")
    frames, box = clip
    # recovery with a threshold above every confidence: each update crops the
    # wider window
    kw = dict(recover_context=3.0, recover_threshold=2.0) if recover else {}
    jtracker = JFEARTracker(JFEARNet(), load_variables("fear_xs"), native_preprocess=True, **kw)
    jboxes, jconf = _run(jtracker, frames, box)
    model = load_fear_net(build_family_model("fear_xs"), variables_from_npz(PACKAGED_FEAR_XS))
    tracker = FEARTracker(model, device="cpu", native_preprocess=True, **kw)
    boxes, conf = _run(tracker, frames, box)
    assert np.abs(boxes - jboxes).max() <= 1.0
    np.testing.assert_allclose(conf, jconf, atol=1e-3)
    assert np.isfinite(conf).all() and conf.min() > 0.5


def test_native_with_dynamic_template_raises():
    model = build_family_model("fear_xs")
    with pytest.raises(ValueError):
        FEARTracker(model, device="cpu", native_preprocess=True, dynamic_template=True)
