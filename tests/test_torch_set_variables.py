"""``ScanTracker.set_variables`` and ``FEARTracker.set_variables`` on the CPU:
after a swap to model B, a tracker built on model A gives what a fresh
tracker on B gives, bit for bit, in float32 and bfloat16, eagerly and in
``scan_unroll`` units. B differs from A in the trunk, the head and
``template_gate``, and the dual template runs in "gated" mode (which reads
``sigmoid(template_gate)``) with a zero threshold, so a swap that leaves
any of the three behind gives other outputs (checked: each half swap)."""

import numpy as np
import pytest
import torch

from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.fused_trunk import fold_fear_net
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker, _copy_tensors
from feartracker_tpu_torch.tracker.tracker import FEARTracker

CFG = TrackerConfig(score_size=8, total_stride=8, instance_size=64, template_size=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed):
    torch.manual_seed(seed)
    m = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    with torch.no_grad():
        for n, b in m.named_buffers():
            if n.endswith("running_var"):
                b.uniform_(0.5, 1.5)
            elif n.endswith("running_mean"):
                b.normal_(0, 0.1)
        m.template_gate.fill_(0.3 + seed)
    return m.eval()


def _inputs():
    rng = np.random.RandomState(0)
    f0 = rng.randint(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    frames = rng.randint(0, 256, (5, 2, 96, 128, 3)).astype(np.uint8)
    boxes = np.array([[30, 30, 20, 24], [50, 40, 16, 16]], np.float32)
    return f0, frames, boxes


def _run(tracker):
    f0, frames, boxes = _inputs()
    state, out = tracker.track(tracker.init(f0, boxes), frames)
    return {**out, "dyn_feats": state.dyn_feats, "template_feats": state.template_feats}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


KW = dict(device="cpu", dynamic_template=True, update_mode="gated", update_threshold=0.0)
CASES = [(dt, k) for dt in (torch.float32, torch.bfloat16) for k in (1, 2)]


@pytest.mark.parametrize("dtype,unroll", CASES, ids=[f"{str(d)[6:]}-unroll{k}" for d, k in CASES])
def test_scan_tracker_swap_equals_a_fresh_tracker(dtype, unroll):
    a, b = _model(0), _model(1)
    tracker = ScanTracker(a, CFG, dtype=dtype, scan_unroll=unroll, **KW)
    before = _run(tracker)  # units (and their buffers) exist before the swap
    held = [t.data_ptr() for t in (tracker._template_gate, tracker.folded["stem"]["w"],
                                    next(tracker.model.parameters()))]
    tracker.set_variables(b)
    got, want = _run(tracker), _run(ScanTracker(b, CFG, dtype=dtype, scan_unroll=unroll, **KW))
    assert _equal(got, want)
    assert not torch.equal(before["bbox"], want["bbox"])
    # the tensors stay where they were (captured graphs keep reading them)
    assert held == [t.data_ptr() for t in (tracker._template_gate, tracker.folded["stem"]["w"],
                                           next(tracker.model.parameters()))]
    if dtype == torch.bfloat16:
        assert all("packed" in blk for blk, s in zip(tracker.folded["blocks"], TINY_TRUNK) if s.expansion > 1)
    # the model passed in is not changed
    assert torch.equal(b.template_gate, _model(1).template_gate)


@pytest.mark.parametrize("left_out", ["folded", "model", "template_gate"])
def test_a_half_swap_is_caught(left_out):
    """Each of the three pieces changes the outputs on its own."""
    a, b = _model(0), _model(1)
    tracker = ScanTracker(a, CFG, **KW)
    src = b.float().eval()
    with torch.no_grad():
        if left_out != "folded":
            _copy_tensors(tracker.folded, fold_fear_net(src), "folded")
        if left_out != "template_gate":
            tracker._template_gate.copy_(torch.sigmoid(src.template_gate))
        if left_out != "model":
            _copy_tensors(tracker.model.state_dict(), src.state_dict(), "model")
    assert not _equal(_run(tracker), _run(ScanTracker(b, CFG, **KW)))


def test_swap_refuses_another_architecture():
    tracker = ScanTracker(_model(0), CFG, device="cpu")
    with pytest.raises(ValueError, match="trunk"):
        tracker.set_variables(FEARNet(template_size=32))
    other_head = FEARNet(TINY_TRUNK, adjust_channels=24, towernum=1, template_size=32)
    with pytest.raises(ValueError, match="differs"):
        tracker.set_variables(other_head)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_fear_tracker_swap_equals_a_fresh_tracker(dtype):
    f0, frames, boxes = _inputs()

    def run(tracker):
        tracker.initialize(f0[0], boxes[0])
        return [tracker.update(f)["bbox"] for f in frames[:, 0]]

    a, b = _model(0), _model(1)
    tracker = FEARTracker(a, CFG, dtype=dtype, device="cpu")
    before = run(tracker)
    tracker.set_variables(b)
    got, want = run(tracker), run(FEARTracker(b, CFG, dtype=dtype, device="cpu"))
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert not np.array_equal(np.asarray(before), np.asarray(want))
