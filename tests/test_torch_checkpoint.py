"""The port's checkpoints: a save/restore round trip of the whole train
state (a restored state takes the same next step as the saved one, bit for
bit on the CPU), top-k pruning and ``best_step`` equal to the JAX package's
Orbax manager on the same monitored values, and ``meta.json``."""

import os

import numpy as np
import pytest
import torch

from feartracker_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from feartracker_tpu.train.step import TrainState as JTrainState
from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.train.checkpoint import CheckpointManager
from feartracker_tpu_torch.train.optim import build_optimizer
from feartracker_tpu_torch.train.step import create_train_state, make_train_step
from feartracker_tpu_torch.utils import constants as C

SPEC = bc.BoxCoderSpec(score_size=8, total_stride=8, instance_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0, cfg=None):
    torch.manual_seed(seed)
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    tx = build_optimizer(cfg or {"name": "adam", "lr": 1e-3, "warmup_steps": 2, "skip_non_finite": 2})
    return create_train_state(model, tx, device="cpu"), tx


def _batch(seed, B=2):
    g = torch.Generator().manual_seed(seed)
    gt = torch.stack([torch.rand(B, generator=g) * 16 + 4, torch.rand(B, generator=g) * 16 + 4,
                      torch.rand(B, generator=g) * 20 + 8, torch.rand(B, generator=g) * 20 + 8], -1)
    enc = bc.encode(gt, SPEC)
    return {
        C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: torch.randn(B, 32, 32, 3, generator=g),
        C.TRACKER_TARGET_SEARCH_IMAGE_KEY: torch.randn(B, 64, 64, 3, generator=g),
        C.TARGET_REGRESSION_LABEL_KEY: enc.regression_map,
        C.TARGET_CLASSIFICATION_KEY: enc.classification_label,
        C.TARGET_REGRESSION_WEIGHT_KEY: enc.classification_label[..., 0],
        C.TRACKER_TARGET_BBOX_KEY: gt,
        C.TARGET_VISIBILITY_KEY: torch.ones(B, 1),
    }


def _equal_states(a, b):
    for (k, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), k

    def walk(x, y, path):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        else:
            assert torch.equal(x, y), path

    walk(a.opt_state, b.opt_state, "opt_state")
    assert a.step == b.step


def test_round_trip_takes_the_same_next_step(tmp_path):
    state, tx = _state(1)
    step = make_train_step(tx, spec=SPEC, guard_non_finite=True)
    for s in range(3):
        state, _ = step(state, _batch(s))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    mgr.save(state.step, state, monitor=0.5, extra={"epoch": 4, "batches": 3})
    assert mgr.has_last() and mgr.load_meta() == {"epoch": 4, "batches": 3}

    fresh, _ = _state(2)
    restored = mgr.restore_last(fresh)
    _equal_states(restored, state)
    best, _ = _state(3)
    _equal_states(mgr.restore(best), state)
    # the same next step from both
    a, ma = step(state, _batch(9))
    b, mb = step(restored, _batch(9))
    assert float(ma["loss"]) == float(mb["loss"])
    _equal_states(a, b)
    # a second manager on the same directory sees what the first saved
    again = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert again.best_step() == 3 and again.steps() == [3]


def test_files_load_weights_only(tmp_path):
    state, _ = _state(4)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    mgr.save(7, state, monitor=0.1)
    d = torch.load(os.path.join(str(tmp_path), "7", "state.pt"), weights_only=True)
    assert set(d) == {"model", "opt_state", "step"} and d["step"] == 0
    assert set(os.listdir(str(tmp_path))) == {"7", "last"}


@pytest.mark.parametrize("mode,metrics", [
    ("max", [0.5, 0.7, 0.6, 0.4, 0.8, 0.7]),
    ("min", [0.5, 0.7, 0.6, 0.4, 0.8, 0.4]),
])
def test_top_k_and_best_step_match_orbax(tmp_path, mode, metrics):
    jstate = JTrainState({"w": np.ones(3, np.float32)}, {}, (), np.int32(0))
    jmgr = JCheckpointManager(str(tmp_path / "jax"), max_to_keep=2, metric_mode=mode)
    state, _ = _state(5)
    mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=2, metric_mode=mode)
    for i, m in enumerate(metrics):
        jmgr.save(i + 1, jstate, m)
        mgr.save(i + 1, state, m)
    jmgr.save(len(metrics) + 1, jstate, None)
    mgr.save(len(metrics) + 1, state, None)
    assert sorted(os.listdir(str(tmp_path / "port"))) == sorted(
        d for d in os.listdir(str(tmp_path / "jax")) if not d.startswith("."))
    assert mgr.best_step() == jmgr.best_step()
    assert mgr.load_meta() is None


def test_bad_mode_and_missing_checkpoint_raise(tmp_path):
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), metric_mode="mean")
    state, _ = _state(6)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(state)
