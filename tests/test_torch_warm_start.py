"""The warm-start witness: JAX's ``Trainer`` and the port's, both warm
started from the packaged ``fear_xs.npz`` (a full transfer), float32 on the
CPU, take 2 Adam steps (the default config's, lr 1e-4) of their own train
step on one fixed batch (B=2, 256² search / 128² template cut from a
rendered clip); the port's step also runs in float64 on the same batch, as
the exact arithmetic both are held to. Then each validates on a 20-frame
rendered clip.

Tolerances. The BatchNorm running statistics, as the largest |difference|
over each tensor's largest |statistic|: after the first step (the same
weights in), the port's float32 within 1e-4 of float64 and JAX's within
1e-3 (Flax computes the variance as E[x²] − E[x]² in float32, which
cancels: 3.5e-4 measured, the port's two-pass variance 3.0e-5); after the
second, both within 1e-2 (Adam's first update is ±lr wherever a gradient
is rounding noise, so any two runs part by up to 2·lr in such weights: the
port 4.3e-3 and JAX 4.1e-3 measured, the port 3.8e-4 with 8 threads). The
validation mean IoU of the port within 0.005 of JAX's, before and after
the steps: both track the clip from the warm start (IoU 0.88) and both lose
it after the two steps (0.024), as the float64 step does: the packaged
weights' BatchNorms are folded identities, and two steps of train-mode
statistics move them far."""

import copy
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.core import box_coder as jbc
from feartracker_tpu_torch.config.compose import load_config
from feartracker_tpu_torch.convert.load import torch_key
from feartracker_tpu_torch.tools.make_npy_dataset import render_clip
from feartracker_tpu_torch.train.loop import Trainer
from feartracker_tpu_torch.utils import constants as C

STAT_ONE_STEP = {"port": 1e-4, "jax": 1e-3}
STAT_TWO_STEPS = {"port": 1e-2, "jax": 1e-2}
IOU_ATOL = 0.005
VAL_FRAMES = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_clip(base, frames, boxes):
    """The clip in GOT-10k's val layout, as ``tests/test_trainer_integration.py``
    writes its sequences (cv2 ``.jpg``, read back the same by both sides)."""
    seq = os.path.join(base, "GOT-10k_Val_000000")
    os.makedirs(seq)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(seq, f"{i:08d}.jpg"), f[..., ::-1])
    with open(os.path.join(seq, "groundtruth.txt"), "w") as fh:
        fh.write("\n".join(",".join(str(int(v)) for v in b) for b in boxes))
    with open(os.path.join(base, "list.txt"), "w") as fh:
        fh.write("GOT-10k_Val_000000")


def _fixed_batch():
    """Two template/search pairs cut around the object of a rendered clip,
    normalized as the loader normalizes, with the encoded labels."""
    frames, boxes = render_clip(seed=21, n_frames=8)
    mean, std = np.asarray(C.IMAGENET_MEAN) * 255.0, np.asarray(C.IMAGENET_STD) * 255.0
    templates, searches, gts = [], [], []
    for t in (0, 5):
        x, y, w, h = boxes[t]
        cx, cy = int(x + w / 2), int(y + h / 2)
        ty, tx = np.clip(cy - 64, 0, 256 - 128), np.clip(cx - 64, 0, 480 - 128)
        sx = np.clip(cx - 128 + 17, 0, 480 - 256)
        templates.append(frames[t][ty:ty + 128, tx:tx + 128])
        searches.append(frames[t + 1][0:256, sx:sx + 256])
        bx, by, bw, bh = boxes[t + 1]
        gts.append([bx - sx, by, bw, bh])
    gt = np.asarray(gts, np.float32)
    enc = jbc.encode(jnp.asarray(gt), jbc.BoxCoderSpec())
    norm = lambda a: ((np.asarray(a, np.float32) - mean) / std).astype(np.float32)  # noqa: E731
    return {
        C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: norm(templates),
        C.TRACKER_TARGET_SEARCH_IMAGE_KEY: norm(searches),
        C.TARGET_REGRESSION_LABEL_KEY: np.asarray(enc.regression_map),
        C.TARGET_CLASSIFICATION_KEY: np.asarray(enc.classification_label),
        C.TARGET_REGRESSION_WEIGHT_KEY: np.asarray(enc.classification_label)[..., 0],
        C.TRACKER_TARGET_BBOX_KEY: gt,
        C.TARGET_VISIBILITY_KEY: np.ones((2, 1), np.float32),
    }


def _stat_error(got, ref) -> float:
    return max(float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref)


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    from feartracker_tpu.data.sequence import get_sequence_datasets as j_datasets
    from feartracker_tpu.train.loop import Trainer as JTrainer
    from feartracker_tpu_torch.data.sequence import get_sequence_datasets
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import make_train_step

    root = str(tmp_path_factory.mktemp("warm"))
    frames, boxes = render_clip(seed=40, n_frames=VAL_FRAMES)
    _write_clip(os.path.join(root, "got10k", "val"), frames, boxes)
    composed = load_config("fear_tracker", ["backend=cpu"])
    cfg = {
        "platform": "cpu", "num_devices": 1, "precision": "float32", "seed": 0,
        "model": {"name": "fear_xs", "adjust_channels": 256, "towernum": 2, "pretrained_weights": "fear_xs"},
        "tracker": composed["tracker"], "optimizer": composed["optimizer"], "max_val_samples": VAL_FRAMES,
        "experiment": {"folder": os.path.join(root, "exp"), "name": "WARM"},
        "val": {"datasets": [{"name": "got10k", "root_dir": os.path.join(root, "got10k"), "subset": "val"}]},
    }
    batch = _fixed_batch()
    jt = JTrainer(dict(copy.deepcopy(cfg), platform=""))
    jt.val_datasets = j_datasets(cfg["val"]["datasets"])
    jt.setup_state(0)
    pt = Trainer(copy.deepcopy(cfg))
    pt.val_datasets = get_sequence_datasets(cfg["val"]["datasets"])
    pt.setup_state(0)
    # the exact arithmetic: the port's step in float64 from the same start
    model64 = copy.deepcopy(pt.state.model).double()
    tx64 = build_optimizer(cfg["optimizer"])
    state64 = type(pt.state)(model=model64, opt_state=tx64.init(dict(model64.named_parameters())), step=0)
    step64 = make_train_step(tx64, spec=pt.box_spec)
    before = {"jax": jt.validate(0)["box_iou"], "port": pt.validate(0)["box_iou"]}
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    stats = []
    for _ in range(2):
        jt.state, _ = jt.train_step(jt.state, batch)
        pt.state, _ = pt.train_step(pt.state, dict(tbatch))
        state64, _ = step64(state64, {k: v.double() for k, v in tbatch.items()})
        jstats = {torch_key("batch_stats/" + "/".join(str(p.key) for p in path)): np.asarray(a, np.float64)
                  for path, a in jax.tree_util.tree_flatten_with_path(jt.state.batch_stats)[0]}
        stats.append({
            "jax": jstats,
            "port": {k: b.double().numpy() for k, b in pt.state.model.named_buffers() if k.endswith(("mean", "var"))},
            "f64": {k: b.numpy().copy() for k, b in state64.model.named_buffers() if k.endswith(("mean", "var"))},
        })
    after = {"jax": jt.validate(1)["box_iou"], "port": pt.validate(1)["box_iou"]}
    return {"before": before, "after": after, "stats": stats}


@pytest.mark.parametrize("steps,bound", [(1, STAT_ONE_STEP), (2, STAT_TWO_STEPS)], ids=["one_step", "two_steps"])
def test_batchnorm_statistics_against_float64(witness, steps, bound):
    s = witness["stats"][steps - 1]
    ref = s["f64"]
    assert set(ref) == set(s["jax"]) == set(s["port"]) and len(ref) > 100
    # the folded identities (mean 0, variance 1) moved
    assert sum(not np.allclose(ref[k], 1.0 if k.endswith("var") else 0.0) for k in ref) > 100
    err = {side: _stat_error(s[side], ref) for side in ("port", "jax")}
    print(f"BatchNorm statistics after {steps} step(s), max |error| over the tensor's max: {err}")
    assert err["port"] <= bound["port"] and err["jax"] <= bound["jax"], err
    if steps == 1:
        assert err["port"] <= err["jax"], err


def test_validation_iou_matches_jax_before_and_after(witness):
    for when in ("before", "after"):
        j, p = witness[when]["jax"], witness[when]["port"]
        assert abs(p - j) <= IOU_ATOL, (when, p, j)
    print(f"warm start IoU before {witness['before']}, after 2 steps {witness['after']}")
    # the warm start tracks the clip; two steps lose it on both sides alike
    assert witness["before"]["jax"] > 0.8 and witness["after"]["jax"] < 0.1
