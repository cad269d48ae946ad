"""The port's training loop (``train/loop.py``) against the JAX package's
``Trainer``, on the CPU, on the fixture of
``tests/test_trainer_integration.py``: fear_tiny, 64² search / 32²
template, B=4, float32, 2 epochs of 2 steps over cv2-written ``.jpg``
clips, the JAX state's initial weights bridged into the port.

Tolerances: each step's losses and box IoU rtol 1e-5, the one-step
tolerance of ``test_torch_train_step.py`` (4 steps read at most 1.6e-6
here); validation ``box_iou`` within 1e-6 absolute (the same boxes on both
sides; JAX's rows pass through float32). The loop's decisions are exact:
the resample draws and ``frame_offset`` after every epoch, and, with
``validate`` scripted to the same monitor sequence in both loops, the
learning rate after every epoch, the epoch where early stopping fires and
the top-k checkpoint steps kept."""

import copy
import glob
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_trainer_integration import _make_track_images, _make_val_sequences

from feartracker_tpu_torch.config import yaml_lite
from feartracker_tpu_torch.config.compose import load_config
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.train.loop import Trainer
from feartracker_tpu_torch.train.optim import get_learning_rate
from feartracker_tpu_torch.train.summary import read_events, scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
VAL_IOU_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base_config(tmp_path_factory):
    import pandas as pd

    root = str(tmp_path_factory.mktemp("loop"))
    csv_path = os.path.join(root, "train.csv")
    pd.DataFrame(_make_track_images(root)).to_csv(csv_path, index=False)
    _make_val_sequences(os.path.join(root, "got10k", "val"))
    return {
        "platform": "cpu", "num_devices": 1, "sync_bn": False, "precision": "float32", "seed": 0,
        "model": {"name": "fear_tiny", "adjust_channels": 24, "towernum": 1},
        "tracker": {"score_size": 8, "total_stride": 8, "instance_size": 64, "template_size": 32,
                    "penalty_k": 0.062, "window_influence": 0.38, "lr": 0.765,
                    "template_bbox_offset": 0.2, "search_context": 2},
        "optimizer": {"name": "adam", "lr": 1e-3},
        "scheduler": {"mode": "max", "patience": 2, "factor": 0.5},
        "loss": {"coeffs": {"TARGET_CLASSIFICATION_KEY": 1, "TARGET_REGRESSION_LABEL_KEY": 1}},
        "batch_size": {"train": 4, "val": 1}, "num_workers": 1,
        "max_epochs": 2, "min_epochs": 1, "early_stopping": 5, "metric_mode": "max",
        "max_val_samples": 5, "log_every_n_steps": 1, "save_top_k": 2,
        "experiment": {"folder": os.path.join(root, "exp"), "name": "TEST"},
        "train": {"datasets": [{
            "name": "synthetic", "root": root,
            "sizes": {"search_image_size": 64, "template_image_size": 32, "search_context": 2,
                      "template_bbox_offset": 0.2, "search_image_shift": 8, "search_image_scale": 0.2,
                      "context_range": 1},
            "regression_weight_label_size": 8,
            "sampling": {"type": "track", "data_path": csv_path, "negative_ratio": 0, "frame_offset": 4,
                         "num_samples": 8, "clip_range": True},
        }]},
        "val": {"datasets": [{"name": "got10k", "root_dir": os.path.join(root, "got10k"), "subset": "val"}]},
        "dynamic_frame_offset": {"start_epoch": 1, "freq": 1, "step": 1, "max_value": 10},
    }


def _cfg(base, name, jax=False, **over):
    cfg = copy.deepcopy(base)
    cfg["experiment"]["name"] = name
    if jax:
        cfg["platform"] = ""
    cfg.update(over)
    return cfg


def _drawn(epoch_data):
    """(track, frame) of each drawn row: a DataFrame in JAX, dicts in the port."""
    rows = epoch_data.to_dict("records") if hasattr(epoch_data, "to_dict") else epoch_data
    return [(r["track_id"], int(r["frame_index"])) for r in rows]


def _record_epochs(trainer):
    """After every epoch's resample: each dataset's drawn (track, frame)
    rows and its frame_offset."""
    log = []
    original = trainer._update_frame_offset

    def wrapped(epoch):
        original(epoch)
        log.append([(_drawn(ds.item_sampler.epoch_data), ds.item_sampler.frame_offset)
                    for ds in trainer.train_dataset.datasets])

    trainer._update_frame_offset = wrapped
    return log


def _jax_variables(jt):
    import jax

    return {"params": jax.tree.map(np.asarray, jt.state.params),
            "batch_stats": jax.tree.map(np.asarray, jt.state.batch_stats)}


@pytest.fixture(scope="module")
def fits(base_config):
    """The JAX loop and the port's on the same initial weights, 2 epochs."""
    from feartracker_tpu.train.loop import Trainer as JTrainer

    jt = JTrainer(_cfg(base_config, "JAX", jax=True))
    jt.setup_data()
    jt.setup_state(0)
    variables = _jax_variables(jt)
    j_epochs = _record_epochs(jt)
    jt.fit()

    pt = Trainer(_cfg(base_config, "PORT"))
    pt.setup_data()
    pt.setup_state(0)
    load_fear_net(pt.state.model, variables)
    p_epochs = _record_epochs(pt)
    pt.fit()
    return SimpleNamespace(jax=jt, port=pt, j_epochs=j_epochs, p_epochs=p_epochs)


def _logs(trainer):
    return os.path.join(trainer.exp_dir, "logs")


def test_per_step_losses_match_jax(fits):
    j, p = scalars(read_events(_logs(fits.jax))), scalars(read_events(_logs(fits.port)))
    assert sorted(j) == sorted(p)
    for tag in ("train/loss", "train/cls_loss", "train/reg_loss", "train/box_iou"):
        assert [s for s, _ in p[tag]] == [s for s, _ in j[tag]] == [1, 2, 3, 4], tag
        np.testing.assert_allclose([v for _, v in p[tag]], [v for _, v in j[tag]], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=tag)
    assert p["train/lr"] == j["train/lr"]
    assert p["train/failure_rate"] == j["train/failure_rate"]
    np.testing.assert_allclose([v for _, v in p["train/metrics/synthetic_box_iou"]],
                               [v for _, v in j["train/metrics/synthetic_box_iou"]], rtol=LOSS_RTOL, atol=1e-7)
    assert [s for s, _ in p["valid/metrics/box_iou"]] == [-1, 0, 1]
    np.testing.assert_allclose([v for _, v in p["valid/metrics/box_iou"]],
                               [v for _, v in j["valid/metrics/box_iou"]], atol=VAL_IOU_ATOL)


def test_resample_and_curriculum_match_jax(fits):
    assert len(fits.p_epochs) == len(fits.j_epochs) == 2
    assert fits.p_epochs == fits.j_epochs
    assert [e[0][1] for e in fits.p_epochs] == [5, 6]


def test_end_to_end(fits, base_config):
    trainer = fits.port
    assert trainer.state.step == 4
    assert trainer.early_stopping.best is not None
    ckpt_dir = trainer.ckpt.directory
    assert os.path.exists(os.path.join(ckpt_dir, "last", "state.pt"))
    numbered = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    jax_numbered = sorted(int(d) for d in os.listdir(fits.jax.ckpt.directory) if d.isdigit())
    assert numbered == jax_numbered == [2, 4]
    with open(os.path.join(ckpt_dir, "last", "meta.json")) as fh:
        assert json.load(fh) == {"epoch": 2}
    events = read_events(_logs(trainer))
    images = {v["tag"] for e in events for v in e.get("summary", ()) if "image" in v}
    assert images == {"train/best_batch", "train/worst_batch"}  # the miner runs without device augs
    assert trainer.train_dataset.datasets[0].item_sampler.frame_offset > 4
    assert trainer.epoch_timing["steps"] == 2 and trainer.epoch_timing["wait_s"] >= 0


MONITORS = {
    "max": [0.1, 0.2, 0.2, 0.15, 0.3, 0.3, 0.1, 0.05, 0.0, 0.0],
    "min": [0.5, 0.4, 0.45, 0.45, 0.3, 0.35, 0.36, 0.37, 0.2, 0.4],
}


@pytest.mark.parametrize("mode", ["max", "min"])
def test_scripted_monitor_decisions_match_jax(base_config, mode):
    """Plateau LR, early stopping and top-k on the same monitor sequence:
    ``validate`` and the epoch's steps scripted (3 steps an epoch)."""
    from feartracker_tpu.train.loop import Trainer as JTrainer

    over = dict(max_epochs=10, min_epochs=4, early_stopping=3, save_top_k=2, metric_mode=mode,
                sanity_steps=0, scheduler={"mode": mode, "patience": 1, "factor": 0.5, "min_lr": 2e-4})
    seq = MONITORS[mode]
    runs = {}
    for name, cls, jax in (("jax", JTrainer, True), ("port", Trainer, False)):
        trainer = cls(_cfg(base_config, f"SCRIPT_{mode}_{name}", jax=jax, **over))
        trainer.validate = lambda epoch: {"box_iou": seq[epoch]} if epoch >= 0 else {}
        epochs, lrs = [], []

        def epoch_fn(epoch, t=trainer, jax=jax, epochs=epochs):
            epochs.append(epoch)
            if jax:
                t.state = t.state._replace(step=t.state.step + 3)
            else:
                t.state.step += 3
            return {"box_iou": 0.0}

        trainer.train_epoch = epoch_fn
        save = trainer.ckpt.save

        def save_fn(step, state, monitor, extra=None, save=save, lrs=lrs, jax=jax):
            lrs.append(float(get_learning_rate(state.opt_state)) if not jax else
                       float(state.opt_state.hyperparams["learning_rate"]))
            save(step, state, monitor, extra)

        trainer.ckpt.save = save_fn
        trainer.fit()
        kept = sorted(int(d) for d in os.listdir(trainer.ckpt.directory) if d.isdigit())
        runs[name] = (epochs, lrs, kept)
    assert runs["port"] == runs["jax"]
    epochs, lrs, kept = runs["port"]
    assert len(epochs) < 10 and len(set(lrs)) > 2  # early stopping fired; the plateau moved the LR


@pytest.fixture(scope="module")
def xs_config(tmp_path_factory):
    """FEAR-XS warm-started from fear_xs.npz (a full transfer) on two
    12-frame val sequences, where it tracks."""
    root = str(tmp_path_factory.mktemp("val"))
    _make_val_sequences(os.path.join(root, "got10k", "val"), n_seq=2, n_frames=12)
    return {
        "platform": "cpu", "num_devices": 1, "precision": "float32", "seed": 0,
        "model": {"name": "fear_xs", "adjust_channels": 256, "towernum": 2, "pretrained_weights": "fear_xs"},
        "tracker": {"penalty_k": 0.062, "window_influence": 0.38, "lr": 0.765,
                    "template_bbox_offset": 0.2, "search_context": 2},
        "optimizer": {"name": "adam", "lr": 1e-4}, "max_val_samples": 12,
        "experiment": {"folder": os.path.join(root, "exp"), "name": "XS"},
        "val": {"datasets": [{"name": "got10k", "root_dir": os.path.join(root, "got10k"), "subset": "val"}]},
    }


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_validation_matches_jax(xs_config, batched):
    from feartracker_tpu.convert.load import PACKAGED_FEAR_XS, load_npz_variables
    from feartracker_tpu.data.sequence import get_sequence_datasets as j_datasets
    from feartracker_tpu.train.loop import Trainer as JTrainer
    from feartracker_tpu_torch.data.sequence import get_sequence_datasets

    over = {"val_batched": True, "val_frame_hw": [160, 200], "val_streams": 2} if batched else {}
    cfg = dict(copy.deepcopy(xs_config), **over)
    jt = JTrainer(dict(cfg, platform=""))
    jt.val_datasets = j_datasets(cfg["val"]["datasets"])
    variables = load_npz_variables(PACKAGED_FEAR_XS)
    jt.state = SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    pt = Trainer(cfg)
    pt.val_datasets = get_sequence_datasets(cfg["val"]["datasets"])
    pt.setup_state(0)
    assert {k: len(v) for k, v in pt.transfer_report.items()} == {
        "transferred": 307, "skipped_shape": 0, "missing": 0, "unused": 0}
    want, got = jt.validate(0), pt.validate(0)
    assert sorted(got) == sorted(want)
    assert want["box_iou"] > 0.5
    for k in want:
        assert abs(got[k] - want[k]) <= VAL_IOU_ATOL, (k, got[k], want[k])
    # a later epoch swaps the new weights into the same tracker
    tracker = pt._batched_val_tracker if batched else pt._val_tracker
    with torch.no_grad():
        pt.state.model.template_gate.add_(1.0)
        pt.state.model.connect_model.cls_scale.mul_(0.5)
    again = pt.validate(1)
    assert (pt._batched_val_tracker if batched else pt._val_tracker) is tracker
    assert sorted(again) == sorted(got)


def test_validation_restores_the_caller_s_tf32_flags(xs_config):
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    pt = Trainer(dict(copy.deepcopy(xs_config), max_val_samples=3))
    from feartracker_tpu_torch.data.sequence import get_sequence_datasets

    pt.val_datasets = get_sequence_datasets(xs_config["val"]["datasets"])
    pt.setup_state(0)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        pt.validate(0)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_resume_from_last(base_config):
    """max_epochs is the total: a 1-epoch run resumed at max_epochs=1 trains
    nothing, at max_epochs=2 exactly one more epoch."""
    cfg = _cfg(base_config, "RESUME", max_epochs=1)
    first = Trainer(cfg)
    first.fit()
    steps = first.state.step
    noop = Trainer(dict(copy.deepcopy(cfg), resume=True, max_epochs=1))
    noop.fit()
    assert noop.state.step == steps and noop.resumed_epoch == 1
    resumed = Trainer(dict(copy.deepcopy(cfg), resume=True, max_epochs=2))
    resumed.fit()
    assert resumed.state.step == 2 * steps
    # the restored weights are the first run's before the second epoch
    fresh = Trainer(_cfg(base_config, "RESUME_FRESH"))
    fresh.setup_state()
    restored = first.ckpt.restore_last(fresh.state)
    assert restored.step == 2 * steps


def test_resume_epoch_survives_dataset_size_change(base_config):
    cfg = _cfg(base_config, "RESUME_SIZED", max_epochs=2)
    first = Trainer(cfg)
    first.fit()  # 2 epochs of 8 samples: the last checkpoint records epoch 2
    bigger = copy.deepcopy(cfg)
    bigger["train"]["datasets"][0]["sampling"]["num_samples"] = 12
    bigger["resume"] = True
    noop = Trainer(copy.deepcopy(bigger))
    noop.fit()
    assert noop.resumed_epoch == 2 and noop.state.step == first.state.step
    third = Trainer(dict(copy.deepcopy(bigger), max_epochs=3))
    third.fit()
    assert third.resumed_epoch == 2
    assert third.state.step == first.state.step + 3  # one epoch at the new size


def test_checkpoint_restore_roundtrip(base_config):
    trainer = Trainer(_cfg(base_config, "ROUNDTRIP", max_epochs=1))
    trainer.fit()
    fresh = Trainer(_cfg(base_config, "ROUNDTRIP2"))
    fresh.setup_state()
    restored = trainer.ckpt.restore_last(fresh.state)
    a, b = restored.model.state_dict(), trainer.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert restored.step == trainer.state.step


def test_device_augs_on_npy_frames(tmp_path, base_config):
    """The card host's data path on the CPU: ``.npy`` clips from
    ``tools/make_npy_dataset.py`` (the CSV's columns are
    ``tools/make_synthetic_dataset.py``'s), staged items, device
    augmentations in the step, no mosaics."""
    import csv

    from feartracker_tpu_torch.tools.make_npy_dataset import COLUMNS, write_npy_dataset

    csv_path = write_npy_dataset(str(tmp_path / "npy"), clips=2, frames=8, hw=(96, 128))
    pytest.importorskip("pandas")
    sys.path.insert(0, REPO)
    from tools.make_synthetic_dataset import generate

    ref_csv = generate(str(tmp_path / "synth"), tracks=1, frames=2, val_sequences=0)
    with open(csv_path) as a, open(ref_csv) as b:
        assert next(csv.reader(a)) == next(csv.reader(b)) == list(COLUMNS)

    cfg = _cfg(base_config, "NPY", max_epochs=1, device_augs=True, sanity_steps=0)
    ds = cfg["train"]["datasets"][0]
    ds["root"] = str(tmp_path / "npy")
    ds["sampling"].update(data_path=csv_path, num_samples=8, frame_offset=4)
    cfg["val"] = {"datasets": []}
    trainer = Trainer(cfg)
    trainer.fit()
    assert trainer.state.step == 2
    events = read_events(_logs(trainer))
    losses = scalars(events)["train/loss"]
    assert [s for s, _ in losses] == [1, 2] and all(np.isfinite(v) for _, v in losses)
    assert not any("image" in v for e in events for v in e.get("summary", ()))
    # no val data: the monitor is the train box IoU, and a checkpoint is ranked
    assert trainer.ckpt.steps() == [2]


def test_entry_points_need_the_card_or_the_cpu(base_config, monkeypatch):
    for platform in ("", "gpu"):
        if torch.cuda.is_available():
            assert Trainer(_cfg(base_config, "CARD", platform=platform)).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                Trainer(_cfg(base_config, "NOCARD", platform=platform))
    with pytest.raises(ValueError, match="platform"):
        Trainer(_cfg(base_config, "TPU", platform="tpu"))
    # data parallelism is one process a card: without torchrun's variables
    # or the coordinator keys there is no group to join
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for over in ({"num_devices": 2}, {"distributed": {"enabled": True}}):
        with pytest.raises(ValueError, match="torchrun"):
            Trainer(_cfg(base_config, "DP", **over))


def test_cli_trains_in_a_subprocess(tmp_path):
    pytest.importorskip("pandas")
    sys.path.insert(0, REPO)
    from tools.make_synthetic_dataset import generate

    data = tmp_path / "data"
    generate(str(data / "got10k"), tracks=2, frames=8, val_sequences=1, seed=5)
    os.rename(str(data / "got10k" / "got10k" / "val"), str(data / "got10k" / "val"))
    exp = tmp_path / "exp"
    overrides = ["backend=cpu", "model=fear_tiny", "tracker=tiny_tracker", "utility_overrides=local_fast",
                 f"visual_object_tracking_datasets={data}", f"experiment.folder={exp}", "experiment.name=CLI",
                 "max_val_samples=4", "sizes.search_image_shift=8", "sizes.search_image_scale=0.2",
                 "sizes.context_range=1", "train.datasets.0.sampling.num_samples=8", "log_every_n_steps=1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "feartracker_tpu_torch.train", *overrides],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    exp_dir = exp / "CLI"
    with open(exp_dir / "experiment_config.yaml") as fh:
        assert yaml_lite.load(fh.read()) == load_config("fear_tracker", overrides)
    assert (exp_dir / "checkpoints" / "last" / "state.pt").exists()
    with open(exp_dir / "checkpoints" / "last" / "meta.json") as fh:
        assert json.load(fh) == {"epoch": 1}
    losses = scalars(read_events(str(exp_dir / "logs")))["train/loss"]
    assert [s for s, _ in losses] == [1, 2, 3, 4]  # 8 samples in batches of 2
    assert glob.glob(str(exp_dir / "logs" / "events.out.tfevents.*"))


def test_loop_timing_refuses_without_cuda():
    proc = subprocess.run([sys.executable, "loop_timing.py"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
    assert "{" not in proc.stdout


def test_loop_timing_one_thread_is_the_worker_s_own_setting():
    """``loop_timing.py``'s ``one_thread`` way: each thread that makes items
    drops to one intra-op thread; the stepping thread keeps its own."""
    import threading

    sys.path.insert(0, REPO)
    from loop_timing import _OneThread

    seen = []
    dataset = _OneThread([10, 11])
    main = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        t = threading.Thread(target=lambda: seen.append((dataset[1], torch.get_num_threads())))
        t.start()
        t.join()
        assert seen == [(11, 1)] and len(dataset) == 2
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(main)
