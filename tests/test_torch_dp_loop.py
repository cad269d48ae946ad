"""The port's training loop in two real processes over Gloo on the CPU
(``tests/torch_dist_worker.py``, 180 s limit each run), on the fixture of
``tests/test_trainer_integration.py`` / ``tests/test_multihost_real.py``:
fear_tiny, 64² search / 32² template, float32, ``num_devices: 2`` with a
global batch of 4 (2 a process), 2 epochs, three validation sequences.

Exact: both ranks end with the same parameters and statistics bit for bit;
the rows the ranks' validation gathers are, as a set, the rows one process
computes on the same weights; the loaders' shards are disjoint and
exhaustive; rank 0 alone writes the event log and the checkpoints; and a
resume where one rank sees no ``last`` checkpoint raises on both."""

import copy
import glob
import os

import numpy as np
import pytest
import torch
from test_trainer_integration import _make_track_images, _make_val_sequences
from torch_dist_worker import run_workers

from feartracker_tpu_torch.parallel import multihost
from feartracker_tpu_torch.train.loop import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dp_config(tmp_path_factory):
    import pandas as pd

    root = str(tmp_path_factory.mktemp("dploop"))
    csv_path = os.path.join(root, "train.csv")
    pd.DataFrame(_make_track_images(root)).to_csv(csv_path, index=False)
    _make_val_sequences(os.path.join(root, "got10k", "val"), n_seq=3)
    return {
        "platform": "cpu", "num_devices": 2, "sync_bn": True, "precision": "float32", "seed": 0,
        "distributed": {"enabled": True, "backend": "gloo"},
        "model": {"name": "fear_tiny", "adjust_channels": 24, "towernum": 1},
        "tracker": {"score_size": 8, "total_stride": 8, "instance_size": 64, "template_size": 32,
                    "penalty_k": 0.062, "window_influence": 0.38, "lr": 0.765,
                    "template_bbox_offset": 0.2, "search_context": 2},
        "optimizer": {"name": "adam", "lr": 1e-3},
        "scheduler": {"mode": "max", "patience": 2, "factor": 0.5},
        "batch_size": {"train": 4, "val": 1}, "num_workers": 1,
        "max_epochs": 2, "min_epochs": 1, "early_stopping": 5, "metric_mode": "max",
        "max_val_samples": 5, "log_every_n_steps": 1, "save_top_k": 2,
        "experiment": {"folder": os.path.join(root, "exp"), "name": "DP"},
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
    }


@pytest.fixture(scope="module")
def dp_run(dp_config, tmp_path_factory):
    return run_workers("loop", 2, {"config": {"trainer": dp_config}}, tmp_path_factory.mktemp("dprun"),
                       timeout=180)


def test_ranks_end_bit_identical(dp_run):
    a, b = dp_run
    assert int(a["step"]) == int(b["step"]) == 4  # 8 samples, 2 a process a step, 2 epochs
    assert int(a["batch_size"]) == int(b["batch_size"]) == 2
    keys = [k for k in a if k.startswith(("param/", "stat/"))]
    assert len(keys) > 50 and set(keys) == {k for k in b if k.startswith(("param/", "stat/"))}
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the shards the two ranks read are disjoint and cover the epoch
    assert not set(a["loader"]) & set(b["loader"])
    assert sorted(set(a["loader"]) | set(b["loader"])) == list(range(8))


def test_gathered_validation_rows_equal_one_process(dp_run, dp_config, monkeypatch):
    """The sanity validation (before any step, so the weights are the
    seeded initial ones): the rows both ranks gathered equal, as a set, one
    process's rows over the three sequences."""
    a, b = dp_run
    assert sorted(k for k in a if k.startswith("rows/")) == ["rows/0", "rows/1", "rows/2"]  # sanity + 2 epochs
    for k in ("rows/0", "rows/1", "rows/2"):
        np.testing.assert_array_equal(a[k], b[k])
    rows = []
    monkeypatch.setattr(multihost, "allgather_rows",
                        lambda r: rows.append(np.asarray(r, np.float32).reshape(-1, 3)) or rows[-1])
    cfg = copy.deepcopy(dp_config)
    cfg.update(num_devices=1, distributed={}, sync_bn=False)
    cfg["experiment"]["name"] = "ONE"
    one = Trainer(cfg)
    one.setup_data()
    one.setup_state(0)
    one.validate(-1)
    assert len(rows[0]) == 3 and len(a["rows/0"]) == 3
    assert sorted(map(tuple, a["rows/0"].tolist())) == sorted(map(tuple, rows[0].tolist()))


def test_only_rank_zero_writes(dp_run, dp_config):
    a, b = dp_run
    assert bool(a["is_master"]) and not bool(b["is_master"])
    assert not bool(a["writer_null"]) and bool(b["writer_null"])
    exp = os.path.join(dp_config["experiment"]["folder"], "DP")
    assert len(glob.glob(os.path.join(exp, "logs", "events.out.tfevents.*"))) == 1
    kept = sorted(d for d in os.listdir(os.path.join(exp, "checkpoints")) if d.isdigit())
    assert kept == ["2", "4"] and os.path.isdir(os.path.join(exp, "checkpoints", "last"))


def test_resume_raises_when_one_rank_sees_no_checkpoint(dp_run, dp_config, tmp_path):
    seen = dict(copy.deepcopy(dp_config), resume=True, max_epochs=3)
    unseen = copy.deepcopy(seen)
    unseen["experiment"] = {"folder": str(tmp_path / "elsewhere"), "name": "DP"}
    outs = run_workers("resume", 2, {"config": {"trainer": seen, "trainer_other": unseen}}, tmp_path, timeout=180)
    for o in outs:
        assert "visibility differs" in str(o["raised"]), o["raised"]


def test_cli_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2 -m feartracker_tpu_torch.train`` on the
    CPU over Gloo: env:// from torchrun's variables, 2 a process of a host
    batch of 4, rank 0 alone writes the config, the event log and the
    checkpoints (180 s limit)."""
    import subprocess
    import sys

    from torch_dist_worker import REPO, free_port

    from feartracker_tpu_torch.train.summary import read_events, scalars

    pytest.importorskip("pandas")
    sys.path.insert(0, REPO)
    from tools.make_synthetic_dataset import generate

    data = tmp_path / "data"
    generate(str(data / "got10k"), tracks=2, frames=8, val_sequences=1, seed=5)
    os.rename(str(data / "got10k" / "got10k" / "val"), str(data / "got10k" / "val"))
    exp = tmp_path / "exp"
    overrides = ["backend=cpu", "num_devices=2", "distributed.enabled=true", "distributed.backend=gloo",
                 "batch_size=4", "model=fear_tiny", "tracker=tiny_tracker", "utility_overrides=local_fast",
                 f"visual_object_tracking_datasets={data}", f"experiment.folder={exp}", "experiment.name=TR",
                 "max_val_samples=4", "sizes.search_image_shift=8", "sizes.search_image_scale=0.2",
                 "sizes.context_range=1", "train.datasets.0.sampling.num_samples=8", "log_every_n_steps=1"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
                           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
                           "-m", "feartracker_tpu_torch.train", *overrides],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    exp_dir = exp / "TR"
    assert (exp_dir / "experiment_config.yaml").exists()
    assert len(glob.glob(str(exp_dir / "logs" / "events.out.tfevents.*"))) == 1
    losses = scalars(read_events(str(exp_dir / "logs")))["train/loss"]
    assert [s for s, _ in losses] == [1, 2]  # 8 samples, 2 a process a step
    assert (exp_dir / "checkpoints" / "last" / "state.pt").exists()
