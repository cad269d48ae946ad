"""The port's training drivers (``feartracker_tpu_torch/tools/``): their
configurations equal the JAX tools' dicts; ``build_corpus`` writes JAX's
combined val root (``list.txt`` and symlinks); ``train_run``'s resumed run
continues the step count; and every driver refuses a card this host does
not have."""

import argparse
import os

import pytest
import torch

import tools.family_train as jax_family
import tools.make_synthetic_dataset as jax_gen
import tools.pretrain_chain as jax_chain
import tools.tpu_train_run as jax_train_run
import tools.train_feature_gate as jax_feature_gate
import tools.train_flagship as jax_flagship
import tools.train_template_gate as jax_template_gate
import tools.warm_start_comparison as jax_warm
from feartracker_tpu_torch.convert.load import default_weights_path
from feartracker_tpu_torch.tools import (family_train, pretrain_chain, pretrain_trunk, synthetic_e2e,
                                         train_feature_gate, train_flagship, train_run, train_template_gate,
                                         warm_start_comparison)
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate
from torch_tool_parity import one_thread  # noqa: F401  (a module fixture)


@pytest.mark.parametrize("platform", ["", "cpu", "gpu"])
def test_tracker_config_equals_jax(platform):
    args = ("/data/r", "/exp", platform, 3, "trunk.npz", 1e-3, 32, 256, 0)
    assert pretrain_chain.tracker_config(*args) == jax_chain.tracker_config(*args)
    assert pretrain_chain.tracker_config(*args[:4], None, *args[5:]) == jax_chain.tracker_config(*args[:4], None,
                                                                                              *args[5:])


def test_family_arms_equal_jax(tmp_path):
    assert family_train.ARCHS == jax_family.ARCHS
    cfg = family_train.arm_config("m_warmstart", "/r", str(tmp_path), "cpu", 2, 1e-3, 8, 16, 0)
    want = jax_chain.tracker_config("/r", os.path.join(str(tmp_path), "exp_m_warmstart"), "cpu", 2,
                                    family_train.PACKAGED_FEAR_XS, 1e-3, 8, 16, 0)
    want["model"]["name"], want["model"]["towernum"] = jax_family.ARCHS["m"]
    assert cfg == want
    with pytest.raises(SystemExit):
        family_train.arm_config("q_scratch", "/r", str(tmp_path), "cpu", 2, 1e-3, 8, 16, 0)


@pytest.mark.parametrize("pretrained", [None, "fear_xs"])
def test_warm_start_config_equals_jax(pretrained):
    args = ("/data/r", "/data/r/train.csv", "/exp", 4, pretrained)
    assert warm_start_comparison._config(*args) == jax_warm._config(*args)


@pytest.mark.parametrize("dual,device_augs,resume", [(False, False, False), (True, True, True)])
def test_train_run_config_equals_jax(dual, device_augs, resume):
    """The warm start aside: the JAX tool's is the reference's CoreML file,
    the port's ``default_weights_path()``."""
    got = train_run.build_config("/r", "/exp", "cpu", 4, resume, dual, device_augs)
    want = jax_train_run.build_config("/r", "/exp", "cpu", 4, resume, dual, device_augs)
    assert want["model"].pop("pretrained_weights") == jax_train_run.TRACKER_ML
    assert got["model"].pop("pretrained_weights") == default_weights_path()
    assert got == want


@pytest.mark.parametrize("model,towernum,min_epochs", [("fear_xs", 2, None), ("fear_l", 3, 7)])
def test_flagship_config_equals_jax(model, towernum, min_epochs):
    assert train_flagship.SCENARIOS == jax_flagship.SCENARIOS
    args = argparse.Namespace(seed=3, model=model, towernum=towernum, lr=1e-3, batch=16, epochs=110,
                              min_epochs=min_epochs, early_stopping=18, resume=False, num_samples=512)
    assert (train_flagship.build_config("/c", "/e", "cpu", args, "t.npz")
            == jax_flagship.build_config("/c", "/e", "cpu", args, "t.npz"))
    assert train_flagship.dataset_entry("/c", "pose", 64, 6) == jax_flagship.dataset_entry("/c", "pose", 64, 6)


def test_gate_tool_constants_equal_jax():
    assert (train_template_gate.SIZES, train_template_gate.TRACKER) == (jax_template_gate.SIZES,
                                                                         jax_template_gate.TRACKER)
    assert train_feature_gate.SCENARIOS == jax_feature_gate.SCENARIOS


def test_build_corpus_equals_jax(tmp_path):
    """The combined val root: the same ``list.txt`` and the same symlinks
    (relative to each corpus)."""
    jax_flagship.build_corpus(str(tmp_path / "jax"), tracks=1, frames=3, presence_dropout=0.1)
    train_flagship.build_corpus(str(tmp_path / "port"), tracks=1, frames=3, presence_dropout=0.1)
    val = ("val_all", "val")
    jax_val, port_val = tmp_path.joinpath("jax", *val), tmp_path.joinpath("port", *val)
    assert (port_val / "list.txt").read_bytes() == (jax_val / "list.txt").read_bytes()
    names = (port_val / "list.txt").read_text().split("\n")
    assert len(names) == 2 * len(train_flagship.SCENARIOS)
    for name in names:
        assert (os.path.relpath(os.readlink(port_val / name), tmp_path / "port")
                == os.path.relpath(os.readlink(jax_val / name), tmp_path / "jax"))
    # a second call finds list.txt and generates nothing
    stamp = os.path.getmtime(port_val / "list.txt")
    train_flagship.build_corpus(str(tmp_path / "port"), tracks=1, frames=3, presence_dropout=0.1)
    assert os.path.getmtime(port_val / "list.txt") == stamp


def test_train_run_resume_continuity(tmp_path):
    generate(str(tmp_path / "data"), tracks=2, frames=6, val_sequences=1, seed=11, size=(288, 384))
    cut = {"batch_size": {"train": 2, "val": 1}, "train_percent": 2, "max_val_samples": 3, "num_workers": 1}
    recs = train_run.run(str(tmp_path / "data"), str(tmp_path / "exp"), epochs=2, resume_epochs=1, device="cpu",
                         overrides=cut)
    assert [r["epoch"] for r in recs if "epoch" in r] == [0, 1]
    assert recs[-1] == {"resumed_from_step": 4, "resumed_steps": 6, "expected_steps": 6, "resume_continuity": True}
    assert os.path.isdir(tmp_path / "exp" / "TPU_XS" / "checkpoints" / "last")


def test_warm_start_comparison_runs(tmp_path):
    recs = warm_start_comparison.run(epochs=1, tracks=2, frames=6, val_sequences=1, work=str(tmp_path),
                                     device="cpu")
    assert [r.get("init") for r in recs] == ["scratch", "partial_warm", None]
    assert sorted(recs[-1]["summary"]["final_val_box_iou"]) == ["partial_warm", "scratch"]


def test_synthetic_e2e_runs(tmp_path):
    generate(str(tmp_path / "data"), tracks=4, frames=10, val_sequences=1, seed=0)
    recs = synthetic_e2e.run(str(tmp_path / "data"), epochs=1, device="cpu")
    assert [r.get("model") for r in recs[:2]] == ["untrained", "trained"]
    assert recs[-1]["steps"] >= 1
    assert os.path.isdir(tmp_path / "data" / "synth_exp" / "SYNTH" / "checkpoints" / "last")


def test_pretrain_chain_runs_three_arms(tmp_path):
    recs = pretrain_chain.run(epochs=1, batch=2, num_samples=2, tracks=2, track_frames=6, per_class=1,
                              pretrain_epochs=1, work=str(tmp_path), device="cpu")
    assert recs[0]["arrays"] == 230
    assert [r["arm"] for r in recs if "epoch" in r] == ["scratch", "cls_pretrain", "recovered"]
    assert sorted(recs[-1]["summary"]) == ["cls_pretrain", "recovered", "scratch"]


MAINS = {
    "pretrain_trunk": (pretrain_trunk, ["--data", "d", "--out", "o.npz"]),
    "warm_start_comparison": (warm_start_comparison, []),
    "synthetic_e2e": (synthetic_e2e, ["--root", "r"]),
    "train_run": (train_run, ["--root", "r"]),
    "pretrain_chain": (pretrain_chain, ["--smoke"]),
    "family_train": (family_train, ["--smoke"]),
    "train_template_gate": (train_template_gate, []),
    "train_feature_gate": (train_feature_gate, []),
    "train_flagship": (train_flagship, ["--smoke"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_every_driver_refuses_a_missing_card(name, tmp_path, monkeypatch):
    """``--device cuda`` on a host without one raises before any work."""
    monkeypatch.chdir(tmp_path)
    module, argv = MAINS[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main(argv + ["--device", "cuda"])
    assert os.listdir(tmp_path) == []


def test_jax_generator_roots_are_read_as_they_are(tmp_path):
    """A JPEG root of the JAX generator already in place is reused, not
    regenerated: the drivers' ``generate`` guards look at what is there."""
    jax_gen.generate(str(tmp_path / "swap_s51"), tracks=1, frames=3, val_sequences=1, seed=51, scenario="swap")
    before = sorted(os.listdir(tmp_path / "swap_s51" / "got10k" / "val" / "GOT-10k_Val_000000"))
    obs = train_feature_gate.collect_rollouts(["swap"], [51], 3, 1, 1.0, str(tmp_path), dtype=torch.float32,
                                              device="cpu")[0]
    assert obs.shape == (2, 6)
    assert sorted(os.listdir(tmp_path / "swap_s51" / "got10k" / "val" / "GOT-10k_Val_000000")) == before
