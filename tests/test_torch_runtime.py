"""The port's multi-stream tracker against the JAX ScanTracker on the CPU,
plus the port's isolation from JAX and the chip smoke script's refusal to
run without a card.

Tolerances: 1e-3 px for the tiny tracker, as tests/test_fused_trunk.py holds
the JAX fused tracker; for full-width FEAR-XS, boxes within 1 px (boxes are
rounded to integers, so a float32 difference can flip one rounding) and
confidence within 1e-4."""

import inspect
import os
import shutil
import subprocess
import sys

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
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker, full_float32

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
def tiny_setup():
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    v = jmodel.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    load_fear_net(model, jax.tree.map(np.asarray, v))
    rng = np.random.RandomState(3)
    frames0 = rng.randint(0, 255, (2, 96, 128, 3), np.uint8)
    chunk = rng.randint(0, 255, (3, 2, 96, 128, 3), np.uint8)
    boxes = np.array([[40.0, 30, 30, 24], [60, 20, 24, 30]], np.float32)
    return jmodel, v, model, frames0, chunk, boxes


@pytest.mark.parametrize("crop_impl", ["mm", "gather"])
def test_tiny_tracker_matches_jax(tiny_setup, crop_impl):
    jmodel, v, model, frames0, chunk, boxes = tiny_setup
    jtr = JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG), crop_impl=crop_impl)
    _, jout = jtr.track(jtr.init(frames0, boxes), chunk)
    tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", crop_impl=crop_impl)
    _, out = tr.track(tr.init(frames0, boxes), chunk)
    np.testing.assert_allclose(out["bbox"].numpy(), np.asarray(jout["bbox"]), atol=1e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)


def test_tiny_shared_frames_match_per_stream(tiny_setup):
    _, _, model, frames0, chunk, boxes = tiny_setup
    tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu")
    _, shared = tr.track(tr.init(frames0[0], boxes), chunk[:, 0])
    _, per_stream = tr.track(tr.init(np.stack([frames0[0]] * 2), boxes),
                             np.stack([chunk[:, 0]] * 2, axis=1))
    for k in shared:
        assert torch.equal(shared[k], per_stream[k]), k


def test_fear_xs_slice_matches_jax():
    jtr, jprov = jharness.build_scan_tracker(PACKAGED_FEAR_XS, dtype=jnp.float32)
    f0, ch, bb = jharness.synthetic_streams(2, 3)
    _, jout = jtr.track(jtr.init(f0, bb), ch)
    tr, prov = build_scan_tracker(dtype=torch.float32, device="cpu")
    f0, ch, bb = synthetic_streams(2, 3, device="cpu")
    state, out = tr.track(tr.init(f0, bb), ch)
    assert prov == jprov == "fear_xs"
    assert tuple(out["bbox"].shape) == (3, 2, 4) and state.template_feats.shape == (2, 8, 8, 256)
    assert np.abs(out["bbox"].numpy() - np.asarray(jout["bbox"])).max() <= 1.0
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)
    np.testing.assert_allclose(out["apce"].numpy(), np.asarray(jout["apce"]), rtol=1e-3)
    np.testing.assert_array_equal(out["failure"].numpy(), np.asarray(jout["failure"]))


@pytest.mark.parametrize("kw", [{"scan_unroll": 2}])
def test_unported_options_raise(tiny_setup, kw):
    """The options that once raised NotImplementedError are ported now:
    ``scan_unroll`` > 1 builds (``tests/test_torch_unroll.py`` holds it)."""
    tracker = ScanTracker(tiny_setup[2], TrackerConfig(**TINY_CFG), device="cpu", **kw)
    assert tracker.scan_unroll == kw["scan_unroll"]


@pytest.mark.parametrize("kw", [
    {"update_mode": "sometimes"},
    {"dynamic_template": True, "update_mode": "feature"},
    {"dynamic_template": True, "update_mode": "ema", "gate_params": {}},
    {"update_interval": 0},
    {"recover_context": -1.0},
    {"scan_unroll": 0},
    {"trunk_impl": "sometimes"},
], ids=["bad_update_mode", "feature_without_gate", "gate_with_ema", "update_interval_0",
        "negative_recover_context", "scan_unroll_0", "bad_trunk_impl"])
def test_bad_options_raise_value_error(tiny_setup, kw):
    """The JAX ScanTracker's ValueErrors, for the same arguments."""
    with pytest.raises(ValueError):
        ScanTracker(tiny_setup[2], TrackerConfig(**TINY_CFG), **kw)
    jmodel, v = tiny_setup[:2]
    with pytest.raises(ValueError):
        JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG), **kw)


def test_provenance_and_load_failure(tmp_path):
    copy = tmp_path / "mine.npz"
    shutil.copy(PACKAGED_FEAR_XS, copy)
    assert build_scan_tracker(str(copy), torch.float32, "cpu")[1] == "mine.npz"
    with pytest.raises(FileNotFoundError):
        build_scan_tracker(str(tmp_path / "missing.npz"), torch.float32, "cpu")


def test_port_imports_no_jax_or_reference():
    """Every port module imports without jax, flax, optax, orbax, the JAX
    package, cv2, matplotlib, pandas, PyYAML, tensorboardX or tensorboard:
    the H100 host has none of them."""
    modules = []
    for root, _, files in os.walk(os.path.join(REPO, "feartracker_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                modules.append(rel.removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(modules)!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'feartracker_tpu', 'cv2', 'matplotlib',\n"
        "                              'pandas', 'yaml', 'optax', 'orbax', 'tensorboardX', 'tensorboard')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(modules) >= 102
    # the deployment surfaces: weight formats, export, demo, plots and report
    assert {f"feartracker_tpu_torch.{m}" for m in (
        "convert.protowire", "convert.coreml", "convert.fear_weights", "convert.lightning", "convert.export",
        "demo", "evaluate.plots", "evaluate.report", "utils.video")} <= set(modules)
    # the training path: data pipeline, device augmentations, step, checkpoints
    assert {f"feartracker_tpu_torch.{m}" for m in (
        "utils.image", "data.labels", "data.samplers", "data.augmentations", "data.dataset", "data.loader",
        "data.device_augs", "train.loss", "train.metrics", "train.optim", "train.step", "train.checkpoint",
        "tools.train_profile")} <= set(modules)
    # the training loop: logging, the config composer, callbacks, the event
    # log, the loop, its command line and the numpy-only dataset writer
    assert {f"feartracker_tpu_torch.{m}" for m in (
        "utils.logging", "config.yaml_lite", "config.compose", "train.callbacks", "train.summary",
        "train.loop", "train.__main__", "tools.make_npy_dataset")} <= set(modules)
    # data parallelism and stream sharding
    assert {f"feartracker_tpu_torch.parallel.{m}" for m in ("multihost", "mesh", "inference")} <= set(modules)
    # the measuring tools
    assert {f"feartracker_tpu_torch.tools.{m}" for m in (
        "recovery_throughput", "roofline", "fused_trunk_bench", "ir_block_micro", "loader_throughput",
        "export_weights")} <= set(modules)
    # the scenario generator, its rasterisers, and the ablation and probe tools
    assert {f"feartracker_tpu_torch.{m}" for m in (
        "utils.raster", "tools.make_synthetic_dataset", "tools.dual_template_ablation", "tools.recovery_ablation",
        "tools.gate_v2_ablation", "tools.occlusion_signal_probe", "tools.letterbox_penalty", "tools.vot_recovery",
        "tools.vot_unified", "tools.tune_tracker", "tools.family_pareto", "tools.quantized_quality")} <= set(modules)


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_scan_tracker_defaults_to_the_card():
    assert inspect.signature(ScanTracker).parameters["device"].default == "cuda"


def test_full_float32_turns_tf32_off_for_float32_trackers_only():
    # torch lets cuDNN take TF32 for float32 convolutions by default; a
    # float32 tracker call runs without it and gives the caller's flags back
    class Probe:
        def __init__(self, dtype):
            self.dtype = dtype

        @full_float32
        def run(self):
            return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        assert Probe(torch.float32).run() == (False, False)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
        assert Probe(torch.bfloat16).run() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
