"""The port's measuring tools and the option they need, on the CPU, against
the JAX package:

* ``ScanTracker(trunk_impl="xla")`` (the model's own unfolded trunk) against
  JAX's xla tracker: the tiny model (static and dual EMA, f32, S=2, T=4)
  within 1e-3 px and confidence 1e-4, FEAR-XS within 1 px; against the
  port's fused trunk; under ``scan_unroll``; through ``set_variables``;
* ``tools/roofline``: the per-frame count equals ``FlopCounterMode`` over
  one plain step, its parts equal the model's ``track_cost``, the crop's
  contraction formula and the depthwise convolutions' 2·|out|·k², the bytes
  their formula; the units split by dtype; a CPU run prints no share;
* ``tools/ir_block_micro``'s block walk equals the JAX tool's;
* ``tools/loader_throughput``: ``dataset_config`` equals the JAX tool's and
  its first batch equals JAX's pipeline's on the same ``.npy`` root;
* ``tools/export_weights``: ``fear_xs.npz`` through it equals JAX's
  ``save_npz``; a port checkpoint's archive loads in JAX and gives the port
  model's features; an Orbax-like directory without a state raises the
  Orbax reader's ``FileNotFoundError``;
* the device timer and the card's peaks live in ``evaluate/profiling.py``,
  and ``chip_smoke.py`` resolves to them."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from feartracker_tpu.evaluate import harness as jharness
from feartracker_tpu.models.fbnet import FEAR_XS_TRUNK as J_XS
from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.tracker.config import TrackerConfig as JTrackerConfig
from feartracker_tpu.tracker.runtime import ScanTracker as JScanTracker
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net
from feartracker_tpu_torch.evaluate import flops, profiling
from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.tools import export_weights, ir_block_micro, loader_throughput, roofline, train_profile
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
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
    rng = np.random.RandomState(5)
    frames0 = rng.randint(0, 255, (2, 96, 128, 3), np.uint8)
    chunk = rng.randint(0, 255, (4, 2, 96, 128, 3), np.uint8)
    boxes = np.array([[40.0, 30, 30, 24], [60, 20, 24, 30]], np.float32)
    return jmodel, v, model, frames0, chunk, boxes


def _track(tracker, frames0, chunk, boxes):
    state, out = tracker.track(tracker.init(frames0, boxes), chunk)
    return state, out


# -- trunk_impl="xla" ----------------------------------------------------------

MODES = {"static": {}, "dual_ema": {"dynamic_template": True, "update_mode": "ema", "update_threshold": 0.0,
                                    "update_rate": 0.4}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_xla_trunk_matches_jax(tiny, mode):
    jmodel, v, model, frames0, chunk, boxes = tiny
    jtr = JScanTracker(jmodel, v, JTrackerConfig(**TINY_CFG), trunk_impl="xla", **MODES[mode])
    jstate, jout = jtr.track(jtr.init(frames0, boxes), chunk)
    tr = ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", trunk_impl="xla", **MODES[mode])
    state, out = _track(tr, frames0, chunk, boxes)
    assert tr.folded is None and tr.template_shape == tuple(np.asarray(jstate.template_feats).shape[1:])
    np.testing.assert_allclose(out["bbox"].numpy(), np.asarray(jout["bbox"]), atol=1e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)
    np.testing.assert_allclose(state.dyn_feats.numpy(), np.asarray(jstate.dyn_feats), atol=1e-4)


def test_fear_xs_xla_trunk_matches_jax():
    jtr, _ = jharness.build_scan_tracker(PACKAGED_FEAR_XS, dtype=jnp.float32, trunk_impl="xla")
    f0, ch, bb = jharness.synthetic_streams(2, 3)
    _, jout = jtr.track(jtr.init(f0, bb), ch)
    tr, _ = build_scan_tracker(dtype=torch.float32, device="cpu", trunk_impl="xla")
    f0, ch, bb = synthetic_streams(2, 3, device="cpu")
    _, out = tr.track(tr.init(f0, bb), ch)
    assert np.abs(out["bbox"].numpy() - np.asarray(jout["bbox"])).max() <= 1.0
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(jout["confidence"]), atol=1e-4)


def test_xla_trunk_matches_fused_trunk(tiny):
    model, frames0, chunk, boxes = tiny[2:]
    outs = {impl: _track(ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", trunk_impl=impl),
                         frames0, chunk, boxes)[1] for impl in ("xla", "fused")}
    np.testing.assert_allclose(outs["xla"]["bbox"].numpy(), outs["fused"]["bbox"].numpy(), atol=1e-3)
    np.testing.assert_allclose(outs["xla"]["confidence"].numpy(), outs["fused"]["confidence"].numpy(), atol=1e-4)


def test_xla_trunk_unrolled_equals_eager(tiny):
    model, frames0, chunk, boxes = tiny[2:]
    got = [_track(ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", trunk_impl="xla",
                              scan_unroll=k, **MODES["dual_ema"]), frames0, chunk, boxes) for k in (1, 2)]
    for key in got[0][1]:
        assert torch.equal(got[0][1][key], got[1][1][key]), key
    assert torch.equal(got[0][0].dyn_feats, got[1][0].dyn_feats)


def _seeded_tiny(seed):
    torch.manual_seed(seed)
    m = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    with torch.no_grad():
        for n, b in m.named_buffers():
            if n.endswith("running_var"):
                b.uniform_(0.5, 1.5)
            elif n.endswith("running_mean"):
                b.normal_(0, 0.1)
    return m.eval()


@pytest.mark.parametrize("unroll", [1, 2])
def test_xla_trunk_set_variables_equals_a_fresh_tracker(tiny, unroll):
    frames0, chunk, boxes = tiny[3:]
    a, b = _seeded_tiny(0), _seeded_tiny(1)
    kw = dict(device="cpu", trunk_impl="xla", scan_unroll=unroll)
    tracker = ScanTracker(a, TrackerConfig(**TINY_CFG), **kw)
    before = _track(tracker, frames0, chunk, boxes)[1]
    held = next(tracker.model.parameters()).data_ptr()
    tracker.set_variables(b)
    got = _track(tracker, frames0, chunk, boxes)[1]
    want = _track(ScanTracker(b, TrackerConfig(**TINY_CFG), **kw), frames0, chunk, boxes)[1]
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(before["bbox"], want["bbox"])
    assert next(tracker.model.parameters()).data_ptr() == held


def test_sharded_tracker_takes_the_xla_trunk(tiny):
    """JAX allows only "xla" on a sharded stream axis; the port runs either
    trunk in each replica."""
    from feartracker_tpu_torch.parallel.inference import ShardedScanTracker

    model, frames0, chunk, boxes = tiny[2:]
    sharded = ShardedScanTracker(model, TrackerConfig(**TINY_CFG), devices=["cpu", "cpu"], trunk_impl="xla")
    assert all(r.trunk_impl == "xla" and r.folded is None for r in sharded.replicas)
    got = sharded.track(sharded.init(frames0, boxes), chunk)[1]
    want = _track(ScanTracker(model, TrackerConfig(**TINY_CFG), device="cpu", trunk_impl="xla"),
                  frames0, chunk, boxes)[1]
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- tools/roofline --------------------------------------------------------------

@pytest.fixture(scope="module")
def costs():
    return {dt: roofline.frame_cost(dt) for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_frame_count_equals_flop_counter_mode(costs, dtype):
    tracker, _ = build_scan_tracker(dtype=dtype, device="cpu", crop_impl="mm")
    f0, ch, bb = synthetic_streams(1, 1, device="cpu")
    state = tracker.init(f0, bb)
    with FlopCounterMode(display=False) as counter:
        tracker.step(state, ch[0])
    cost = costs[dtype]
    # what the step runs is FlopCounterMode's total; what it needs swaps the
    # mm crop's contractions for the bilinear taps
    assert cost["executed"] == counter.get_total_flops()
    assert cost["flops"] == cost["executed"] - cost["executed_crop"] + roofline.crop_flops(256, 3)
    assert cost["flops"] == sum(cost["by_part"].values()) == cost["cuda_core"] + cost["tensor_core"]


def _depthwise_flops(model: nn.Module, search: torch.Tensor, feats: torch.Tensor) -> int:
    """2·|out|·k² over the unfolded model's depthwise convolutions, by hooks."""
    total = [0]

    def hook(m, _inputs, out):
        total[0] += 2 * out.numel() * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.Conv2d) and m.groups > 1 and m.groups == m.in_channels]
    with torch.no_grad():
        model.track(search, feats)
    for h in handles:
        h.remove()
    return total[0]


def test_frame_count_parts(costs):
    cost = costs[torch.float32]
    model = build_scan_tracker(dtype=torch.float32, device="cpu")[0].model
    parts = cost["by_part"]
    # the model's products are track_cost's; the crop its bilinear taps; the
    # mm crop runs its two contractions' formula
    assert cost["flops"] - parts["crop"] == flops.track_cost(model)["flops"]
    (H, W), out, C = cost["frame_hw"], 256, 3
    assert parts["crop"] == 2 * 4 * out * out * C
    assert cost["executed_crop"] == 2 * (out * H * W * C + out * out * W * C)
    assert parts["depthwise"] == _depthwise_flops(model, torch.zeros(1, 256, 256, 3), torch.zeros(1, 8, 8, 256))
    for got, want in ((cost["executed"], 1.300e9), (cost["executed_crop"], 0.3775e9), (parts["depthwise"], 0.0945e9),
                      (cost["flops"], 0.9243e9)):
        assert abs(got / want - 1) <= 0.005, (got, want)


@pytest.mark.parametrize("crop_impl", ["gather", "kernel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_frame_count_is_the_same_whatever_crop_impl(costs, dtype, crop_impl):
    mm, other = costs[dtype], roofline.frame_cost(dtype, crop_impl=crop_impl)
    for key in ("flops", "by_part", "cuda_core", "tensor_core"):
        assert other[key] == mm[key], key
    # the gather crop runs no product; K3 runs the taps the crop needs; the
    # mm crop its contractions
    want = {"gather": 0, "kernel": mm["by_part"]["crop"]}[crop_impl]
    assert other["executed_crop"] == want < mm["executed_crop"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_call_bytes_formula(costs, dtype):
    cost, itemsize = costs[dtype], torch.tensor([], dtype=dtype).element_size()
    S, T = 128, 16
    params = flops.count_params(FEARNet())
    state = 8 * 8 * 256 * itemsize + (4 + 3 + 1) * 4  # template features, box, mean colour, confidence
    outputs = 4 * 4 + 4 + 4 + 1  # box, confidence, APCE, failure flag
    assert roofline.call_bytes(cost, S, T) == S * T * 256 * 480 * 3 + params * itemsize + 2 * S * state + S * T * outputs


def test_units_split_by_dtype(costs):
    f32, bf16 = costs[torch.float32], costs[torch.bfloat16]
    assert f32["tensor_core"] == 0 and f32["cuda_core"] == f32["flops"]
    assert bf16["by_part"] == f32["by_part"]
    assert bf16["cuda_core"] == bf16["by_part"]["crop"] + bf16["by_part"]["depthwise"]
    assert bf16["tensor_core"] == bf16["flops"] - bf16["cuda_core"]


def test_roofline_cpu_run_prints_no_share(capsys):
    roofline.main(["--device", "cpu", "--streams", "1,2", "--chunk", "2", "--warmup", "1", "--timed", "1",
                   "--dtype", "float32"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    count, *rows = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["S"] for r in rows] == [1, 2]
    for r in rows:
        assert r["flops_per_call"] == count["flops_per_frame"] * r["S"] * 2
        assert r["fps_on_cpu"] > 0 and r["ms_per_call"] > 0 and "fps" not in r
        for key in ("mfu_pct", "hbm_util_pct", "compute_floor_ms", "hbm_floor_ms", "bound_ms", "bound_share_pct",
                    "binding_roofline", "power_limit_w"):
            assert r[key] is None, key


def test_roofline_record_on_the_card():
    cost = {"flops": 10, "cuda_core": 4, "tensor_core": 6, "frame_hw": (2, 2), "weight_bytes": 0,
            "state_bytes": 0, "output_bytes": 0}
    rec = roofline.roofline_record(cost, 2, 3, 1e-3, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec["fps"] == 6000 and rec["power_limit_w"] == 700.0
    assert rec["mfu_pct"] == pytest.approx(100 * 60 / 1e-3 / profiling.BF16_FLOPS)
    floors = {"cuda_core": 24 / profiling.F32_FLOPS, "tensor_core": 36 / profiling.BF16_FLOPS,
              "hbm": 72 / profiling.HBM_BYTES_PER_S}
    assert rec["binding_roofline"] == max(floors, key=floors.get) == "hbm"
    assert rec["bound_ms"] == pytest.approx(floors["hbm"] * 1e3)
    assert rec["compute_floor_ms"] == pytest.approx(floors["cuda_core"] * 1e3)


# -- tools/ir_block_micro ----------------------------------------------------------

def test_ir_block_walk_equals_the_jax_tools():
    # tools/ir_block_micro.py's walk, over the JAX package's trunk
    want, H, C = [], 128, 16
    for i, sp in enumerate(J_XS):
        want.append((i, tuple(sp), H, C))
        H //= sp.stride
        C = sp.out_channels
    assert [(i, tuple(sp), H, C) for i, sp, H, C in ir_block_micro.block_walk()] == want


# -- tools/loader_throughput ---------------------------------------------------------

@pytest.fixture(scope="module")
def npy_root(tmp_path_factory):
    from feartracker_tpu_torch.tools.make_npy_dataset import write_npy_dataset

    root = str(tmp_path_factory.mktemp("npy_loader"))
    write_npy_dataset(root, clips=2, frames=12)
    return root


@pytest.mark.parametrize("device_augs,cache", [(True, False), (False, True)])
def test_dataset_config_equals_the_jax_tools(device_augs, cache):
    from tools import loader_throughput as jtool

    assert (loader_throughput.dataset_config("/r", device_augs, 96, cache)
            == jtool.dataset_config("/r", device_augs, 96, cache))


def test_first_batch_equals_jax_pipeline(npy_root, monkeypatch):
    """JAX's dataset reads frames with cv2; here it reads the same ``.npy``
    files the port reads."""
    from feartracker_tpu.data import dataset as jdataset
    from feartracker_tpu.data.loader import BatchLoader as JBatchLoader
    from tools import loader_throughput as jtool

    monkeypatch.setattr(jdataset, "read_img", np.load)
    batch, steps = 4, 2
    jds = jdataset.get_training_datasets(jtool.dataset_config(npy_root, True, batch * (steps + 2)), seed=0)
    want = next(iter(JBatchLoader(jds, batch_size=batch, num_workers=2, seed=0)))
    got = next(iter(loader_throughput.build_loader(npy_root, True, batch, steps, 2)))
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k
        else:
            assert list(got[k]) == list(want[k]), k


@pytest.mark.parametrize("modes", ["device_augs,device_augs+cache", "host_augs"])
def test_loader_throughput_prints_the_jax_tools_keys(npy_root, modes, capsys, monkeypatch):
    if modes.startswith("host"):
        pytest.importorskip("cv2")
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    loader_throughput.main(["--root", npy_root, "--batch", "2", "--steps", "2", "--modes", modes])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    rows = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["mode"] for r in rows] == modes.split(",")
    for r in rows:
        assert {"batch", "num_workers", "loader_samples_s", "device_step_samples_s_on_cpu", "feed_ratio"} <= set(r)
        assert r["loader_samples_s"] > 0 and r["feed_ratio"] is None
        assert ("first_epoch_samples_s" in r) == r["mode"].endswith("cache")


def test_loader_throughput_step_demand_and_refusals(npy_root, capsys, monkeypatch):
    monkeypatch.setattr(loader_throughput, "step_samples_s", lambda batch, device: 10.0 * batch)
    loader_throughput.main(["--root", npy_root, "--batch", "2", "--steps", "1", "--modes", "device_augs",
                            "--step", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["device_step_samples_s_on_cpu"] == 20.0 and row["feed_ratio"] == row["loader_samples_s"] / 20.0
    with pytest.raises(ValueError, match="unknown modes"):
        loader_throughput.main(["--root", npy_root, "--modes", "gpu_augs"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(loader_throughput.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(RuntimeError, match="cv2"):
        loader_throughput.main(["--root", npy_root, "--modes", "host_augs"])


def test_step_samples_s_times_the_train_step(monkeypatch):
    """The demand on the CPU at B=1 with the tiny geometry: the function
    runs train_profile's step and returns a positive rate."""
    monkeypatch.setitem(train_profile.GEOMETRY, "default", train_profile.GEOMETRY["tiny"])
    monkeypatch.setattr(loader_throughput, "build_model", lambda name: train_profile.build_model("tiny"))
    assert loader_throughput.step_samples_s(1, torch.device("cpu"), warmup=1, timed=1) > 0


# -- tools/export_weights ------------------------------------------------------------

def test_export_from_npz_equals_jax_save_npz(tmp_path, capsys):
    from feartracker_tpu.convert.load import load_variables as j_load_variables
    from tools.export_weights import save_npz as j_save_npz

    export_weights.main(["--weights_path", PACKAGED_FEAR_XS, "--out", str(tmp_path / "port.npz")])
    assert "wrote" in capsys.readouterr().out
    j_save_npz(j_load_variables(PACKAGED_FEAR_XS), str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_export_from_a_port_checkpoint_loads_in_jax(tmp_path):
    from feartracker_tpu.convert.load import load_variables as j_load_variables
    from feartracker_tpu_torch.train.checkpoint import CheckpointManager
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state, make_train_step

    template, search, spec = train_profile.GEOMETRY["tiny"]
    tx = build_optimizer({"name": "sgd", "lr": 0.05})
    state = create_train_state(train_profile.build_model("tiny")[0], tx, device="cpu")
    state, _ = make_train_step(tx, spec=spec)(state, train_profile.synthetic_train_batch(2, template, search, spec,
                                                                                          "cpu"))
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    manager.save(1, state, monitor=0.5)
    export_weights.main(["--weights_path", str(tmp_path / "ckpt" / "1"), "--out", str(tmp_path / "step.npz")])
    export_weights.main(["--weights_path", str(tmp_path / "ckpt" / "last" / "state.pt"),
                         "--out", str(tmp_path / "last.npz")])
    with np.load(tmp_path / "step.npz") as a, np.load(tmp_path / "last.npz") as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)

    variables = j_load_variables(str(tmp_path / "step.npz"))
    crop = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    want = np.asarray(jmodel.apply(variables, crop, method=jmodel.get_features))
    model = state.model.eval()
    with torch.no_grad():
        got = model.get_features(torch.from_numpy(crop)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_export_refuses_an_orbax_like_directory(tmp_path):
    orbax = tmp_path / "orbax" / "100"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no Orbax state found"):
        export_weights.main(["--weights_path", str(orbax), "--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()


# -- the shared timer and peaks ----------------------------------------------------------

def test_chip_smoke_resolves_to_the_packages_timer_and_peaks():
    import chip_smoke

    # no copy of the timer, its spin calibration, the bound or the peaks
    assert not any(hasattr(chip_smoke, k) for k in ("HBM_BYTES_PER_S", "BF16_FLOPS", "F32_FLOPS",
                                                    "_spin_cycles_per_ms", "_time_ms", "_k2_bound"))
    nbytes = 128 * 16 * 16 * 5 * 2 + 3 * 16 * 16 * 4 + 128 * 4 * 20
    assert chip_smoke._k1_bound(128, 2) == nbytes / profiling.HBM_BYTES_PER_S * 1e3
    assert (profiling.HBM_BYTES_PER_S, profiling.BF16_FLOPS, profiling.F32_FLOPS) == (3.35e12, 989e12, 67e12)
    assert train_profile.H100_PEAK_FLOPS == {torch.bfloat16: profiling.BF16_FLOPS,
                                             torch.float32: profiling.F32_FLOPS}


def test_device_timer_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        profiling.time_ms(lambda: None)
