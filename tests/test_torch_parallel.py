"""The port's process-group helpers, mesh helpers and cross-process
BatchNorm (``feartracker_tpu_torch/parallel``, ``models/blocks.py``) against
the JAX package's, on the CPU; multi-process cases run two real processes
over Gloo (``tests/torch_dist_worker.py``, 120 s limit each), the JAX side on
two of the 8 virtual CPU devices.

Tolerances: the gathered rows of ``allgather_rows`` 1e-6 (float32 through
the collective, as JAX's test holds them); cross-process BatchNorm against
Flax's ``BatchNorm(axis_name=…)`` under ``shard_map`` rtol 1e-5, atol 1e-6
(outputs, input and scale/bias gradients, running statistics). The
mocked-topology loop cases are exact, as in ``tests/test_multihost.py``."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P
from test_trainer_integration import _make_track_images, _make_val_sequences
from torch_dist_worker import run_workers

from feartracker_tpu.parallel.mesh import DATA_AXIS
from feartracker_tpu.parallel.mesh import make_mesh as j_make_mesh
from feartracker_tpu_torch.models.blocks import FlaxBatchNorm2d, set_sync_bn
from feartracker_tpu_torch.parallel import multihost
from feartracker_tpu_torch.parallel.mesh import local_batch_size, make_mesh, shard_batch, shard_bounds

BN_RTOL, BN_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- multihost ------------------------------------------------------------------


def test_allgather_rows_single_process_passthrough():
    rows = np.array([[0.0, 0.5, 0.1], [1.0, 0.7, 0.0]])
    out = multihost.allgather_rows(rows)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, rows.astype(np.float32))
    assert multihost.allgather_rows(np.zeros((0, 3))).shape == (0, 3)
    with pytest.raises(ValueError):
        multihost.allgather_rows(np.zeros(3))
    assert multihost.process_count() == 1 and multihost.process_index() == 0 and multihost.is_master()


def test_allgather_rows_over_two_processes(tmp_path):
    """Rank 0 gives 1 row, rank 1 gives 2: both see the same 3 rows in rank
    order (JAX's tests/test_multihost_real.py expectation)."""
    outs = run_workers("allgather", 2, {}, tmp_path)
    expect = [[0.0, 0.5, 0.0], [1.0, 1.5, 0.0], [1.0, 1.6, 1.0]]
    for o in outs:
        assert o["rows"].dtype == np.float32
        np.testing.assert_allclose(o["rows"], expect, atol=1e-6)
        assert o["empty"].shape == (0, 3)
    np.testing.assert_array_equal(outs[0]["rows"], outs[1]["rows"])


def _fake_init(monkeypatch, calls):
    """``init_process_group`` recorded; the group counts as joined after."""
    monkeypatch.setattr(multihost.dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: bool(calls))


def test_distributed_initialize_is_idempotent(monkeypatch):
    calls = []
    _fake_init(monkeypatch, calls)
    multihost.initialize({"coordinator_address": "host:1234", "num_processes": 2, "process_id": 0})
    multihost.initialize({"coordinator_address": "host:1234"})
    assert calls == [(("nccl",), {"init_method": "tcp://host:1234", "world_size": 2, "rank": 0})]


def test_distributed_initialize_env_and_errors(monkeypatch):
    calls = []
    _fake_init(monkeypatch, calls)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        multihost.initialize({})
    with pytest.raises(ValueError, match="all of"):
        multihost.initialize({"coordinator_address": "h:1"})
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"), ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    multihost.initialize({"backend": "gloo"})
    assert calls == [(("gloo",), {"init_method": "env://"})]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.local_process_count() == 4 and multihost.local_rank() == 3
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError):
        multihost.process_group()


# -- mesh -----------------------------------------------------------------------


def test_make_mesh_raises_when_too_few_devices():
    assert make_mesh(2, devices=["cpu"] * 3) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="need 4"):
        make_mesh(4, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no devices"):
            make_mesh()
        with pytest.raises(ValueError, match="need 1"):
            make_mesh(1)
    # JAX raises the same way
    with pytest.raises(ValueError):
        j_make_mesh(9)


def test_batch_shares_match_jax_shard_batch():
    """Each rank's share is the block JAX's ``shard_batch`` places on the
    rank's device; the per-process batch splits a host's batch_size."""
    mesh = j_make_mesh(4)
    batch = {"a": np.arange(24.0).reshape(8, 3), "b": np.arange(8)}
    placed = jax.device_put(batch, jax.sharding.NamedSharding(mesh, P(DATA_AXIS)))
    for r in range(4):
        share = shard_batch(batch, r, 4)
        for k in batch:
            shard = next(s for s in placed[k].addressable_shards if s.device == mesh.devices[r])
            np.testing.assert_array_equal(share[k], np.asarray(shard.data))
    assert shard_bounds(8, 3, 4) == (6, 8)
    with pytest.raises(ValueError):
        shard_batch(batch, 0, 3)
    assert local_batch_size(32, 4) == 8 and local_batch_size(32, 1) == 32
    with pytest.raises(ValueError, match="divide"):
        local_batch_size(30, 4)


# -- cross-process BatchNorm ------------------------------------------------------


def _flax_sync_bn(x, g, scale, bias, mean, var):
    """Flax's BatchNorm(axis_name) under shard_map over make_mesh(2), the
    per-shard gradient of sum(y · g) as JAX's train step takes it: each
    shard's outputs, input gradient, scale/bias gradients and statistics."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, axis_name=DATA_AXIS)

    def local(params, x, g):
        def f(params, x):
            y, mut = bn.apply({"params": params, "batch_stats": {"mean": mean, "var": var}}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * g), (y, mut["batch_stats"])

        (_, (y, st)), (dp, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
        per_shard = jax.tree.map(lambda a: a[None], (dp, st))
        return y, dx, per_shard

    fn = shard_map(local, mesh=j_make_mesh(2), in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
                   out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)), check_vma=False)
    y, dx, (dp, st) = jax.jit(fn)({"scale": scale, "bias": bias}, x, g)
    return np.asarray(y), np.asarray(dx), jax.tree.map(np.asarray, dp), jax.tree.map(np.asarray, st)


def test_sync_bn_matches_flax_over_two_processes(tmp_path):
    rng = np.random.RandomState(0)
    B, H, W, C = 3, 5, 4, 6
    # different shards: another mean and scale on each
    xs = [(rng.randn(B, H, W, C) * (1 + r) + 2 * r).astype(np.float32) for r in range(2)]
    gs = [rng.randn(B, H, W, C).astype(np.float32) for _ in range(2)]
    p = {"scale": (1 + rng.rand(C) * 0.5).astype(np.float32), "bias": rng.randn(C).astype(np.float32),
         "mean": rng.randn(C).astype(np.float32) * 0.1, "var": (1 + rng.rand(C)).astype(np.float32)}
    outs = run_workers("bn", 2, {**p, "x0": xs[0], "x1": xs[1], "g0": gs[0], "g1": gs[1]}, tmp_path)
    y, dx, dp, st = _flax_sync_bn(np.concatenate(xs), np.concatenate(gs), p["scale"], p["bias"], p["mean"],
                                  p["var"])
    for r, o in enumerate(outs):
        rows = slice(r * B, (r + 1) * B)
        np.testing.assert_allclose(o["y"], y[rows], rtol=BN_RTOL, atol=BN_ATOL)
        np.testing.assert_allclose(o["dx"], dx[rows], rtol=BN_RTOL, atol=BN_ATOL)
        np.testing.assert_allclose(o["dscale"], dp["scale"][r], rtol=BN_RTOL, atol=BN_ATOL)
        np.testing.assert_allclose(o["dbias"], dp["bias"][r], rtol=BN_RTOL, atol=BN_ATOL)
        np.testing.assert_allclose(o["mean"], st["mean"][r], rtol=BN_RTOL, atol=BN_ATOL)
        np.testing.assert_allclose(o["var"], st["var"][r], rtol=BN_RTOL, atol=BN_ATOL)
    # the statistics are the whole batch's: another rank's x moved them
    global_var = np.concatenate(xs).reshape(-1, C).var(0)
    np.testing.assert_allclose(outs[0]["var"], 0.9 * p["var"] + 0.1 * global_var, rtol=1e-4)


def test_sync_bn_without_a_group_is_the_single_device_module():
    """``sync_bn`` set but no process group: the module's train step is the
    single-device one, bit for bit."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 6, 5, 5).astype(np.float32))
    a, b = FlaxBatchNorm2d(6, eps=1e-5), FlaxBatchNorm2d(6, eps=1e-5)
    set_sync_bn(b)
    assert b.sync_bn and not a.sync_bn
    ya, yb = a.train()(x), b.train()(x)
    assert torch.equal(ya, yb) and torch.equal(a.running_var, b.running_var)


# -- the loop's multi-process parts, on a mocked topology ------------------------


@pytest.fixture(scope="module")
def mh_config(tmp_path_factory):
    import pandas as pd

    root = str(tmp_path_factory.mktemp("multihost"))
    csv_path = os.path.join(root, "train.csv")
    pd.DataFrame(_make_track_images(root, n_tracks=2, n_frames=6)).to_csv(csv_path, index=False)
    return {
        "platform": "cpu", "num_devices": 1, "sync_bn": True, "seed": 0, "precision": "float32",
        "model": {"name": "fear_tiny", "adjust_channels": 24, "towernum": 1},
        "tracker": {"score_size": 8, "total_stride": 8, "instance_size": 64, "template_size": 32},
        "optimizer": {"name": "adam", "lr": 1e-3},
        "batch_size": 4, "num_workers": 1, "max_epochs": 1, "max_val_samples": 3, "log_every_n_steps": 1,
        "experiment": {"folder": os.path.join(root, "exp"), "name": "MH"},
        "train": {"datasets": [{
            "name": "synthetic", "root": root,
            "sizes": {"search_image_size": 64, "template_image_size": 32, "search_context": 2,
                      "template_bbox_offset": 0.2, "search_image_shift": 8, "search_image_scale": 0.2,
                      "context_range": 1},
            "regression_weight_label_size": 8,
            "sampling": {"type": "track", "data_path": csv_path, "negative_ratio": 0, "frame_offset": 4,
                         "num_samples": 8, "clip_range": True},
        }]},
        "val": {"datasets": []},
    }


def _mock_host(monkeypatch, index: int, count: int):
    monkeypatch.setattr(multihost, "process_index", lambda: index)
    monkeypatch.setattr(multihost, "process_count", lambda: count)


def test_per_rank_loaders_are_disjoint_and_exhaustive(mh_config, monkeypatch):
    from feartracker_tpu_torch.train.loop import Trainer

    shards = []
    for rank in range(4):
        _mock_host(monkeypatch, rank, 4)
        trainer = Trainer(mh_config)
        trainer.setup_data()
        loader = trainer._loader()
        assert loader.host_id == rank and loader.num_hosts == 4
        shards.append(set(loader._indices().tolist()))
    assert set().union(*shards) == set(range(len(trainer.train_dataset)))
    for a in range(4):
        for b in range(a + 1, 4):
            assert not (shards[a] & shards[b])


def test_non_master_rank_writes_nothing(mh_config, monkeypatch):
    from feartracker_tpu_torch.train.loop import Trainer, _NullWriter

    _mock_host(monkeypatch, 1, 2)
    trainer = Trainer(mh_config)
    assert not trainer.is_master
    assert isinstance(trainer.writer, _NullWriter)
    trainer.setup_data()
    trainer.setup_state(0)
    trainer.fit()
    assert not trainer.ckpt.has_last() and not os.listdir(trainer.ckpt.directory)
    assert not os.path.exists(os.path.join(trainer.exp_dir, "logs"))


def test_sharded_validation_matches_redundant_path(mh_config, monkeypatch, tmp_path):
    """Each rank tracks a rank-strided share of the sequences; the rows of
    two ranks together are the one-process rows, as a set, with the same
    mean."""
    from feartracker_tpu_torch.train.loop import Trainer

    root = str(tmp_path)
    _make_val_sequences(os.path.join(root, "got10k", "val"), n_seq=3)
    cfg = {**mh_config, "experiment": {"folder": os.path.join(root, "exp"), "name": "SHVAL"},
           "val": {"datasets": [{"name": "got10k", "root_dir": os.path.join(root, "got10k"), "subset": "val"}]}}

    def run_rank(index, count, capture):
        _mock_host(monkeypatch, index, count)
        monkeypatch.setattr(multihost, "allgather_rows",
                            lambda rows: capture.append(np.asarray(rows, np.float64).reshape(-1, 3)) or capture[-1])
        t = Trainer(cfg)
        t.setup_data()
        t.setup_state(0)
        t.validate(0)

    full = []
    run_rank(0, 1, full)
    shards = []
    for r in range(2):
        cap = []
        run_rank(r, 2, cap)
        shards.append(cap[0])
        assert 0 < len(cap[0]) < len(full[0])
    combined = np.concatenate(shards)
    assert len(combined) == len(full[0])
    assert np.isclose(np.mean(combined[:, 1]), np.mean(full[0][:, 1]))
    assert set(map(tuple, combined.tolist())) == set(map(tuple, full[0].tolist()))
