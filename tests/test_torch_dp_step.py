"""The port's data-parallel train step (``make_train_step(mesh=group)``) on
two real processes over Gloo (``tests/torch_dist_worker.py``, 120 s limit
each run) against JAX's ``make_train_step(mesh=make_mesh(2))`` on two of the
8 virtual CPU devices, on the tiny model (TINY_TRUNK, 16 channels, one
tower) in float32, with the same weights and per-rank shards.

Tolerances: identical shards with SGD against the single-device step, JAX's
own invariant (``tests/test_train_step.py``): parameters atol 1e-6,
BatchNorm statistics atol 2e-5. Different shards, sync BN on and off: the
loss and its parts rtol 2e-5; each parameter's update within 1e-5 of the
largest update over all parameters (SGD at lr 1: the gradient's max); BatchNorm statistics atol 2e-5. Across ranks, and a group of one
process against no group: equal bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import JSPEC, SPEC, _batch, _port_flat, _port_model, _stats_flat, _t, _variables
from torch_dist_worker import run_workers

from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.parallel.mesh import DATA_AXIS, make_mesh, shard_batch
from feartracker_tpu.train.optim import build_optimizer as j_build_optimizer
from feartracker_tpu.train.step import TrainState as JTrainState
from feartracker_tpu.train.step import make_train_step as j_make_train_step
from feartracker_tpu_torch.convert.load import flatten_variables
from feartracker_tpu_torch.train.optim import build_optimizer
from feartracker_tpu_torch.train.step import create_train_state, make_train_step
from feartracker_tpu_torch.utils import constants as C

SGD = {"name": "sgd", "lr": 0.05}
# lr 1: an update is the gradient, far above the parameters' float32 spacing
SGD_GRAD = {"name": "sgd", "lr": 1.0}
ADAM = {"name": "adam", "lr": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(v, shards, cfg):
    """Worker inputs: the weights and shards[step][rank] batches."""
    inp = {f"var/{k}": np.asarray(a) for k, a in flatten_variables(jax.tree.map(np.asarray, v)).items()}
    for i, per_rank in enumerate(shards):
        for r, b in enumerate(per_rank):
            inp.update({f"batch/{i}/{r}/{k}": np.asarray(a) for k, a in b.items()})
    return {**inp, "config": cfg}


def _jax_dp(v, shards, opt, sync_bn):
    """JAX's shard_map step over make_mesh(2), the ranks' shards
    concatenated into the global batch."""
    mesh = make_mesh(2)
    jm = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1, bn_axis_name=DATA_AXIS if sync_bn else None)
    jtx = j_build_optimizer(opt)
    state = JTrainState(v["params"], v["batch_stats"], jtx.init(v["params"]), jnp.zeros((), jnp.int32))
    step = j_make_train_step(jm, jtx, spec=JSPEC, mesh=mesh)
    metrics = []
    for per_rank in shards:
        glob = {k: np.concatenate([b[k] for b in per_rank]) for k in per_rank[0]}
        state, m = step(state, shard_batch(mesh, glob))
        metrics.append(m)
    return state, metrics


def _params(out, prefix=""):
    return {k[len(prefix) + 6:]: v for k, v in out.items() if k.startswith(prefix + "param/")}


def _stats(out, prefix=""):
    return {k[len(prefix) + 5:]: v for k, v in out.items() if k.startswith(prefix + "stat/")}


def test_identical_shards_match_the_single_device_step(tmp_path):
    """Sync BN, the same shard on both ranks: the global batch's content is
    one shard, so the step is the single-device step's (JAX's invariant),
    and JAX's 2-device step's."""
    v = _variables(30)
    shard = _batch(31)
    outs = run_workers("step", 2, _inputs(v, [[shard, shard]], {"optimizer": SGD, "steps": 1, "sync_bn": True}),
                       tmp_path)
    tx = build_optimizer(SGD)
    single = create_train_state(_port_model(v), tx, device="cpu")
    single, met = make_train_step(tx, spec=SPEC)(single, _t(shard))
    jstate, jmet = _jax_dp(v, [[shard, shard]], SGD, sync_bn=True)
    jparams, jstats = _port_flat(jstate.params), _stats_flat(jstate.batch_stats)
    for o in outs:
        np.testing.assert_allclose(o["metric/loss"][0], float(met["loss"]), rtol=2e-5)
        np.testing.assert_allclose(o["metric/loss"][0], float(jmet[0]["loss"]), rtol=2e-5)
        got = _params(o)
        for k, p in single.model.named_parameters():
            np.testing.assert_allclose(got[k], p.detach().numpy(), rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], jparams[k], rtol=0, atol=1e-6, err_msg=k)
        stats = _stats(o)
        for k, b in single.model.named_buffers():
            if k.endswith(("mean", "var")):
                np.testing.assert_allclose(stats[k], b.numpy(), rtol=0, atol=2e-5, err_msg=k)
                np.testing.assert_allclose(stats[k], jstats[k], rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("sync_bn", [True, False], ids=["sync_bn", "local_bn"])
def test_heterogeneous_shards_match_jax_dp_step(tmp_path, sync_bn):
    v = _variables(32)
    shards = [[_batch(33), _batch(34, presence=[1, 0, 1, 1])]]
    outs = run_workers("step", 2, _inputs(v, shards, {"optimizer": SGD_GRAD, "steps": 1, "sync_bn": sync_bn}),
                       tmp_path)
    jstate, jmet = _jax_dp(v, shards, SGD_GRAD, sync_bn)
    init = _port_flat(v["params"])
    jparams, jstats = _port_flat(jstate.params), _stats_flat(jstate.batch_stats)
    jupd = {k: jparams[k] - init[k] for k in jparams}
    umax = max(float(np.abs(u).max()) for u in jupd.values())
    for o in outs:
        for k in ("loss", "cls_loss", "reg_loss"):
            np.testing.assert_allclose(o[f"metric/{k}"][0], float(jmet[0][k]), rtol=2e-5, err_msg=k)
        for k, p in _params(o).items():
            np.testing.assert_allclose(p - init[k], jupd[k], rtol=0, atol=1e-5 * umax, err_msg=k)
        for k, s in _stats(o).items():
            np.testing.assert_allclose(s, jstats[k], rtol=0, atol=2e-5, err_msg=k)
    # per-sample outputs stay each rank's own rows
    jious = np.asarray(jmet[0]["ious"])
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["metric/ious"][0], jious[4 * r:4 * (r + 1)], rtol=1e-4, atol=1e-5)
    # sync BN moved other statistics than the local ones
    if sync_bn:
        local = _stats_flat(_jax_dp(v, shards, SGD_GRAD, sync_bn=False)[0].batch_stats)
        assert max(float(np.abs(local[k] - jstats[k]).max()) for k in local) > 1e-3


def test_adam_ranks_stay_bit_identical(tmp_path):
    v = _variables(35)
    shards = [[_batch(36 + 2 * i), _batch(37 + 2 * i)] for i in range(3)]
    outs = run_workers("step", 2, _inputs(v, shards, {"optimizer": ADAM, "steps": 3, "sync_bn": True}), tmp_path)
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k) if not k.endswith("ious") else None
    assert int(outs[0]["opt/count"]) == 3
    # the ranks trained on different data: their per-sample rows differ
    assert not np.array_equal(outs[0]["metric/ious"], outs[1]["metric/ious"])


def test_group_of_one_is_the_no_group_step(tmp_path):
    v = _variables(40)
    shards = [[_batch(41 + i)] for i in range(3)]
    (out,) = run_workers("world1", 1, _inputs(v, shards, {"optimizer": ADAM, "steps": 3}), tmp_path)
    group = {k[len("group/"):]: a for k, a in out.items() if k.startswith("group/")}
    alone = {k[len("alone/"):]: a for k, a in out.items() if k.startswith("alone/")}
    assert group.keys() == alone.keys() and len(group) > 10
    for k in group:
        np.testing.assert_array_equal(group[k], alone[k], err_msg=k)


def test_nan_on_one_rank_leaves_both_ranks_untouched(tmp_path):
    """``skip_non_finite`` + the guard: a NaN pixel in rank 1's shard of step
    1 makes the averaged loss and gradients NaN on both ranks, so both keep
    step 0's parameters and statistics."""
    v = _variables(45)
    bad = _batch(48)
    bad[C.TRACKER_TARGET_SEARCH_IMAGE_KEY][1, 2, 2, 0] = np.nan
    shards = [[_batch(46), _batch(47)], [_batch(49), bad]]
    cfg = {"optimizer": {"name": "adam", "lr": 1e-3, "skip_non_finite": 3}, "steps": 2, "sync_bn": True,
           "guard": True}
    outs = run_workers("step", 2, _inputs(v, shards, cfg), tmp_path)
    for o in outs:
        assert np.isfinite(o["metric/loss"][0]) and not np.isfinite(o["metric/loss"][1])
        for k in o:
            if k.startswith("0/"):
                np.testing.assert_array_equal(o["1/" + k[2:]], o[k], err_msg=k)
        assert int(o["opt/count"]) == 1
    for k in _params(outs[0]):
        np.testing.assert_array_equal(_params(outs[0])[k], _params(outs[1])[k])


def test_mesh_must_be_a_process_group():
    with pytest.raises(TypeError, match="process group"):
        make_train_step(build_optimizer({}), mesh=object())
