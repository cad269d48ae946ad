"""The port's training step against the JAX package's, on the CPU, at the
tiny model's size (TINY_TRUNK, 16 channels, one tower; 32² template, 64²
search, an 8×8 score map).

Tolerances, float32: loss and its parts rtol 1e-5; every gradient tensor
within 1e-5 of the gradient's max |value| over all parameters, and within
1e-4 of its own max where that is not rounding noise (the convolutions'
backward sums in other orders than XLA's; a conv bias before a BatchNorm in
train mode, or a BatchNorm bias before a 1×1 conv and a BatchNorm, has an
exactly zero gradient, of which both sides compute only noise); BatchNorm running statistics rtol 1e-5 (Flax's biased
variance, E[x²] − E[x]²), with an absolute floor of 1e-5 of the tensor's
largest statistic (a channel's mean may cancel to near zero); SGD-updated parameters atol 1e-6; the optimizer
chain alone, fed the same gradients, rtol 1e-6. bfloat16: the loss within
2e-2 relative of JAX's ``FEARNet(dtype=bfloat16)`` step (the convolutions
round to bfloat16 in other places than XLA's)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feartracker_tpu.core import box_coder as jbc
from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.train import loss as JL
from feartracker_tpu.train.optim import build_optimizer as j_build_optimizer
from feartracker_tpu.train.step import TrainState as JTrainState
from feartracker_tpu.train.step import make_train_multistep as j_multistep
from feartracker_tpu.train.step import make_train_step as j_make_train_step
from feartracker_tpu_torch.convert.load import flatten_variables, load_adam_state, load_fear_net, torch_key
from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.train import loss as L
from feartracker_tpu_torch.train.metrics import DatasetAwareSums, failure_rate
from feartracker_tpu_torch.train.optim import (
    PlateauScheduler,
    apply_updates,
    build_optimizer,
    get_learning_rate,
    set_learning_rate,
)
from feartracker_tpu_torch.train.step import (
    create_train_state,
    make_loss_and_grads,
    make_train_multistep,
    make_train_step,
    stack_batches,
)
from feartracker_tpu_torch.utils import constants as C

SPEC = bc.BoxCoderSpec(score_size=8, total_stride=8, instance_size=64)
JSPEC = jbc.BoxCoderSpec(score_size=8, total_stride=8, instance_size=64)
BN_LEAVES = ("running_mean", "running_var")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(dtype=None):
    return JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1, dtype=dtype)


def _variables(seed=0):
    """Initialized Flax variables with non-trivial BatchNorm parameters and
    statistics and a non-zero template gate, as numpy."""
    rng = np.random.RandomState(seed)
    v = _jax_model().init(jax.random.PRNGKey(seed),
                          (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
                          train=False)
    v = jax.tree.map(np.asarray, v)
    flat = flatten_variables(v)
    for k in flat:
        if k.endswith("/var"):
            flat[k] = (flat[k] + rng.rand(*flat[k].shape) * 0.5).astype(np.float32)
        elif k.endswith("/mean") or k.endswith("bn/bias"):
            flat[k] = (flat[k] + rng.randn(*flat[k].shape) * 0.1).astype(np.float32)
        elif k.endswith("bn/scale"):
            flat[k] = (flat[k] * (1 + rng.rand(*flat[k].shape) * 0.2)).astype(np.float32)
        elif k.endswith("template_gate"):
            flat[k] = np.full_like(flat[k], 0.3)
    return _nest(flat)


def _nest(flat):
    out = {}
    for k, a in flat.items():
        d = out
        *path, leaf = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = a
    return out


def _port_model(v):
    return load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), v)


def _batch(seed, B=4, aux=False, presence=None):
    rng = np.random.RandomState(seed)
    gt = np.stack([rng.uniform(4, 20, B), rng.uniform(4, 20, B),
                   rng.uniform(8, 30, B), rng.uniform(8, 30, B)], -1).astype(np.float32)
    enc = jbc.encode(jnp.asarray(gt), JSPEC)
    vis = np.ones((B, 1), np.float32) if presence is None else np.asarray(presence, np.float32).reshape(B, 1)
    batch = {
        C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: rng.randn(B, 32, 32, 3).astype(np.float32),
        C.TRACKER_TARGET_SEARCH_IMAGE_KEY: rng.randn(B, 64, 64, 3).astype(np.float32),
        C.TARGET_REGRESSION_LABEL_KEY: np.asarray(enc.regression_map) * vis[:, :, None, None],
        C.TARGET_CLASSIFICATION_KEY: np.asarray(enc.classification_label) * vis[:, :, None, None],
        C.TARGET_REGRESSION_WEIGHT_KEY: np.asarray(enc.classification_label)[..., 0] * vis[:, :, None],
        C.TRACKER_TARGET_BBOX_KEY: gt,
        C.TARGET_VISIBILITY_KEY: vis,
    }
    if aux:
        batch[C.TRACKER_TARGET_AUX_IMAGE_KEY] = rng.randn(B, 32, 32, 3).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_flat(tree):
    """A Flax-shaped tree → {torch name: port-layout array}."""
    out = {}
    for k, a in flatten_variables(jax.tree.map(np.asarray, tree)).items():
        a = np.asarray(a, np.float32)
        if k.endswith("/kernel") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[torch_key("params/" + k)] = a
    return out


def _stats_flat(stats):
    out = {}
    for k, a in flatten_variables(jax.tree.map(np.asarray, stats)).items():
        out[torch_key("batch_stats/" + k)] = np.asarray(a)
    return out


def _assert_stats(model, jstats, rtol=1e-5):
    ref = _stats_flat(jstats)
    got = {k: v.numpy() for k, v in model.state_dict().items() if k.endswith(BN_LEAVES)}
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=rtol * float(np.abs(ref[k]).max()), err_msg=k)


def _jax_grads(model, v, batch, dual=False):
    def loss_fn(params):
        x = (batch[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY], batch[C.TRACKER_TARGET_SEARCH_IMAGE_KEY])
        if dual:
            x = x + (batch[C.TRACKER_TARGET_AUX_IMAGE_KEY],)
        out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                             mutable=["batch_stats"], method=model.forward_dual if dual else None)
        losses = JL.fear_loss(out, batch)
        return losses[C.TARGET_CLASSIFICATION_KEY] + losses[C.TARGET_REGRESSION_LABEL_KEY]

    return jax.grad(loss_fn)(v["params"])


def _zero_gradients(ref):
    """The parameters whose gradient is analytically zero (rounding noise
    of at most a millionth of the largest gradient): see the module
    docstring."""
    gmax = max(float(np.abs(r).max()) for r in ref.values())
    return {k for k, r in ref.items() if float(np.abs(r).max()) < 1e-6 * gmax}


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_gradients_match_jax(dual):
    v = _variables(1)
    batch = _batch(2, aux=dual)
    ref = _port_flat(_jax_grads(_jax_model(), v, batch, dual))
    total, losses, _, grads = make_loss_and_grads(dual_template=dual)(_port_model(v), _t(batch))
    assert set(grads) == set(ref)
    gmax = max(float(np.abs(r).max()) for r in ref.values())
    zero = _zero_gradients(ref)
    assert zero and all(k.endswith("bias") or k == "template_gate" for k in zero), zero
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=0, atol=1e-5 * gmax, err_msg=k)
        if k not in zero:
            np.testing.assert_allclose(g.numpy(), ref[k], rtol=0, atol=1e-4 * float(np.abs(ref[k]).max()),
                                       err_msg=k)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_sgd_step_matches_jax(dual):
    """One SGD step (lr 0.05, momentum 0.9, nesterov): loss and parts, the
    BatchNorm statistics the forward moved, the updated parameters and the
    step's metrics."""
    v = _variables(3)
    batch = _batch(4, aux=dual, presence=[1, 1, 0, 1])
    cfg = {"name": "sgd", "lr": 0.05, "momentum": 0.9, "nesterov": True}
    jm, jtx = _jax_model(), j_build_optimizer(cfg)
    jstate = JTrainState(v["params"], v["batch_stats"], jtx.init(v["params"]), jnp.zeros((), jnp.int32))
    jstate, jmet = j_make_train_step(jm, jtx, spec=JSPEC, dual_template=dual)(jstate, batch)

    tx = build_optimizer(cfg)
    state = create_train_state(_port_model(v), tx, device="cpu")
    state, met = make_train_step(tx, spec=SPEC, dual_template=dual)(state, _t(batch))
    for k in ("loss", "cls_loss", "reg_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    _assert_stats(state.model, jstate.batch_stats)
    ref = _port_flat(jstate.params)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=0, atol=1e-6, err_msg=k)
    for k in ("cls_map", "reg_map"):
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(met["visibility"].numpy(), np.asarray(jmet["visibility"]))
    np.testing.assert_allclose(met["ious"].numpy(), np.asarray(jmet["ious"]), rtol=1e-5, atol=1e-6)
    for k in ("box_iou", "failure_rate"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert state.step == 1


def test_adam_state_carries_over_mid_training():
    """Two JAX Adam steps, then the JAX state (params, batch_stats, optax
    mu/nu/count) carried onto the port; one more step on each side."""
    v = _variables(5)
    jm, jtx = _jax_model(), j_build_optimizer({"name": "adam", "lr": 1e-3})
    jstep = j_make_train_step(jm, jtx, spec=JSPEC)
    jstate = JTrainState(v["params"], v["batch_stats"], jtx.init(v["params"]), jnp.zeros((), jnp.int32))
    for s in (6, 7):
        jstate, _ = jstep(jstate, _batch(s))
    adam = jstate.opt_state.inner_state[0]
    tx = build_optimizer({"name": "adam", "lr": 1e-3})
    state = create_train_state(
        _port_model({"params": jstate.params, "batch_stats": jstate.batch_stats}), tx, device="cpu")
    load_adam_state(state.opt_state, jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
                    adam.count)
    assert int(state.opt_state["count"]) == 2
    batch = _batch(8)
    zero = _zero_gradients(_port_flat(_jax_grads(jm, {"params": jstate.params, "batch_stats": jstate.batch_stats},
                                                 batch)))
    jstate, jmet = jstep(jstate, batch)
    state, met = make_train_step(tx, spec=SPEC)(state, _t(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    _assert_stats(state.model, jstate.batch_stats)
    ref = _port_flat(jstate.params)
    for k, p in state.model.named_parameters():
        # Adam's step is about lr per element whatever the gradient's size,
        # so a parameter whose gradient is rounding noise moves by a noise
        # of up to ~lr on each side
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=0, atol=3e-3 if k in zero else 2e-6,
                                   err_msg=k)
    mu = _port_flat(jstate.opt_state.inner_state[0].mu)
    mmax = max(float(np.abs(m).max()) for m in mu.values())
    for k, m in state.opt_state["mu"].items():
        np.testing.assert_allclose(m.numpy(), mu[k], rtol=0, atol=1e-5 * mmax, err_msg=k)


OPT_CONFIGS = {
    "adam": {"name": "adam", "lr": 1e-3},
    "adamw": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6},
    "sgd_nesterov": {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True},
    "clip": {"name": "adam", "lr": 1e-3, "gradient_clip_val": 0.5},
    "warmup": {"name": "adam", "lr": 1e-3, "warmup_steps": 2},
    "skip_non_finite": {"name": "adam", "lr": 1e-3, "skip_non_finite": 1, "gradient_clip_val": 5.0},
}


@pytest.mark.parametrize("name", sorted(OPT_CONFIGS))
def test_optimizer_chain_matches_optax(name):
    """The same gradients through both chains, three steps (the third a NaN
    step for ``skip_non_finite``): the updates rtol 1e-6, and the
    parameters at the end."""
    cfg = OPT_CONFIGS[name]
    rng = np.random.RandomState(9)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jtx, tx = j_build_optimizer(cfg), build_optimizer(cfg)
    jp, jst = dict(params), None
    jst = jtx.init(jp)
    tp = {k: torch.tensor(a) for k, a in params.items()}
    st = tx.init(tp)
    for i in range(3):
        g = {k: (rng.randn(*s) * (3.0 if name == "clip" else 1.0)).astype(np.float32) for k, s in shapes.items()}
        if name == "skip_non_finite" and i == 1:
            g["b"][2] = np.nan
        ju, jst = jtx.update(g, jst, jp)
        jp = optax.apply_updates(jp, ju)
        u, st = tx.update({k: torch.tensor(a) for k, a in g.items()}, st, tp)
        apply_updates(tp, u)
        for k in shapes:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=1e-12,
                                       err_msg=f"step {i} {k}")
        if name == "warmup" and i == 0:
            assert all(float(np.abs(u[k].numpy()).max()) == 0.0 for k in shapes)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    if name == "skip_non_finite":
        assert int(st["total_notfinite"]) == 1 and bool(st["last_finite"])
        assert int(st["count"]) == int(jst.inner_state[1].inner_state[0].count) == 2


def test_learning_rate_is_injected_and_plateau_halves_it():
    tx = build_optimizer({"name": "adam", "lr": 1e-3, "warmup_steps": 3})
    st = tx.init({"w": torch.zeros(2)})
    assert get_learning_rate(st) == pytest.approx(1e-3)
    set_learning_rate(st, 5e-4)
    assert get_learning_rate(st) == pytest.approx(5e-4)
    sched = PlateauScheduler(mode="max", patience=1)
    lr = 1e-3
    for metric in (0.5, 0.4, 0.3):
        lr = sched.update(metric, lr)
    assert lr == pytest.approx(5e-4)
    with pytest.raises(ValueError):
        build_optimizer({"name": "lamb"})


def test_multistep_equals_sequential_steps():
    v = _variables(10)
    tx = build_optimizer({"name": "adam", "lr": 1e-3})
    step = make_train_step(tx, spec=SPEC)
    batches = [_t(_batch(s)) for s in (11, 12, 13)]
    a = create_train_state(_port_model(v), tx, device="cpu")
    losses = []
    for b in batches:
        a, m = step(a, b)
        losses.append(float(m["loss"]))
    b_state = create_train_state(_port_model(v), build_optimizer({"name": "adam", "lr": 1e-3}), device="cpu")
    b_state, mm = make_train_multistep(step, 3)(b_state, stack_batches(batches))
    assert mm["loss"].shape == (3,) and mm["ious"].shape == (3, 4)
    np.testing.assert_array_equal(mm["loss"].numpy(), np.asarray(losses, np.float32))
    for (k, p), q in zip(a.model.state_dict().items(), b_state.model.state_dict().values()):
        assert torch.equal(p, q), k
    assert a.step == b_state.step == 3
    with pytest.raises(ValueError):
        make_train_multistep(step, 0)


def test_multistep_matches_jax_scan():
    """Two steps as JAX's ``lax.scan`` of them; SGD, so that the second
    step's statistics do not carry Adam's sign-like step on the noise of
    the analytically zero gradients."""
    v = _variables(14)
    cfg = {"name": "sgd", "lr": 0.05, "momentum": 0.9}
    jm, jtx = _jax_model(), j_build_optimizer(cfg)
    batches = [_batch(s) for s in (15, 16)]
    jstate = JTrainState(v["params"], v["batch_stats"], jtx.init(v["params"]), jnp.zeros((), jnp.int32))
    jstate, jmet = j_multistep(j_make_train_step(jm, jtx, spec=JSPEC), 2)(
        jstate, {k: np.stack([b[k] for b in batches]) for k in batches[0]})
    tx = build_optimizer(cfg)
    state = create_train_state(_port_model(v), tx, device="cpu")
    state, met = make_train_multistep(make_train_step(tx, spec=SPEC), 2)(
        state, stack_batches([_t(b) for b in batches]))
    np.testing.assert_allclose(met["loss"].numpy(), np.asarray(jmet["loss"]), rtol=1e-5)
    _assert_stats(state.model, jstate.batch_stats)


def test_nan_batch_leaves_the_state_untouched():
    """``skip_non_finite`` + ``guard_non_finite``: a batch with a NaN pixel
    changes no parameter, no BatchNorm statistic and no optimizer state; the
    step count still moves, as JAX's does."""
    v = _variables(17)
    cfg = {"name": "adam", "lr": 1e-3, "skip_non_finite": 3}
    tx = build_optimizer(cfg)
    state = create_train_state(_port_model(v), tx, device="cpu")
    step = make_train_step(tx, spec=SPEC, guard_non_finite=True)
    state, _ = step(state, _t(_batch(18)))
    before = copy.deepcopy(state.state_dict())
    bad = _batch(19)
    bad[C.TRACKER_TARGET_SEARCH_IMAGE_KEY][0, 3, 3, 0] = np.nan
    state, met = step(state, _t(bad))
    assert not np.isfinite(float(met["loss"]))
    for k, p in state.model.state_dict().items():
        assert torch.equal(p, before["model"][k]), k
    for part in ("mu", "nu"):
        for k, m in state.opt_state[part].items():
            assert torch.equal(m, before["opt_state"][part][k]), (part, k)
    assert int(state.opt_state["count"]) == 1 and int(state.opt_state["notfinite_count"]) == 1
    assert state.step == 2


def test_mesh_raises_and_cuda_default_raises_without_a_card():
    """A mesh that is not a process group raises (the data-parallel step is
    ``tests/test_torch_dp_step.py``'s)."""
    tx = build_optimizer({})
    with pytest.raises(TypeError, match="process group"):
        make_train_step(tx, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_train_state(_port_model(_variables(0)), tx)


def test_bf16_step_loss_near_jax_bf16():
    v = _variables(20)
    batch = _batch(21)
    cfg = {"name": "adam", "lr": 1e-4}
    jm, jtx = _jax_model(jnp.bfloat16), j_build_optimizer(cfg)
    jstate = JTrainState(v["params"], v["batch_stats"], jtx.init(v["params"]), jnp.zeros((), jnp.int32))
    _, jmet = j_make_train_step(jm, jtx, spec=JSPEC)(jstate, batch)
    tx = build_optimizer(cfg)
    state = create_train_state(_port_model(v), tx, device="cpu")
    conv_dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: conv_dtypes.add(o.dtype))
             for m in state.model.modules() if isinstance(m, torch.nn.Conv2d)]
    state, met = make_train_step(tx, spec=SPEC, dtype=torch.bfloat16)(state, _t(batch))
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=2e-2)
    # the precision policy ran: every convolution in bfloat16, and the loss
    # is not the float32 step's
    assert conv_dtypes == {torch.bfloat16}
    f32_state = create_train_state(_port_model(v), build_optimizer(cfg), device="cpu")
    _, f32_met = make_train_step(tx, spec=SPEC)(f32_state, _t(batch))
    assert float(met["loss"]) != float(f32_met["loss"])
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert met["cls_map"].dtype == torch.float32


def test_loss_and_metrics_match_jax():
    rng = np.random.RandomState(22)
    B, H, W = 3, 8, 8
    out = {C.TARGET_REGRESSION_LABEL_KEY: np.abs(rng.randn(B, H, W, 4)).astype(np.float32) * 10 + 1,
           C.TARGET_CLASSIFICATION_KEY: rng.randn(B, H, W, 1).astype(np.float32)}
    labels = (rng.rand(B, H, W, 1) > 0.7).astype(np.float32)
    tgt = {C.TARGET_REGRESSION_LABEL_KEY: np.abs(rng.randn(B, H, W, 4)).astype(np.float32) * 10 + 1,
           C.TARGET_CLASSIFICATION_KEY: labels, C.TARGET_REGRESSION_WEIGHT_KEY: labels[..., 0]}
    coeffs = {C.TARGET_CLASSIFICATION_KEY: 0.7, C.TARGET_REGRESSION_LABEL_KEY: 1.3}
    ref = JL.fear_loss({k: jnp.asarray(a) for k, a in out.items()}, {k: jnp.asarray(a) for k, a in tgt.items()},
                       coeffs)
    got = L.fear_loss(_t(out), _t(tgt), coeffs)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)
    # all-negative labels: the positive mean is 0, not NaN
    empty = dict(tgt, **{C.TARGET_CLASSIFICATION_KEY: np.zeros_like(labels),
                         C.TARGET_REGRESSION_WEIGHT_KEY: np.zeros_like(labels[..., 0])})
    got = L.fear_loss(_t(out), _t(empty))
    assert float(got[C.TARGET_REGRESSION_LABEL_KEY]) == 0.0
    assert np.isfinite(float(got[C.TARGET_CLASSIFICATION_KEY]))
    from feartracker_tpu.train.metrics import DatasetAwareSums as JSums
    from feartracker_tpu.train.metrics import failure_rate as j_failure_rate

    ious = np.asarray([0.0, 0.5, 0.0, 0.9], np.float32)
    mask = np.asarray([1, 1, 0, 1], np.float32)
    ids = np.asarray([0, 1, 1, 2], np.int32)
    assert float(failure_rate(torch.tensor(ious), torch.tensor(mask))) == pytest.approx(
        float(j_failure_rate(jnp.asarray(ious), jnp.asarray(mask))))
    sums = DatasetAwareSums.zeros(3).update(torch.tensor(ids), torch.tensor(ious), torch.tensor(mask))
    jsums = JSums.zeros(3).update(jnp.asarray(ids), jnp.asarray(ious), jnp.asarray(mask))
    assert sums.compute(["a", "b", "c"]) == pytest.approx(jsums.compute(["a", "b", "c"]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_flax_batchnorm_train_mode_in_its_dtype(dtype):
    """Train-mode BatchNorm (the fused call plus the running-statistics
    update) against Flax's formula written out in float64: it computes in
    float32 or wider (a float64 model stays float64, the witness of
    chip_smoke's phase 12a), returns the input's dtype, and moves the
    running statistics 0.9/0.1 with the biased variance."""
    from feartracker_tpu_torch.models.blocks import FlaxBatchNorm2d

    rng = np.random.RandomState(30)
    x64 = torch.tensor(rng.randn(3, 5, 6, 7) * 2.0 + 0.5)
    bn = FlaxBatchNorm2d(5, eps=1e-5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(rng.rand(5) + 0.5))
        bn.bias.copy_(torch.tensor(rng.randn(5)))
        bn.running_mean.copy_(torch.tensor(rng.randn(5)))
        bn.running_var.copy_(torch.tensor(rng.rand(5) + 0.5))
    ra_mean, ra_var = bn.running_mean.clone(), bn.running_var.clone()
    w64 = bn.weight.detach().clone().requires_grad_(True)
    mean = x64.mean(dim=(0, 2, 3))
    var = (x64 * x64).mean(dim=(0, 2, 3)) - mean * mean
    ref = (x64 - mean[None, :, None, None]) * (torch.rsqrt(var + 1e-5) * w64)[None, :, None, None] \
        + bn.bias.detach()[None, :, None, None]
    (ref_gw,) = torch.autograd.grad((ref * ref).sum(), w64)

    bn = bn.to(torch.float32 if dtype == torch.bfloat16 else dtype).train()
    x = x64.to(dtype).requires_grad_(True)
    y = bn(x)
    (gw,) = torch.autograd.grad((y.to(ref.dtype) ** 2).sum(), bn.weight)
    tol = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2e-2}[dtype]
    assert y.dtype == dtype
    np.testing.assert_allclose(y.detach().double().numpy(), ref.detach().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(gw.double().numpy(), ref_gw.numpy(), rtol=tol * 10)
    stats_tol = 1e-12 if dtype == torch.float64 else 1e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(bn.running_mean.double().numpy(), (0.9 * ra_mean + 0.1 * mean).numpy(),
                               rtol=stats_tol)
    np.testing.assert_allclose(bn.running_var.double().numpy(), (0.9 * ra_var + 0.1 * var).numpy(),
                               rtol=stats_tol)


def test_loss_keeps_float64_and_widens_bfloat16():
    rng = np.random.RandomState(31)
    out = {C.TARGET_REGRESSION_LABEL_KEY: torch.tensor(np.abs(rng.randn(2, 4, 4, 4)) * 10 + 1),
           C.TARGET_CLASSIFICATION_KEY: torch.tensor(rng.randn(2, 4, 4, 1))}
    labels = torch.tensor((rng.rand(2, 4, 4, 1) > 0.5).astype(np.float64))
    tgt = {C.TARGET_REGRESSION_LABEL_KEY: torch.tensor(np.abs(rng.randn(2, 4, 4, 4)) * 10 + 1),
           C.TARGET_CLASSIFICATION_KEY: labels, C.TARGET_REGRESSION_WEIGHT_KEY: labels[..., 0]}
    assert all(v.dtype == torch.float64 for v in L.fear_loss(out, tgt).values())
    low = L.fear_loss({k: v.to(torch.bfloat16) for k, v in out.items()},
                      {k: v.float() for k, v in tgt.items()})
    assert all(v.dtype == torch.float32 for v in low.values())
