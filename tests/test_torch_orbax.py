"""The port's Orbax reader (``convert/ocdbt.py``, ``convert/orbax.py``) and
the resume of a JAX run on the port, against orbax and the JAX package, on
the CPU.

* Checkpoints written by JAX's own ``CheckpointManager`` after two JAX
  train steps of the tiny model (non-zero moments) under three optax
  chains: adam with warmup, clipping and skipping; adamw; sgd with Nesterov
  momentum. ``read_orbax_tree`` equals ``StandardCheckpointer().restore``
  in structure, dtypes and bits, for ``last/state`` and the ranked
  ``<step>/default``.
* ``load_orbax_variables`` and ``load_variables`` equal JAX's in the four
  path forms, and raise JAX's errors; a corrupt byte in a file holding a
  b-tree node, and an unsupported layout, raise.
* ``CheckpointManager.restore_last`` maps the JAX state onto the port's; the
  first float32 step from it equals JAX's first step from the same
  checkpoint at the one-step tolerances of ``test_torch_train_step.py``
  (loss rtol 1e-5; parameters atol 2e-6, or 3e-3·lr-scale where the
  gradient is rounding noise; BatchNorm statistics rtol 1e-5; moments
  within 1e-5 of their largest value).
* The port's ``Trainer`` resumes a JAX experiment folder: the step, the
  epoch of ``meta.json`` and the injected learning rate are JAX's.
* The committed ``tests/fixtures/orbax_fear_xs`` reads as ``fear_xs.npz``
  in both packages; a CPU ``ScanTracker`` built from it tracks as one built
  from the archive; and it reads with jax, orbax, tensorstore, zstandard,
  cv2 and the JAX package blocked (the card host has none of them)."""

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from test_torch_train_step import JSPEC, SPEC, _assert_stats, _batch, _jax_model, _nest, _port_flat, _port_model, _t
from test_torch_train_step import _zero_gradients

from feartracker_tpu.convert.load import load_variables as j_load_variables
from feartracker_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from feartracker_tpu.train.checkpoint import load_orbax_variables as j_load_orbax_variables
from feartracker_tpu.train.optim import build_optimizer as j_build_optimizer
from feartracker_tpu.train.step import TrainState as JTrainState
from feartracker_tpu.train.step import make_train_step as j_make_train_step
from feartracker_tpu_torch.convert import load as L
from feartracker_tpu_torch.convert.ocdbt import OcdbtError
from feartracker_tpu_torch.convert.orbax import load_orbax_variables, read_orbax_tree
from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.train.checkpoint import CheckpointManager
from feartracker_tpu_torch.train.optim import build_optimizer
from feartracker_tpu_torch.train.step import create_train_state, make_loss_and_grads, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax_fear_xs")
CHAINS = {
    "adam_warmup_clip_skip": {"name": "adam", "lr": 1e-3, "warmup_steps": 3, "gradient_clip_val": 1.0,
                              "skip_non_finite": 2},
    "adamw": {"name": "adamw", "lr": 1e-3, "weight_decay": 1e-2, "eps": 1e-7},
    "sgd": {"name": "sgd", "lr": 1e-3, "momentum": 0.9, "nesterov": True},
}
EPOCH = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(seed):
    """The tiny model's variables drawn as Flax's init draws them (kernels
    normal with variance 1/fan-in, biases zero) without compiling a Flax
    init, then moved off their identity values as
    ``test_torch_train_step._variables`` moves them. The values left as
    torch's constructor draws them (the head's convolution biases) come from
    a generator seeded with ``seed``: torch's default generator starts from
    a random seed in every process."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        flat = L.variables_of(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32))
    rng = np.random.RandomState(seed)
    for k, a in flat.items():
        if k.endswith("/kernel"):
            flat[k] = (rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = (a + rng.rand(*a.shape) * 0.5).astype(np.float32)
        elif k.endswith("/mean") or k.endswith("bn/bias"):
            flat[k] = (a + rng.randn(*a.shape) * 0.1).astype(np.float32)
        elif k.endswith("bn/scale"):
            flat[k] = (a * (1 + rng.rand(*a.shape) * 0.2)).astype(np.float32)
        elif k.endswith("template_gate"):
            flat[k] = np.full_like(a, 0.3)
    return _nest(flat)


@pytest.fixture(scope="module")
def fear_xs_fixture():
    """The committed fixture's tree, read once for the module."""
    return read_orbax_tree(os.path.join(FIXTURE, "checkpoints", "last", "state"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per chain: two JAX steps of the tiny model, saved by JAX's manager
    (ranked and last) as a JAX experiment folder would hold them."""
    v = _variables(5)  # drawn here once: the threads below share torch's default generator

    def train(cfg):
        jtx = j_build_optimizer(cfg)
        jstep = j_make_train_step(_jax_model(), jtx, spec=JSPEC)
        state = JTrainState(v["params"], v["batch_stats"], jtx.init(v["params"]), jnp.zeros((), jnp.int32))
        for s in (6, 7):
            state, _ = jstep(state, _batch(s))
        return jstep, jax.block_until_ready(state)

    # XLA compiles the three steps side by side
    with ThreadPoolExecutor(len(CHAINS)) as pool:
        trained = dict(zip(CHAINS, pool.map(train, CHAINS.values())))
    out = {}
    for name, cfg in CHAINS.items():
        jstep, state = trained[name]
        exp = str(tmp_path_factory.mktemp(name) / "exp" / "JAX_RUN")
        JCheckpointManager(os.path.join(exp, "checkpoints")).save(int(state.step), state, monitor=0.5,
                                                                 extra={"epoch": EPOCH})
        out[name] = SimpleNamespace(cfg=cfg, exp=exp, ckpt=os.path.join(exp, "checkpoints"), state=state,
                                    jstep=jstep, step=int(state.step))
    return out


def _same_tree(got, want, path="") -> None:
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    elif want is not None:
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path


def _same_flat(got, want) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("item", ["last", "ranked"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_tree_equals_orbax_restore(runs, chain, item):
    run = runs[chain]
    path = os.path.join(run.ckpt, "last", "state") if item == "last" else os.path.join(run.ckpt, str(run.step),
                                                                                        "default")
    want = ocp.StandardCheckpointer().restore(path)
    got = read_orbax_tree(path)
    _same_tree(got, want)
    assert int(got["step"]) == run.step == 2
    mu = jax.tree.leaves(got["opt_state"])
    assert any(np.abs(a).max() > 0 for a in mu if a is not None and a.dtype == np.float32 and a.ndim > 1)


@pytest.mark.parametrize("form", ["experiment", "checkpoints_root", "state_dir", "step_dir"])
def test_load_orbax_variables_and_load_variables_equal_jax(runs, form):
    run = runs["adam_warmup_clip_skip"]
    path = {"experiment": run.exp, "checkpoints_root": run.ckpt,
            "state_dir": os.path.join(run.ckpt, "last", "state"),
            "step_dir": os.path.join(run.ckpt, str(run.step))}[form]
    want = L.flatten_variables(jax.tree.map(np.asarray, j_load_orbax_variables(path)))
    _same_flat(L.flatten_variables(load_orbax_variables(path)), want)
    _same_flat(L.load_variables(path), L.flatten_variables(jax.tree.map(np.asarray, j_load_variables(path))))


def test_open_store_equals_tensorstore(runs, tmp_path):
    """Every key and value of the newest version, against tensorstore's
    OCDBT driver: a checkpoint's root store (values out of line under
    ``ocdbt.process_0/d/``), and stores made to need interior b-tree nodes
    (150-byte nodes, five levels), values in data files (8-byte inline
    limit), no compression, and 20 versions (older ones in version-tree
    nodes)."""
    import tensorstore as ts

    from feartracker_tpu_torch.convert.ocdbt import open_store

    def oracle(path):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
        return {k: kv.read(k).result().value for k in sorted(kv.list().result())}

    stores = [os.path.join(runs["adamw"].ckpt, "last", "state"), os.path.join(FIXTURE, "checkpoints", "last", "state")]
    for name, config, commits in (("deep", {"max_decoded_node_bytes": 150, "max_inline_value_bytes": 8}, 1),
                                  ("raw", {"compression": None}, 1), ("versions", {}, 20)):
        path = str(tmp_path / name)
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/", "config": config}).result()
        for c in range(commits):
            with ts.Transaction() as txn:
                for i in range(40 if commits == 1 else 2):
                    kv.with_transaction(txn)[f"key{c:02d}{i:03d}/v".encode()] = b"v%d." % i * (1 + i % 7)
        stores.append(path)
    for path in stores:
        want = oracle(path)
        assert open_store(path) == want and len(want) > 1, path


def test_load_orbax_variables_raises_jax_s_errors(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        j_load_orbax_variables(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        load_orbax_variables(str(tmp_path))
    assert str(got.value) == str(want.value)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "state"), {"params": {"w": np.ones(3, np.float32)}, "step": np.int32(4)})
    ckptr.wait_until_finished()
    with pytest.raises(ValueError) as want:
        j_load_orbax_variables(str(tmp_path))
    with pytest.raises(ValueError) as got:
        load_orbax_variables(str(tmp_path))
    assert str(got.value) == str(want.value)


def test_a_corrupt_byte_raises(tmp_path):
    """The root store's manifest and b-tree node files carry a CRC-32C: one
    flipped byte in any of them raises. (The arrays' bytes sit in raw data
    files, which OCDBT does not checksum: tensorstore reads them unchecked
    too.)"""
    src = os.path.join(FIXTURE, "checkpoints", "last", "state")
    framed = ["manifest.ocdbt"] + [os.path.join("d", f) for f in os.listdir(os.path.join(src, "d"))]
    for rel in framed:
        bad = str(tmp_path / rel.replace(os.sep, "_"))
        shutil.copytree(src, bad)
        with open(os.path.join(bad, rel), "r+b") as fh:
            data = bytearray(fh.read())
            data[len(data) // 2] ^= 0x20
            fh.seek(0)
            fh.write(data)
        with pytest.raises(OcdbtError, match="CRC-32C"):
            read_orbax_tree(bad)


@pytest.mark.parametrize("key,value,feature", [("use_zarr3", True, "zarr v3"), ("use_ocdbt", False, "OCDBT")])
def test_unsupported_layouts_raise(runs, tmp_path, key, value, feature):
    state = str(tmp_path / "state")
    shutil.copytree(os.path.join(runs["sgd"].ckpt, "last", "state"), state)
    with open(os.path.join(state, "_METADATA")) as fh:
        meta = json.load(fh)
    meta[key] = value
    with open(os.path.join(state, "_METADATA"), "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(OcdbtError, match=f"{feature}.*tools/export_weights.py"):
        read_orbax_tree(state)


def _holding(state, field):
    """The optax state (a namedtuple) in a chain's state that has ``field``."""
    if field in getattr(state, "_fields", ()):
        return state
    if isinstance(state, tuple):
        for sub in state:
            found = _holding(sub, field)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_first_step_after_restore_matches_jax(runs, chain):
    """The first float32 step after the restore, the port's against JAX's
    from the same checkpoint. Under load (six copies at once) neither side's
    arithmetic varied: repeated, each step gave the same bits. The
    checkpoint did: the head's convolution biases kept the draws of torch's
    default generator, which starts from a random seed in every process,
    made in the fixture's three threads at once, and from some starting
    points Adam carried the steps' rounding past 2e-6. ``_variables`` now
    draws them from a seeded generator, once, before the threads, so every
    run compares the same step."""
    run = runs[chain]
    tx = build_optimizer(run.cfg)
    v = _variables(0)  # other weights: the restore must replace them
    state = create_train_state(_port_model(v), tx, device="cpu")
    state = CheckpointManager(run.ckpt, optimizer=tx).restore_last(state)
    assert state.step == run.step
    assert float(state.opt_state["lr"]) == np.float32(run.cfg["lr"])
    jstate = JCheckpointManager(run.ckpt).restore_last(run.state)
    batch = _batch(8)
    probe = create_train_state(_port_model({"params": jstate.params, "batch_stats": jstate.batch_stats}), tx,
                               device="cpu")
    zero = _zero_gradients({k: g.numpy() for k, g in make_loss_and_grads()(probe.model, _t(batch))[3].items()})
    jstate, jmet = run.jstep(jstate, batch)
    state, met = make_train_step(tx, spec=SPEC)(state, _t(batch))
    assert state.step == int(jstate.step) == run.step + 1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    _assert_stats(state.model, jstate.batch_stats)
    ref = _port_flat(jstate.params)
    scale = 3.0 * run.cfg["lr"]
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=0, atol=scale if k in zero else 2e-6,
                                   err_msg=k)
    restored = read_orbax_tree(os.path.join(run.ckpt, "last", "state"))["opt_state"]
    moments = ("trace",) if run.cfg["name"] == "sgd" else ("mu", "nu")
    rule = _holding(jax.tree.map(np.asarray, jstate.opt_state), moments[0])
    for m in moments:
        want = _port_flat(getattr(rule, m))
        mmax = max(float(np.abs(a).max()) for a in want.values())
        for k, t in state.opt_state[m].items():
            np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=1e-5 * mmax, err_msg=f"{m} {k}")
    if run.cfg["name"] != "sgd":
        assert int(state.opt_state["count"]) == int(rule.count) == run.step + 1
    if chain == "adam_warmup_clip_skip":
        assert int(state.opt_state["warmup_count"]) == run.step + 1
        assert int(state.opt_state["notfinite_count"]) == 0 and bool(state.opt_state["last_finite"])
        assert restored["inner_state"][0] is None  # clip_by_global_norm's empty state


def test_manager_ranks_and_restores_a_jax_run(runs, tmp_path):
    """The JAX run's ranked step ranks beside the port's and restores from
    ``<step>/default``; without the optimizer the restore raises; once the
    port has saved ``last/state.pt`` beside the Orbax save, it wins."""
    run = runs["sgd"]
    ckpt = str(tmp_path / "checkpoints")
    shutil.copytree(run.ckpt, ckpt)
    tx = build_optimizer(run.cfg)
    mgr = CheckpointManager(ckpt, optimizer=tx)
    assert mgr.steps() == [run.step] and mgr.best_step() == run.step and mgr.has_last()
    ranked = mgr.restore(create_train_state(_port_model(_variables(0)), tx, device="cpu"))
    last = mgr.restore_last(create_train_state(_port_model(_variables(0)), tx, device="cpu"))
    a, b = ranked.state_dict(), last.state_dict()
    assert a["step"] == b["step"] == run.step
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert all(torch.equal(a["opt_state"]["trace"][k], b["opt_state"]["trace"][k]) for k in a["opt_state"]["trace"])
    with pytest.raises(ValueError, match="needs the optimizer"):
        CheckpointManager(ckpt).restore_last(create_train_state(_port_model(_variables(0)), tx, device="cpu"))
    last.step = 99
    mgr.save(99, last, monitor=None)
    assert mgr.restore_last(create_train_state(_port_model(_variables(0)), tx, device="cpu")).step == 99


def test_optimizer_state_from_jax_refuses_another_chain(runs):
    tree = read_orbax_tree(os.path.join(runs["adamw"].ckpt, "last", "state"))["opt_state"]
    with pytest.raises(ValueError, match="warmup"):
        L.optimizer_state_from_jax(tree, build_optimizer({"name": "adam", "warmup_steps": 3}))
    with pytest.raises(ValueError, match="momentum trace"):
        L.optimizer_state_from_jax(tree, build_optimizer({"name": "sgd"}))


def test_trainer_resumes_a_jax_experiment(runs, tmp_path):
    """``resume: true`` on the folder JAX's Trainer would have written: the
    step from the state, the epoch from ``meta.json``, the injected lr."""
    import pandas as pd
    from test_trainer_integration import _make_track_images

    from feartracker_tpu_torch.train.loop import Trainer
    from feartracker_tpu_torch.train.summary import read_events, scalars

    run = runs["adam_warmup_clip_skip"]
    root = str(tmp_path)
    pd.DataFrame(_make_track_images(root)).to_csv(os.path.join(root, "train.csv"), index=False)
    cfg = {
        "platform": "cpu", "num_devices": 1, "precision": "float32", "seed": 0, "resume": True,
        "model": {"name": "fear_tiny", "adjust_channels": 16, "towernum": 1},
        "tracker": {"score_size": 8, "total_stride": 8, "instance_size": 64, "template_size": 32},
        "optimizer": dict(run.cfg), "loss": {"coeffs": {"TARGET_CLASSIFICATION_KEY": 1,
                                                        "TARGET_REGRESSION_LABEL_KEY": 1}},
        "batch_size": {"train": 4, "val": 1}, "num_workers": 1, "max_epochs": EPOCH + 1, "sanity_steps": 0,
        "log_every_n_steps": 1, "save_top_k": 2,
        "experiment": {"folder": os.path.dirname(run.exp), "name": os.path.basename(run.exp)},
        "train": {"datasets": [{
            "name": "synthetic", "root": root,
            "sizes": {"search_image_size": 64, "template_image_size": 32, "search_context": 2,
                      "template_bbox_offset": 0.2, "search_image_shift": 8, "search_image_scale": 0.2,
                      "context_range": 1},
            "regression_weight_label_size": 8,
            "sampling": {"type": "track", "data_path": os.path.join(root, "train.csv"), "negative_ratio": 0,
                         "frame_offset": 4, "num_samples": 8, "clip_range": True},
        }]},
        "val": {"datasets": []},
    }
    trainer = Trainer(cfg)
    seen = {}
    restore_last = trainer.ckpt.restore_last

    def spy(state):
        state = restore_last(state)
        seen.update(step=state.step, lr=float(state.opt_state["lr"]),
                    warmup=int(state.opt_state["warmup_count"]))
        return state

    trainer.ckpt.restore_last = spy
    trainer.fit()
    assert seen == {"step": run.step, "lr": float(np.float32(run.cfg["lr"])), "warmup": run.step}
    assert trainer.resumed_epoch == EPOCH
    assert trainer.state.step == run.step + 2  # one epoch of 8 samples at B=4
    losses = scalars(read_events(os.path.join(trainer.exp_dir, "logs")))["train/loss"]
    assert [s for s, _ in losses] == [run.step + 1, run.step + 2] and all(np.isfinite(v) for _, v in losses)


def test_committed_fixture_reads_as_fear_xs_npz(fear_xs_fixture):
    want = L.variables_from_npz("fear_xs")
    tree = fear_xs_fixture
    _same_flat(L.flatten_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]}), want)
    _same_flat(L.flatten_variables(jax.tree.map(np.asarray, j_load_variables(FIXTURE))), want)
    assert int(tree["step"]) == 1234 and tree["step"].dtype == np.int32
    with open(os.path.join(FIXTURE, "checkpoints", "last", "meta.json")) as fh:
        assert json.load(fh) == {"epoch": 3}


def test_scan_tracker_from_the_orbax_dir_tracks_as_from_the_npz():
    f0, chunk, boxes = synthetic_streams(2, 3, seed=4, device="cpu")
    outs = []
    for weights in (FIXTURE, "fear_xs"):
        tracker, _ = build_scan_tracker(weights, dtype=torch.float32, device="cpu")
        state = tracker.init(f0, boxes)
        outs.append(tracker.track(state, chunk)[1])
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_reader_needs_none_of_jax_orbax_tensorstore_zstandard_cv2():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'orbax.checkpoint', 'tensorstore', 'zstandard',\n"
        "          'cv2', 'feartracker_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from feartracker_tpu_torch.convert.load import flatten_variables, variables_from_npz\n"
        "from feartracker_tpu_torch.convert.orbax import find_orbax_state, read_orbax_tree\n"
        f"tree = read_orbax_tree(find_orbax_state({FIXTURE!r}))\n"
        "got = flatten_variables({'params': tree['params'], 'batch_stats': tree['batch_stats']})\n"
        "want = variables_from_npz('fear_xs')\n"
        "assert sorted(got) == sorted(want) and all(got[k].tobytes() == want[k].tobytes() for k in want)\n"
        "assert int(tree['step']) == 1234\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
