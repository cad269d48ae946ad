"""K2 as a PyTorch operator and the deployment export, on the CPU.

* ``torch.library.opcheck`` on ``fear_port::ir_block`` in both dtypes (the
  bfloat16 block with its packed weights), and the operator equal to the
  plain twin in every mode.
* The export round trip on ``TINY_TRUNK`` with ``tests/test_export.py``'s
  inputs, against JAX's exported pair of the same weights: float32 within
  atol 1e-4 (the port folds BatchNorm into the convolutions, JAX applies
  it); the bfloat16 pair within 0.05 of the output's range plus two bf16
  steps at its magnitude (both round in bf16, at other places). Each graph calls K2's operator once per block of
  expansion > 1, and a process that has not registered the operator cannot
  load the graph.
* ``ExportedTracker`` against the port's ``FEARTracker`` of the same
  weights on a rendered clip: boxes within 1 px.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.convert.export import export_tracker as jexport_tracker
from feartracker_tpu.convert.export import load_exported as jload_exported
from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu_torch.convert.export import ExportedTracker, export_tracker, load_exported
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK, IRBlockSpec
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block_op, ir_block_args, pack_block
from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.tracker import FEARTracker

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


def _block(seed, cin, spec, dtype):
    rng = np.random.RandomState(seed)
    ce, k, cout = cin * spec.expansion, spec.kernel, spec.out_channels

    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dt)

    blk = {
        "expand": None if spec.expansion == 1 else {"w": t(cin, ce, scale=cin ** -0.5, dt=dtype), "b": t(ce, scale=0.1)},
        "dw": {"w": t(k, k, ce, scale=1 / k), "b": t(ce, scale=0.1)},
        "project": {"w": t(ce, cout, scale=ce ** -0.5, dt=dtype), "b": t(cout, scale=0.1)},
    }
    if dtype == torch.bfloat16 and spec.expansion > 1:
        blk["packed"] = pack_block(blk, cin, k)
    x = t(2, 8, 8, cin).to(dtype)
    return x, blk


BLOCKS = {
    "expand_s2": (8, IRBlockSpec(2, 3, 2, 12)),
    "residual_k5": (12, IRBlockSpec(3, 5, 1, 12)),
    "no_expand": (8, IRBlockSpec(1, 3, 1, 16)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ir_block_op_opcheck(dtype):
    x, blk = _block(0, 8, IRBlockSpec(2, 3, 2, 12), dtype)
    if dtype == torch.bfloat16:
        assert blk["packed"]["we"] is not None  # the packed weights go through as tensors
    args = (x, *ir_block_args(blk), 3, 2, True, False)
    result = torch.library.opcheck(torch.ops.fear_port.ir_block.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("relu", [(True, False), (False, True)], ids=["ir", "sep_bn_relu"])
def test_ir_block_op_equals_plain(name, relu):
    cin, spec = BLOCKS[name]
    x, blk = _block(1, cin, spec, torch.float32)
    got = fused_ir_block_op(x, blk, spec, *relu)
    assert torch.equal(got, plain_ir_block(x, blk, spec, *relu))
    assert got.shape == (2, 8 // spec.stride, 8 // spec.stride, spec.out_channels)


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    """JAX's TINY model and its weights, the port's model of the same
    weights, and both exported pairs."""
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    init = jax.jit(functools.partial(jmodel.init, train=False))  # one compile: half the eager init's time
    v = init(jax.random.PRNGKey(0), (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 64, 3))))
    model = load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32),
                          jax.tree.map(np.asarray, v))
    sizes = dict(template_size=32, instance_size=64, feat_size=4, channels=16, quantize=True)
    jdir, pdir = tmp_path_factory.mktemp("jax_export"), tmp_path_factory.mktemp("port_export")
    jpaths = jexport_tracker(jmodel, v, str(jdir), **sizes)
    paths = export_tracker(model, str(pdir), device="cpu", **sizes)
    return model, jpaths, paths


def test_export_pair_matches_jax(tiny_pair):
    _, jpaths, paths = tiny_pair
    assert set(paths) == set(jpaths) == {"tracker_init", "tracker", "tracker_init_quantized", "tracker_quantized"}
    assert all(p.endswith(".pt2") and os.path.getsize(p) > 0 for p in paths.values())
    rng = np.random.RandomState(0)
    template = rng.randint(0, 255, (1, 32, 32, 3)).astype(np.float32)
    search = rng.randint(0, 255, (1, 64, 64, 3)).astype(np.float32)

    jfeats = np.array(jload_exported(jpaths["tracker_init"])(template))
    feats = load_exported(paths["tracker_init"])(torch.from_numpy(template))
    assert feats.shape == (1, 4, 4, 16) and feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=1e-4, rtol=0)
    jreg, jcls = (np.asarray(a) for a in jload_exported(jpaths["tracker"])(search, jfeats))
    reg, cls = load_exported(paths["tracker"])(torch.from_numpy(search), torch.from_numpy(jfeats))
    assert reg.shape == (1, 8, 8, 4) and cls.shape == (1, 8, 8, 1)
    np.testing.assert_allclose(reg.numpy(), jreg, atol=1e-4, rtol=0)
    np.testing.assert_allclose(cls.numpy(), jcls, atol=1e-4, rtol=0)

    qfeats = load_exported(paths["tracker_init_quantized"])(torch.from_numpy(template))
    jqfeats = np.asarray(jload_exported(jpaths["tracker_init_quantized"])(template))
    jq = [np.asarray(a) for a in jload_exported(jpaths["tracker_quantized"])(search, jfeats)]
    q = load_exported(paths["tracker_quantized"])(torch.from_numpy(search), torch.from_numpy(jfeats))
    for got, want in ((qfeats, jqfeats), (q[0], jq[0]), (q[1], jq[1])):
        assert got.dtype == torch.float32  # bf16 inside, f32 out
        err = np.abs(got.numpy() - want).max()
        # 0.05 of the output's range, and no less than two bf16 steps at its
        # magnitude: the tiny head's reg map spans 2.71-2.74, under two steps
        # of 2^-6 there
        assert err <= 0.05 * (want.max() - want.min()) + 2 * 2.0 ** -7 * np.abs(want).max(), \
            (err, want.min(), want.max())


def test_exported_graphs_call_the_k2_operator(tiny_pair):
    _, _, paths = tiny_pair
    n_kernel_blocks = sum(s.expansion > 1 for s in TINY_TRUNK)
    for name, path in paths.items():
        ops = [n for n in torch.export.load(path).graph.nodes if "fear_port.ir_block" in str(n.target)]
        assert len(ops) == n_kernel_blocks, name
    code = ("import sys, torch\n"
            "try:\n    torch.export.load(sys.argv[1])\nexcept Exception as e:\n    print(type(e).__name__, e)\n"
            "    sys.exit(3)\n")
    proc = subprocess.run([sys.executable, "-c", code, paths["tracker"]], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 3 and "fear_port.ir_block" in proc.stdout + proc.stderr, proc.stdout + proc.stderr


def _clip(n=10, hw=(96, 128), seed=5):
    """A textured 24×18 box drifting over a noise background."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 256, hw + (3,))
    tex = rng.randint(0, 256, (18, 24, 3))
    frames, x, y = [], 40, 30
    for t in range(n):
        f = np.clip(bg + rng.randint(-6, 7, bg.shape), 0, 255)
        f[y + t:y + t + 18, x + 2 * t:x + 2 * t + 24] = tex
        frames.append(f.astype(np.uint8))
    return frames, np.array([x, y, 24, 18], np.float32)


def test_exported_tracker_matches_fear_tracker(tiny_pair):
    model, _, paths = tiny_pair
    frames, box = _clip()
    cfg = TrackerConfig(**TINY_CFG)

    def run(tracker):
        tracker.initialize(frames[0], box)
        return np.array([tracker.update(f)["bbox"] for f in frames[1:]], np.float64)

    exported = ExportedTracker(paths["tracker_init"], paths["tracker"], cfg, device="cpu")
    assert exported.dtype == torch.float32
    got, want = run(exported), run(FEARTracker(model, cfg, device="cpu"))
    assert np.abs(got - want).max() <= 1.0, (got, want)
    exported.reset()
    with pytest.raises(RuntimeError, match="initialize"):
        exported.update(frames[1])
    assert ExportedTracker(paths["tracker_init_quantized"], paths["tracker_quantized"], cfg,
                           device="cpu").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="exported"):
        ExportedTracker(paths["tracker_init"], paths["tracker"], cfg, device="cuda")
