"""The plain twin of the fused inverted-residual kernel (plain_ir_block),
the BN fold and the folded trunk, against the JAX package on the CPU (its
Pallas kernel in interpret mode).

Tolerances: 2e-5 per block, as tests/test_fused_trunk.py holds the JAX
kernel to its XLA path; 1e-6 for the fold (the same float32 formula);
1e-4 for folded features against Flax, as in tests/test_fused_trunk.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.models.fbnet import IRBlockSpec as JSpec
from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu.ops import fused_trunk as jft
from feartracker_tpu.ops.pallas.ir_block import fused_ir_block as jfused_ir_block
from feartracker_tpu_torch.convert.load import load_fear_net
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK, IRBlockSpec
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block
from feartracker_tpu_torch.ops.fused_trunk import fold_fear_net, get_features_folded, plain_ir_block


def _random_block_np(rng, cin, e, k, cout):
    ce = cin * e
    mk = lambda *s: (rng.randn(*s) * 0.25).astype(np.float32)
    return {
        "expand": None if e == 1 else {"w": mk(cin, ce), "b": mk(ce)},
        "dw": {"w": mk(k, k, ce), "b": mk(ce)},
        "project": {"w": mk(ce, cout), "b": mk(cout)},
    }


def _tree(blk, fn):
    return {k: None if v is None else {n: fn(a) for n, a in v.items()} for k, v in blk.items()}


SHAPES = [
    (16, 6, 3, 2, 24, 32),   # FEAR-XS block1 shape family
    (24, 6, 5, 2, 32, 32),   # block4
    (32, 6, 5, 2, 64, 32),   # block8
    (32, 6, 5, 1, 32, 16),   # residual stride-1
    (112, 3, 5, 1, 112, 16),  # block15
    (32, 6, 3, 1, 32, 16),   # k3 stride-1
    (16, 2, 3, 2, 12, 32),   # TINY_TRUNK block1
]


@pytest.mark.parametrize("cin,e,k,s,cout,H", SHAPES)
def test_plain_block_matches_pallas_interpret(cin, e, k, s, cout, H):
    rng = np.random.RandomState(0)
    blk = _random_block_np(rng, cin, e, k, cout)
    x = rng.randn(2, H, H, cin).astype(np.float32)
    ref = np.asarray(jfused_ir_block(jnp.asarray(x), _tree(blk, jnp.asarray), JSpec(e, k, s, cout),
                                     interpret=True))
    got = plain_ir_block(torch.from_numpy(x), _tree(blk, torch.from_numpy), IRBlockSpec(e, k, s, cout))
    assert tuple(got.shape) == (2, H // s, H // s, cout)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("relu_dw,relu_out", [(True, False), (False, True)])
def test_plain_block_activation_modes_match_pallas(relu_dw, relu_out):
    rng = np.random.RandomState(1)
    blk = _random_block_np(rng, 16, 1, 3, 24)  # no expand: the SepConv-BN-ReLU form
    x = rng.randn(2, 16, 16, 16).astype(np.float32)
    ref = np.asarray(jfused_ir_block(jnp.asarray(x), _tree(blk, jnp.asarray), JSpec(1, 3, 1, 24),
                                     relu_dw=relu_dw, relu_out=relu_out, interpret=True))
    got = plain_ir_block(torch.from_numpy(x), _tree(blk, torch.from_numpy), IRBlockSpec(1, 3, 1, 24),
                         relu_dw=relu_dw, relu_out=relu_out)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_dispatcher_takes_plain_twin_on_cpu():
    rng = np.random.RandomState(2)
    blk = _tree(_random_block_np(rng, 32, 6, 5, 32), torch.from_numpy)
    x = torch.from_numpy(rng.randn(2, 16, 16, 32).astype(np.float32))
    spec = IRBlockSpec(6, 5, 1, 32)
    before = fused_ir_block.launches
    assert torch.equal(fused_ir_block(x, blk, spec), plain_ir_block(x, blk, spec))
    assert fused_ir_block.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ir_block(x.to("meta"), blk, spec)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    rng = np.random.RandomState(2)
    v = jmodel.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    stats = jax.tree.map(
        lambda a: a + jnp.abs(jnp.asarray(rng.rand(*a.shape), jnp.float32)) * 0.5, v["batch_stats"]
    )
    v = {"params": v["params"], "batch_stats": stats}
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    load_fear_net(model, jax.tree.map(np.asarray, v))
    return jmodel, v, model.eval()


def test_fold_matches_jax_fold(tiny):
    jmodel, v, model = tiny
    ref = jft.fold_fear_net(v, J_TINY)
    got = fold_fear_net(model)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    close(got["stem"]["w"].permute(2, 3, 1, 0), ref["stem"]["w"])  # OIHW → HWIO
    close(got["stem"]["b"], ref["stem"]["b"])
    for g, r in zip(got["blocks"], ref["blocks"]):
        assert (g["expand"] is None) == (r["expand"] is None)
        for part in ("expand", "dw", "project"):
            if g[part] is not None:
                close(g[part]["w"], r[part]["w"])
                close(g[part]["b"], r[part]["b"])
    close(got["neck"]["w"], ref["neck"]["w"])
    close(got["neck"]["b"], ref["neck"]["b"])


def test_fold_casts_matmul_weights_only(tiny):
    folded = fold_fear_net(tiny[2], torch.bfloat16)
    blk = folded["blocks"][1]
    assert blk["expand"]["w"].dtype == blk["project"]["w"].dtype == torch.bfloat16
    assert blk["dw"]["w"].dtype == blk["project"]["b"].dtype == torch.float32


def test_folded_features_match_flax(tiny):
    jmodel, v, model = tiny
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jmodel.apply(v, x, method=jmodel.get_features))
    got = get_features_folded(torch.from_numpy(x), fold_fear_net(model), TINY_TRUNK)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
