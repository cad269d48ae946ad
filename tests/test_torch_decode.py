"""The plain twin of the fused decode kernel (core.postprocess.postprocess)
against the JAX decode, both its XLA form and its Pallas kernel run in
interpret mode. Tolerances as in tests/test_pallas_decode.py: bbox rtol 1e-5
/ atol 1e-4, confidence rtol 1e-5, coordinates exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.core import box_coder as jbc
from feartracker_tpu.core import postprocess as jpp
from feartracker_tpu.ops.pallas.decode import postprocess_pallas
from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.core import postprocess as pp
from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda


def _inputs(S=3, seed=0):
    rng = np.random.RandomState(seed)
    reg = (np.abs(rng.rand(S, 16, 16, 4)) * 40 + 4).astype(np.float32)
    logits = rng.randn(S, 16, 16, 1).astype(np.float32)
    prev = rng.uniform(20, 80, (S, 2)).astype(np.float32)
    return logits, reg, prev


def _assert_same(got, ref):
    np.testing.assert_allclose(got.bbox.numpy(), np.asarray(ref.bbox), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(ref.confidence), rtol=1e-5)
    np.testing.assert_array_equal(got.pred_coords.numpy(), np.asarray(ref.pred_coords))


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_plain_decode_matches_jax(smooth, reference):
    logits, reg, prev = _inputs()
    jcfg = jpp.PostprocessConfig(smooth=smooth)
    if reference == "xla":
        ref = jpp.postprocess(jnp.asarray(logits), jnp.asarray(reg), jcfg, prev_size=jnp.asarray(prev))
    else:
        ref = postprocess_pallas(jnp.asarray(logits), jnp.asarray(reg), jcfg,
                                 prev_size=jnp.asarray(prev), interpret=True)
    got = pp.postprocess(torch.from_numpy(logits), torch.from_numpy(reg),
                         pp.PostprocessConfig(smooth=smooth), prev_size=torch.from_numpy(prev))
    _assert_same(got, ref)


def test_tiebreak_row_major():
    cls = np.full((1, 16, 16, 1), -5.0, np.float32)
    cls[0, 4, 9, 0] = 3.0
    cls[0, 11, 2, 0] = 3.0
    reg = np.ones((1, 16, 16, 4), np.float32)
    got = pp.postprocess(torch.from_numpy(cls), torch.from_numpy(reg), pp.PostprocessConfig())
    ref = postprocess_pallas(jnp.asarray(cls), jnp.asarray(reg), jpp.PostprocessConfig(), interpret=True)
    assert got.pred_coords[0].tolist() == [4, 9] == np.asarray(ref.pred_coords)[0].tolist()


def test_apce_matches_jax():
    score = np.random.RandomState(1).rand(4, 16, 16).astype(np.float32)
    np.testing.assert_allclose(pp.apce(torch.from_numpy(score)).numpy(),
                               np.asarray(jpp.apce(jnp.asarray(score))), rtol=1e-5)


def test_box_coder_decode_matches_jax():
    logits, reg, _ = _inputs(S=2, seed=2)
    got = bc.decode(torch.from_numpy(reg), torch.from_numpy(logits))
    ref = jbc.decode(jnp.asarray(reg), jnp.asarray(logits))
    np.testing.assert_allclose(got.bbox.numpy(), np.asarray(ref.bbox), atol=1e-4)
    np.testing.assert_array_equal(got.pred_coords.numpy(), np.asarray(ref.pred_coords))
    np.testing.assert_allclose(got.peak_score.numpy(), np.asarray(ref.peak_score), rtol=1e-6)


@pytest.mark.parametrize("smooth", [False, True])
def test_dispatcher_takes_plain_twin_on_cpu(smooth):
    logits, reg, prev = _inputs(seed=3)
    cfg = pp.PostprocessConfig(smooth=smooth)
    args = (torch.from_numpy(logits), torch.from_numpy(reg), cfg)
    before = postprocess_cuda.launches
    got = postprocess_cuda(*args, prev_size=torch.from_numpy(prev))
    ref = pp.postprocess(*args, prev_size=torch.from_numpy(prev))
    assert postprocess_cuda.launches == before  # no kernel on the CPU
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_dispatcher_rejects_other_devices():
    x = torch.empty(2, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        postprocess_cuda(x, torch.empty(2, 16, 16, 4, device="meta"), pp.PostprocessConfig())
