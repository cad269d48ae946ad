"""The port's FEARNet against the Flax FEARNet: same weights, same inputs,
float32 on the CPU.

Tolerances: 1e-4 on the tiny model (float32 sums in other orders); 1e-3 on
full-width FEAR-XS, whose activations reach ~90 (float32 ulp there ~1e-5,
summed over 16 blocks and the head)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.convert.load import load_npz_variables
from feartracker_tpu.models import blocks as jblocks
from feartracker_tpu.models.fbnet import TINY_TRUNK as J_TINY
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net
from feartracker_tpu_torch.models import blocks
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet, build_family_model
from feartracker_tpu_torch.utils.constants import (
    TARGET_CLASSIFICATION_KEY as CLS,
    TARGET_REGRESSION_LABEL_KEY as REG,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed_tiny_variables(seed):
    """Flax TINY FEARNet variables with non-trivial running stats, as numpy."""
    model = JFEARNet(trunk_blocks=J_TINY, adjust_channels=16, towernum=1)
    rng = np.random.RandomState(seed)
    v = model.init(
        jax.random.PRNGKey(0),
        (np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 64, 64, 3), np.float32)),
        train=False,
    )
    stats = jax.tree.map(
        lambda a: a + jnp.abs(jnp.asarray(rng.rand(*a.shape), jnp.float32)) * 0.5, v["batch_stats"]
    )
    v = {"params": v["params"], "batch_stats": stats}
    return model, jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def tiny():
    jmodel, v = _perturbed_tiny_variables(2)
    model = load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), v).eval()
    return jmodel, v, model


def test_tiny_get_features_matches_flax(tiny):
    jmodel, v, model = tiny
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jmodel.apply(v, x, method=jmodel.get_features))
    with torch.no_grad():
        got = model.get_features(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_tiny_connector_matches_flax(tiny):
    jmodel, v, model = tiny
    rng = np.random.RandomState(4)
    z = rng.randn(2, 4, 4, 16).astype(np.float32)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    ref = jmodel.apply(v, z, x, method=jmodel.connector)
    with torch.no_grad():
        got = model.connector(torch.from_numpy(z), torch.from_numpy(x))
    for key in (CLS, REG):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=1e-5)


def test_tiny_dual_template_hook_matches_flax(tiny):
    jmodel, v, model = tiny
    rng = np.random.RandomState(5)
    z, u = rng.randn(2, 2, 4, 4, 16).astype(np.float32)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    ref = jmodel.apply(v, z, x, u, method=jmodel.connector)
    with torch.no_grad():
        got = model.connector(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_allclose(got[CLS].numpy(), np.asarray(ref[CLS]), atol=1e-4, rtol=1e-5)


def test_fear_xs_track_matches_flax():
    v = load_npz_variables(PACKAGED_FEAR_XS)
    jmodel = JFEARNet()
    model = load_fear_net(build_family_model("fear_xs"), jax.tree.map(np.asarray, v)).eval()
    rng = np.random.RandomState(6)
    template = rng.randn(1, 128, 128, 3).astype(np.float32)
    search = rng.randn(1, 256, 256, 3).astype(np.float32)
    zf = jmodel.apply(v, template, method=jmodel.get_features)
    ref = jmodel.apply(v, search, zf, method=jmodel.track)
    with torch.no_grad():
        tz = model.get_features(torch.from_numpy(template))
        got = model.track(torch.from_numpy(search), tz)
    np.testing.assert_allclose(tz.numpy(), np.asarray(zf), atol=1e-3)
    for key in (CLS, REG):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-3, rtol=1e-4)


def test_pixelwise_correlation_and_flatten_match_jax():
    rng = np.random.RandomState(7)
    z = rng.randn(2, 4, 4, 8).astype(np.float32)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    zf = blocks.flatten_template(torch.from_numpy(z))
    np.testing.assert_array_equal(zf.numpy(), np.asarray(jblocks.flatten_template(jnp.asarray(z))))
    got = blocks.pixelwise_correlation(zf, torch.from_numpy(x)).numpy()
    ref = np.asarray(jblocks.pixelwise_correlation(jblocks.flatten_template(jnp.asarray(z)), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_build_family_model_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown model"):
        build_family_model("fear_xxl")
    assert build_family_model("fear_l").connect_model.towernum == 3
