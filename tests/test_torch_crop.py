"""The port's batched crop engine and bbox geometry against the JAX
package's per-frame functions (vmapped). Tolerance 1e-3 on 0-255 pixels
(float32 contractions in another order); geometry is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.core import geometry_jax as jgeo
from feartracker_tpu.ops import crop as jcrop
from feartracker_tpu_torch.core import geometry as geo
from feartracker_tpu_torch.ops import crop

WINDOWS = np.array([
    [20.0, 10.0, 90.0, 80.0],     # inside
    [-30.0, -20.0, 100.0, 90.0],  # over top-left corner
    [100.0, 80.0, 120.0, 100.0],  # over bottom-right
    [200.0, 200.0, 50.0, 50.0],   # fully outside
], np.float32)
PAD = np.array([[100.0, 120.0, 140.0], [7.0, 8.0, 9.0], [0.0, 255.0, 30.0], [50.0, 60.0, 70.0]], np.float32)


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(0).randint(0, 255, (4, 120, 160, 3)).astype(np.uint8)


@pytest.mark.parametrize("impl", ["mm", "gather"])
def test_crop_matches_jax(frames, impl):
    f32 = frames.astype(np.float32)
    jfn = jcrop.crop_resize_mm if impl == "mm" else jcrop.crop_resize
    ref = np.asarray(jax.vmap(lambda f, w, p: jfn(f, w, 64, p))(
        jnp.asarray(f32), jnp.asarray(WINDOWS), jnp.asarray(PAD)))
    if impl == "mm":
        got = crop.crop_resize_mm(torch.from_numpy(frames), torch.from_numpy(WINDOWS), 64, torch.from_numpy(PAD))
    else:
        got = crop.crop_resize(torch.from_numpy(f32), torch.from_numpy(WINDOWS), 64, torch.from_numpy(PAD))
    assert tuple(got.shape) == (4, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    # the fully-outside window reads the pad color only
    np.testing.assert_allclose(got[3].reshape(-1, 3).numpy(), np.tile(PAD[3], (64 * 64, 1)), atol=1e-4)


def test_interp_matrix_matches_jax():
    R, w = crop._interp_matrix(torch.from_numpy(WINDOWS[:, 0]), torch.from_numpy(WINDOWS[:, 2]),
                               160, 32, torch.float32)
    for s in range(len(WINDOWS)):
        jR, jw = jcrop._interp_matrix(jnp.float32(WINDOWS[s, 0]), jnp.float32(WINDOWS[s, 2]),
                                      160, 32, jnp.float32)
        np.testing.assert_allclose(R[s].numpy(), np.asarray(jR), atol=1e-6)
        np.testing.assert_allclose(w[s].numpy(), np.asarray(jw), atol=1e-6)


def test_window_helpers_and_normalize_match_jax():
    rng = np.random.RandomState(1)
    boxes = np.concatenate([rng.uniform(-20, 200, (6, 2)), rng.uniform(3, 90, (6, 2))], 1).astype(np.float32)
    for offset in (0.2, 2.0):
        ref = np.asarray(jax.vmap(lambda b: jcrop.extended_crop_window(b, offset))(jnp.asarray(boxes)))
        np.testing.assert_array_equal(crop.extended_crop_window(torch.from_numpy(boxes), offset).numpy(), ref)
    win = np.array(jax.vmap(lambda b: jcrop.extended_crop_window(b, 2.0))(jnp.asarray(boxes)))
    ref = np.asarray(jax.vmap(lambda b, w: jcrop.crop_bbox_in_window(b, w, 256))(jnp.asarray(boxes), jnp.asarray(win)))
    got = crop.crop_bbox_in_window(torch.from_numpy(boxes), torch.from_numpy(win), 256).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    px = rng.uniform(0, 255, (2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(crop.normalize_imagenet(torch.from_numpy(px)).numpy(),
                               np.asarray(jcrop.normalize_imagenet(jnp.asarray(px))), rtol=1e-6, atol=1e-6)


def test_geometry_matches_jax():
    rng = np.random.RandomState(2)
    # half-integers exercise round-half-even; boxes cross every border
    boxes = (np.round(rng.uniform(-40, 300, (64, 4)) * 2) / 2).astype(np.float32)
    boxes[:, 2:] = np.abs(boxes[:, 2:]) % 60
    hw = (200, 260)
    for fn, jfn in ((geo.ensure_bbox_boundaries, jgeo.ensure_bbox_boundaries),
                    (geo.clamp_bbox, jgeo.clamp_bbox)):
        np.testing.assert_array_equal(fn(torch.from_numpy(boxes), hw).numpy(),
                                      np.asarray(jfn(jnp.asarray(boxes), hw)))
    crop_boxes = rng.uniform(-10, 250, (64, 4)).astype(np.float32)
    crop_boxes[:, 2:] = np.abs(crop_boxes[:, 2:])
    windows = np.abs(boxes) + np.array([0, 0, 16, 16], np.float32)
    np.testing.assert_array_equal(
        geo.rescale_crop_bbox(torch.from_numpy(crop_boxes), torch.from_numpy(windows), 256).numpy(),
        np.asarray(jgeo.rescale_crop_bbox(jnp.asarray(crop_boxes), jnp.asarray(windows), 256)),
    )
