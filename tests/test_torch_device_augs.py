"""The port's device augmentations against the JAX package's, on the CPU.

JAX draws with threefry keys, which torch cannot reproduce; so the tests
read the parameters JAX draws from its keys (the same ``jax.random`` calls
on the same split keys) and feed them to the port's apply, and hold the
port's own draws to their configured ranges and rates.

Tolerances: pixel values (0-255, float32) within 1e-5 relative and 1e-5·255
absolute, normalized images too after un-normalizing them (float32 sums in
other orders than XLA's); boxes and label maps exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.data import device_augs as J
from feartracker_tpu.ops.crop import crop_resize_mm as j_crop_resize_mm
from feartracker_tpu_torch.data import device_augs as A
from feartracker_tpu_torch.ops.crop import crop_resize_mm
from feartracker_tpu_torch.utils import constants as C

CFG_KW = dict(search_size=32, scale=0.2, shift=4.0, grid_size=4, total_stride=8)
PIX = dict(rtol=1e-5, atol=1e-5 * 255)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _staged(seed, B=4, s=32, t=16, aux=False, presence=None):
    rng = np.random.RandomState(seed)
    batch = {
        A.STAGED_SEARCH_KEY: rng.randint(0, 256, (B, 2 * s, 2 * s, 3)).astype(np.uint8),
        A.STAGED_SEARCH_BBOX_KEY: np.concatenate([rng.uniform(s - 8, s + 4, (B, 2)),
                                                  rng.uniform(4, 24, (B, 2))], 1).astype(np.float32),
        C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: rng.randint(0, 256, (B, t, t, 3)).astype(np.uint8),
        C.TARGET_VISIBILITY_KEY: (np.ones((B, 1)) if presence is None else np.asarray(presence)[:, None]
                                  ).astype(np.float32),
    }
    if aux:
        batch[C.TRACKER_TARGET_AUX_IMAGE_KEY] = rng.randint(0, 256, (B, t, t, 3)).astype(np.uint8)
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_params(key, batch, cfg):
    """The parameters ``J.augment_batch(batch, key, cfg)`` draws, in the
    port's layout."""
    B = batch[A.STAGED_SEARCH_KEY].shape[0]
    shapes = [batch[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY].shape[1:3], (cfg.search_size, cfg.search_size)]
    if C.TRACKER_TARGET_AUX_IMAGE_KEY in batch:
        shapes.append(batch[C.TRACKER_TARGET_AUX_IMAGE_KEY].shape[1:3])

    def per_sample(k):
        k_crop, k_color, k_gray, *k_photo = jax.random.split(k, 6)
        ks = jax.random.split(k_crop, 4)
        crop = jnp.stack([jax.random.uniform(ks[0], minval=-cfg.scale, maxval=cfg.scale),
                          jax.random.uniform(ks[1], minval=-cfg.scale, maxval=cfg.scale),
                          jax.random.uniform(ks[2], minval=-cfg.shift, maxval=cfg.shift),
                          jax.random.uniform(ks[3], minval=-cfg.shift, maxval=cfg.shift)])
        k_apply, k_b, k_c, k_g, k_s = jax.random.split(k_color, 5)
        out = {
            "crop": crop,
            "gray": jax.random.bernoulli(k_gray, cfg.p_gray),
            "color": jax.random.bernoulli(k_apply, cfg.p_color),
            "brightness": jax.random.uniform(k_b, minval=-0.2, maxval=0.2) * 255.0,
            "contrast": 1.0 + jax.random.uniform(k_c, minval=-0.2, maxval=0.2),
            "gamma": 1.0 + jax.random.uniform(k_g, minval=-0.2, maxval=0.2),
            "ch_shift": jax.random.uniform(k_s, (3,), minval=-20.0, maxval=20.0),
        }
        photo = []
        for kp, (h, w) in zip(k_photo, shapes):
            k1, k2, k3 = jax.random.split(kp, 3)
            n_apply, n_var, n_n = jax.random.split(k2, 3)
            photo.append({
                "blur": jax.random.bernoulli(k1, cfg.p_blur),
                "noise": jax.random.bernoulli(n_apply, cfg.p_noise),
                "sigma": jnp.sqrt(jax.random.uniform(n_var, minval=10.0, maxval=35.0)),
                "noise_field": jax.random.normal(n_n, (h, w, 3), jnp.float32),
                "downscale": jax.random.bernoulli(k3, cfg.p_downscale),
            })
        out["photometric"] = photo
        return out

    p = jax.vmap(per_sample)(jax.random.split(key, B))
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


@pytest.mark.parametrize("aux", [False, True], ids=["pair", "with_aux"])
@pytest.mark.parametrize("probs", ["configured", "always"])
def test_augment_batch_with_jax_draws_equals_jax(aux, probs):
    kw = dict(CFG_KW)
    if probs == "always":  # every branch taken, so that every op is held
        kw.update(p_color=1.0, p_gray=1.0, p_blur=1.0, p_noise=1.0, p_downscale=1.0)
    cfg_j, cfg_p = J.DeviceAugConfig(**kw), A.DeviceAugConfig(**kw)
    batch = _staged(1 + aux, B=6, aux=aux, presence=[1, 1, 0, 1, 1, 1])
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda b, k: J.augment_batch(b, k, cfg_j))(batch, key)
    got = A.apply_params(_t(batch), _jax_params(key, batch, cfg_j), cfg_p)
    assert set(got) == set(ref)
    for k in (C.TRACKER_TARGET_BBOX_KEY, C.TARGET_REGRESSION_LABEL_KEY, C.TARGET_CLASSIFICATION_KEY,
              C.TARGET_REGRESSION_WEIGHT_KEY):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    images = [C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY, C.TRACKER_TARGET_SEARCH_IMAGE_KEY]
    images += [C.TRACKER_TARGET_AUX_IMAGE_KEY] if aux else []
    mean, std = np.asarray(C.IMAGENET_MEAN) * 255.0, np.asarray(C.IMAGENET_STD) * 255.0
    for k in images:
        np.testing.assert_allclose(got[k].numpy() * std + mean, np.asarray(ref[k]) * std + mean, **PIX, err_msg=k)


def test_affine_grid_equals_jax():
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (5, 40, 56, 3)).astype(np.uint8)
    windows = np.stack([rng.uniform(-10, 30, 5), rng.uniform(-10, 20, 5),
                        rng.uniform(8, 50, 5), rng.uniform(8, 40, 5)], 1).astype(np.float32)
    pad = rng.uniform(0, 255, (5, 3)).astype(np.float32)
    for grid in ("affine", "resize"):
        got = crop_resize_mm(torch.from_numpy(frames), torch.from_numpy(windows), 24, torch.from_numpy(pad),
                             grid=grid).numpy()
        for i in range(5):
            ref = j_crop_resize_mm(jnp.asarray(frames[i]), jnp.asarray(windows[i]), 24, jnp.asarray(pad[i]),
                                   grid=grid)
            np.testing.assert_allclose(got[i], np.asarray(ref), **PIX, err_msg=grid)
    with pytest.raises(ValueError):
        crop_resize_mm(torch.from_numpy(frames), torch.from_numpy(windows), 24, torch.from_numpy(pad), grid="x")


def test_crop_window_and_bbox_transforms_equal_jax():
    cfg_j, cfg_p = J.DeviceAugConfig(**CFG_KW), A.DeviceAugConfig(**CFG_KW)
    rng = np.random.RandomState(5)
    draws = np.concatenate([rng.uniform(-0.2, 0.2, (64, 2)), rng.uniform(-4, 4, (64, 2))], 1).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-10, 60, (64, 2)), rng.uniform(0, 50, (64, 2))], 1).astype(np.float32)
    windows = A.modified_crop(torch.from_numpy(draws), cfg_p, 64)
    got_box = A.handle_empty(A.transform_bbox(torch.from_numpy(boxes), windows, 32), 32)
    for i in range(64):
        # the window's origin from the same draws, by JAX's formula
        s, x = 32.0, 64 / 2 - 16.0
        sx, sy, hx, hy = draws[i]
        ref_w = np.asarray([max(0.0, x - sx * s / 2 + hx), max(0.0, x - sy * s / 2 + hy)], np.float32)
        np.testing.assert_allclose(windows[i, :2].numpy(), ref_w, rtol=1e-6)
        ref_box = J._handle_empty(J._transform_bbox(jnp.asarray(boxes[i]), jnp.asarray(windows[i].numpy()), 32), 32)
        np.testing.assert_array_equal(got_box[i].numpy(), np.asarray(ref_box))
    # JAX's own window from a key, against the port's from the same draws
    key = jax.random.PRNGKey(9)
    ks = jax.random.split(key, 4)
    d = np.asarray([float(jax.random.uniform(ks[0], minval=-0.2, maxval=0.2)),
                    float(jax.random.uniform(ks[1], minval=-0.2, maxval=0.2)),
                    float(jax.random.uniform(ks[2], minval=-4.0, maxval=4.0)),
                    float(jax.random.uniform(ks[3], minval=-4.0, maxval=4.0))], np.float32)
    np.testing.assert_allclose(A.modified_crop(torch.from_numpy(d)[None], cfg_p, 64)[0].numpy(),
                               np.asarray(J._modified_crop(key, cfg_j, 64)), rtol=1e-6)


@pytest.mark.parametrize("op", ["blur", "noise", "downscale", "gray", "color"])
def test_each_photometric_op_equals_jax(op):
    """Each op with p=1 on a float image, with the parameters JAX draws."""
    rng = np.random.RandomState(6)
    imgs = rng.uniform(0, 255, (3, 20, 26, 3)).astype(np.float32)
    on = torch.ones(3, dtype=torch.bool)
    for b in range(3):
        key = jax.random.PRNGKey(b)
        x = jnp.asarray(imgs[b])
        xt = torch.from_numpy(imgs[b:b + 1])
        if op == "blur":
            ref, got = J._gauss_blur(key, x, 1.0), A.gauss_blur(xt, on[:1])
        elif op == "downscale":
            ref, got = J._downscale(key, x, 1.0), A.downscale(xt, on[:1])
        elif op == "gray":
            ref, got = J._to_gray(key, [x], 1.0)[0], A.to_gray([xt], on[:1])[0]
        elif op == "noise":
            _, k_var, k_n = jax.random.split(key, 3)
            sigma = torch.tensor([float(jnp.sqrt(jax.random.uniform(k_var, minval=10.0, maxval=35.0)))])
            field = torch.from_numpy(np.array(jax.random.normal(k_n, x.shape, jnp.float32)))[None]
            ref, got = J._gauss_noise(key, x, 1.0), A.gauss_noise(xt, on[:1], sigma, field)
        else:
            _, k_b, k_c, k_g, k_s = jax.random.split(key, 5)
            p = {"color": on[:1],
                 "brightness": torch.tensor([float(jax.random.uniform(k_b, minval=-0.2, maxval=0.2) * 255.0)]),
                 "contrast": torch.tensor([float(1.0 + jax.random.uniform(k_c, minval=-0.2, maxval=0.2))]),
                 "gamma": torch.tensor([float(1.0 + jax.random.uniform(k_g, minval=-0.2, maxval=0.2))]),
                 "ch_shift": torch.from_numpy(np.array(jax.random.uniform(k_s, (3,), minval=-20.0, maxval=20.0)))[None]}
            ref, got = J._color_jitter(key, [x], 1.0)[0], A.color_jitter([xt], p)[0]
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), **PIX, err_msg=f"{op} {b}")
        # p=0: the image comes back as it went in
    off = torch.zeros(3, dtype=torch.bool)
    x = torch.from_numpy(imgs)
    assert torch.equal(A.gauss_blur(x, off), x) and torch.equal(A.downscale(x, off), x)


def test_draws_have_their_ranges_and_rates():
    """10⁴ samples of the port's own draws: each Bernoulli rate within 3σ of
    its configured probability, each uniform inside its range, the noise
    standard normal."""
    n = 10_000
    cfg = A.DeviceAugConfig(search_size=4, scale=0.2, shift=32.0)
    batch = {A.STAGED_SEARCH_KEY: torch.zeros(n, 8, 8, 3, dtype=torch.uint8),
             C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: torch.zeros(n, 2, 2, 3, dtype=torch.uint8),
             C.TRACKER_TARGET_AUX_IMAGE_KEY: torch.zeros(n, 2, 2, 3, dtype=torch.uint8)}
    p = A.draw_params(batch, cfg, A.aug_generator(0, 5, "cpu"))

    def rate(mask, prob):
        sd = (prob * (1 - prob) / n) ** 0.5
        assert abs(float(mask.float().mean()) - prob) <= 3 * sd, (float(mask.float().mean()), prob)

    rate(p["gray"], cfg.p_gray)
    rate(p["color"], cfg.p_color)
    assert len(p["photometric"]) == 3
    for ph in p["photometric"]:
        rate(ph["blur"], cfg.p_blur)
        rate(ph["noise"], cfg.p_noise)
        rate(ph["downscale"], cfg.p_downscale)
        assert float(ph["sigma"].min()) >= 10 ** 0.5 and float(ph["sigma"].max()) <= 35 ** 0.5
        assert abs(float(ph["noise_field"].mean())) < 0.02 and abs(float(ph["noise_field"].std()) - 1) < 0.02
    crop = p["crop"]
    assert crop[:, :2].abs().max() <= 0.2 and crop[:, 2:].abs().max() <= 32.0
    assert crop[:, :2].abs().max() > 0.19 and crop[:, 2:].abs().max() > 31.0
    for k, lo, hi in (("brightness", -51.0, 51.0), ("contrast", 0.8, 1.2), ("gamma", 0.8, 1.2),
                      ("ch_shift", -20.0, 20.0)):
        assert lo <= float(p[k].min()) and float(p[k].max()) <= hi, k
    # the same (seed, step) draws the same; another step draws another
    again = A.draw_params(batch, cfg, A.aug_generator(0, 5, "cpu"))
    other = A.draw_params(batch, cfg, A.aug_generator(0, 6, "cpu"))
    assert torch.equal(again["crop"], p["crop"]) and not torch.equal(other["crop"], p["crop"])


def test_step_with_device_augs_is_seeded_by_step():
    """A train step with ``device_augs`` draws from (aug_seed, step): two
    states at the same step take the same step."""
    from feartracker_tpu_torch.core import box_coder as bc
    from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
    from feartracker_tpu_torch.models.fear_net import FEARNet
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state, make_train_step

    cfg = A.DeviceAugConfig(search_size=64, scale=0.2, shift=8.0, grid_size=8, total_stride=8)
    spec = bc.BoxCoderSpec(score_size=8, total_stride=8, instance_size=64)
    batch = _t(_staged(7, B=2, s=64, t=32))
    losses = []
    for _ in range(2):
        torch.manual_seed(0)
        tx = build_optimizer({"name": "adam", "lr": 1e-3})
        state = create_train_state(FEARNet(TINY_TRUNK, 16, 1, template_size=32), tx, device="cpu")
        step = make_train_step(tx, spec=spec, device_augs=cfg, aug_seed=3)
        state, m = step(state, dict(batch))
        losses.append(float(m["loss"]))
        assert m["reg_map"].shape == (2, 8, 8, 4)
    assert losses[0] == losses[1]
