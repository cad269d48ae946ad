"""The host augmentations without cv2, on the CPU, with cv2 as the oracle:
``utils/cv_host.py``'s twins equal cv2 5.0 (the colour maps over all 2**24
inputs, in cv2's vector body and in its scalar tail; the filters on random
images at every kernel size the transforms draw); every ``Transform.apply``
equals the JAX package's class with the same parameters; both pipelines
with each branch forced equal JAX's; and the default training configuration
(host augmentations, ``device_augs: False``) trains over a JPEG tree with
cv2 blocked."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from feartracker_tpu.data import augmentations as J
from feartracker_tpu_torch.data import augmentations as P
from feartracker_tpu_torch.utils import cv_host as H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The items' crops are torch ops: with six workers, an intra-op team per
    call stalls them (a 7.8 s test took 234 s in a six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

COLOUR_MAPS = {
    "rgb2gray": (H.rgb2gray, cv2.COLOR_RGB2GRAY),
    "rgb2hsv": (H.rgb2hsv, cv2.COLOR_RGB2HSV),
    "hsv2rgb": (H.hsv2rgb, cv2.COLOR_HSV2RGB),
    "rgb2hls": (H.rgb2hls, cv2.COLOR_RGB2HLS),
    "hls2rgb": (H.hls2rgb, cv2.COLOR_HLS2RGB),
    "rgb2lab": (H.rgb2lab, cv2.COLOR_RGB2LAB),
    "lab2rgb": (H.lab2rgb, cv2.COLOR_LAB2RGB),
}


def _all_pixels(start, stop):
    """Pixels ``start..stop`` of the 2**24 (c0, c1, c2) triples, flat."""
    a = np.arange(start, stop, dtype=np.uint32)
    return np.stack([a >> 16, (a >> 8) & 255, a & 255], -1).astype(np.uint8)


@pytest.mark.parametrize("name", list(COLOUR_MAPS))
def test_colour_maps_equal_cv2_on_every_input(name):
    """All 2**24 inputs, in rows 4096 wide (cv2's vector body); the two maps
    whose scalar tail rounds differently also in rows 4 wide (all tail), and
    on random rows 37 wide (both)."""
    fn, code = COLOUR_MAPS[name]
    widths = (4096, 4) if name in ("hsv2rgb", "rgb2hls") else (4096,)
    mixed = np.random.RandomState(0).randint(0, 256, (64, 37, 3)).astype(np.uint8)
    assert np.array_equal(fn(mixed), cv2.cvtColor(mixed, code))
    chunk = 1 << 22
    for w in widths:
        for start in range(0, 1 << 24, chunk):
            px = _all_pixels(start, start + chunk)
            n = len(px) // w * w
            img = px[:n].reshape(-1, w, 3)
            got, want = fn(img), cv2.cvtColor(img, code)
            assert got.shape == want.shape and got.dtype == np.uint8
            bad = np.flatnonzero((got != want).reshape(n, -1).any(-1))
            assert bad.size == 0, (w, start, img.reshape(-1, 3)[bad[:4]].tolist())
    g = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(H.gray2rgb(g), cv2.cvtColor(g, cv2.COLOR_GRAY2RGB))


def _images(seed):
    rng = np.random.RandomState(seed)
    # the crops the datasets make (128², 256²) and an odd size
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in ((128, 128), (256, 256), (37, 53))]


@pytest.mark.parametrize("k", [3, 5, 7])
def test_filters_equal_cv2(k):
    rng = np.random.RandomState(k)
    for img in _images(k):
        assert np.array_equal(H.blur(img, k), cv2.blur(img, (k, k)))
        assert np.array_equal(H.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0))
        assert np.array_equal(H.median_blur(img, k), cv2.medianBlur(img, k))
        for _ in range(4):  # MotionBlur's kernel at a drawn angle
            kernel = np.zeros((k, k), np.float32)
            kernel[k // 2, :] = 1.0
            angle = rng.uniform(0, 180)
            m = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0)
            assert np.array_equal(H.rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0), m)
            warped = cv2.warpAffine(kernel, m, (k, k))
            assert H.warp_affine_f32(kernel, m, (k, k)).tobytes() == warped.tobytes()
            warped /= max(warped.sum(), 1e-6)
            assert np.array_equal(H.filter2d(img, warped), cv2.filter2D(img, -1, warped))
        s = rng.uniform(0.2, 0.7)  # Emboss's kernel
        emboss = np.array([[-1 - s, 0 - s, 0], [0 - s, 1, 0 + s], [0, 0 + s, 1 + s]], np.float32)
        assert np.array_equal(H.filter2d(img, emboss), cv2.filter2D(img, -1, emboss))
        dense = rng.uniform(-1, 1, (k, k)).astype(np.float32)
        assert np.array_equal(H.filter2d(img, dense), cv2.filter2D(img, -1, dense))


def test_remap_clahe_equalize_lut_equal_cv2():
    rng = np.random.RandomState(1)
    for img in _images(1):
        h, w = img.shape[:2]
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        # GlassBlur's integer maps, and fractional maps that leave the image
        for mx, my in ((np.clip(xx + rng.randint(-2, 3, (h, w)), 0, w - 1), np.clip(yy + rng.randint(-2, 3, (h, w)), 0, h - 1)),
                       (xx + rng.uniform(-3, 3, (h, w)), yy + rng.uniform(-3, 3, (h, w)))):
            mx, my = mx.astype(np.float32), my.astype(np.float32)
            assert np.array_equal(H.remap_linear(img, mx, my), cv2.remap(img, mx, my, cv2.INTER_LINEAR))
        for ch in (img[..., 0], np.clip(img[..., 1] // 3 + 60, 0, 255).astype(np.uint8)):
            clip = rng.uniform(1.0, 2.0)
            assert np.array_equal(H.clahe(ch, clip), cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(ch))
            assert np.array_equal(H.equalize_hist(ch), cv2.equalizeHist(ch))
        table = rng.randint(0, 256, 256).astype(np.uint8)
        assert np.array_equal(H.lut(img, table), cv2.LUT(img, table))
    flat = np.full((16, 16), 7, np.uint8)
    assert np.array_equal(H.equalize_hist(flat), cv2.equalizeHist(flat))


def test_lines_and_rectangles_equal_cv2():
    rng = np.random.RandomState(2)
    for i in range(150):
        p1, p2 = tuple(int(v) for v in rng.randint(-30, 110, 2)), tuple(int(v) for v in rng.randint(-30, 110, 2))
        a, b = np.zeros((60, 80, 3), np.uint8), np.zeros((60, 80, 3), np.uint8)
        cv2.rectangle(a, p1, p2, (0, 250, 0), 1 + i % 3)
        H.rectangle(b, p1, p2, (0, 250, 0), 1 + i % 3)
        assert np.array_equal(a, b), (p1, p2, 1 + i % 3)
        p1, p2 = tuple(int(v) for v in rng.randint(0, 60, 2)), tuple(int(v) for v in rng.randint(0, 60, 2))
        cv2.line(a, p1, p2, (200, 200, 200), 1)
        H.line(b, p1, p2, (200, 200, 200))
        assert np.array_equal(a, b), (p1, p2)


def test_header_text_equals_cv2_puttext():
    rng = np.random.RandomState(3)
    for i in range(60):
        score = [rng.uniform(0, 10), rng.uniform(0, 1), -rng.uniform(0, 5), rng.uniform(0, 1e5)][i % 4]
        for w in (392, 104):
            a, b = np.zeros((24, w, 3), np.uint8), np.zeros((24, w, 3), np.uint8)
            cv2.putText(a, f"batch score {score:.4f}", (4, 17), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
            H.put_header_text(b, f"batch score {score:.4f}", (4, 17))
            assert np.array_equal(a, b), score
    with pytest.raises(ValueError, match="glyph"):
        H.put_header_text(np.zeros((24, 40, 3), np.uint8), "X", (4, 17))


TRANSFORMS = ["Blur", "MotionBlur", "MedianBlur", "GaussianBlur", "GlassBlur", "GaussNoise", "ImageCompression",
              "ISONoise", "MultiplicativeNoise", "RandomRain", "RandomShadow", "Downscale", "ToGray", "ToSepia",
              "CLAHE", "RandomBrightnessContrast", "Emboss", "RandomGamma", "HueSaturationValue", "RGBShift",
              "Equalize", "ColorJitter", "RandomToneCurve"]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_each_transform_applies_as_jax(name):
    """The same drawn parameters, the same bytes: ``ISONoise`` too, whose
    noise depends on the image's float std (one host, one numpy here)."""
    jt, pt = getattr(J, name)(), getattr(P, name)()
    for seed, img in enumerate(_images(10 + TRANSFORMS.index(name))):
        for draw in range(3):
            params = jt.sample_params(np.random.RandomState(100 * seed + draw), img)
            assert _eq_params(params, pt.sample_params(np.random.RandomState(100 * seed + draw), img))
            want = jt.apply(img.copy(), params)
            got = pt.apply(img.copy(), params)
            assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), (seed, draw)


def _eq_params(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _forced(pipeline, where, member):
    """``pipeline`` with its ``where``-th step forced on, a OneOf to its
    ``member``-th transform."""
    step = pipeline.transforms[where]
    step.p = 1.0
    if hasattr(step, "transforms"):
        step.transforms = [step.transforms[member]]
    return pipeline


def _branches(make):
    out = []
    for i, step in enumerate(make().transforms):
        for j in range(len(getattr(step, "transforms", [None]))):
            out.append((i, j))
    return out


@pytest.mark.parametrize("where,member", _branches(P.photometric_augmentations))
def test_photometric_pipeline_with_each_branch_forced(where, member):
    jp = _forced(J.photometric_augmentations(), where, member)
    pp = _forced(P.photometric_augmentations(), where, member)
    for seed, img in enumerate(_images(20 + where)[:2]):
        want = jp(img.copy(), np.random.RandomState(seed))
        assert np.array_equal(pp(img.copy(), np.random.RandomState(seed)), want)


@pytest.mark.parametrize("where,member", _branches(P.tracking_augmentations))
def test_tracking_pipeline_with_each_branch_forced(where, member):
    jp = _forced(J.tracking_augmentations(), where, member)
    pp = _forced(P.tracking_augmentations(), where, member)
    template, search, _ = _images(30 + member)
    want = jp(template.copy(), search.copy(), np.random.RandomState(member))
    got = pp(template.copy(), search.copy(), np.random.RandomState(member))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_default_training_configuration_trains_over_jpeg_without_cv2(tmp_path):
    """``python -m feartracker_tpu_torch.train`` at the default
    ``device_augs: False`` (host augmentations) over a JPEG tree that the
    port's generator writes, with cv2 blocked in the process: 2 steps and a
    validation through the tracker over the JPEG frames."""
    data, exp = tmp_path / "data", tmp_path / "exp"
    overrides = ["backend=cpu", "model=fear_tiny", "tracker=tiny_tracker", "utility_overrides=local_fast",
                 f"visual_object_tracking_datasets={data}", f"experiment.folder={exp}", "experiment.name=NOCV2",
                 "max_val_samples=2", "sizes.search_image_shift=8", "sizes.search_image_scale=0.2",
                 "sizes.context_range=1", "train.datasets.0.sampling.num_samples=4", "log_every_n_steps=1"]
    code = (
        "import os, runpy, sys\n"
        "sys.modules['cv2'] = None\n"
        "from feartracker_tpu_torch.tools.make_synthetic_dataset import generate\n"
        f"data = {str(data)!r}\n"
        "generate(data + '/got10k', tracks=2, frames=8, val_sequences=1, seed=5, fmt='jpg')\n"
        "os.rename(data + '/got10k/got10k/val', data + '/got10k/val')\n"
        f"sys.argv = ['train'] + {overrides!r}\n"
        "runpy.run_module('feartracker_tpu_torch.train', run_name='__main__', alter_sys=True)\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    from feartracker_tpu_torch.train.summary import read_events, scalars

    assert sorted(os.listdir(data / "got10k" / "val" / "GOT-10k_Val_000000"))[0] == "00000000.jpg"
    losses = scalars(read_events(str(exp / "NOCV2" / "logs")))["train/loss"]
    assert [s for s, _ in losses] == [1, 2] and all(np.isfinite(v) for _, v in losses)
    with open(exp / "NOCV2" / "experiment_config.yaml") as fh:
        assert "device_augs: false" in fh.read().lower()


def test_forced_items_equal_the_committed_digests(tmp_path):
    """``chip_smoke.py`` phase 19d's items, each host transform forced on in
    turn: the port's (no cv2) and the JAX package's (cv2) equal the digests
    committed in ``tests/fixtures/host_items.json``, ISONoise's too: on one
    host its float std is the same."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from feartracker_tpu.data.dataset import SiameseTrackingDataset as JDataset

    from feartracker_tpu_torch.data.dataset import SiameseTrackingDataset

    with open(os.path.join(REPO, *chip_smoke.HOST_ITEMS)) as fh:
        want = json.load(fh)["items"]
    assert len(want) == chip_smoke.HOST_ITEM_COUNT
    assert {w["transform"] for w in want} == set(chip_smoke.PHOTOMETRIC + chip_smoke.TRACKING) == set(TRANSFORMS)
    got = chip_smoke.forced_item_digests(SiameseTrackingDataset, P, str(tmp_path / "port"))
    assert got == want
    assert chip_smoke.forced_item_digests(JDataset, J, str(tmp_path / "jax")) == want
