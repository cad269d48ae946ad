"""The port's integer-exact cv2 twins against live cv2, and the host crop and
geometry against the JAX package's: byte for byte, no tolerance.

``resize_linear_u8`` is held to ``cv2.resize(INTER_LINEAR)`` on 1,200 seeded
shape pairs (1-pixel sources, 128² and 256² outputs, sources up to 1100
wide, exact 2× downscales); the pad colour to cv2's rounding of a float
border value; ``get_extended_crop`` to ``feartracker_tpu.data.crops``
(crop bytes, crop-space box, window), windows leaving the frame on every
side included."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from feartracker_tpu.core import geometry as jgeom  # noqa: E402
from feartracker_tpu.data.crops import get_extended_crop as jax_crop  # noqa: E402
from feartracker_tpu.evaluate.batched_eval import letterbox as jax_letterbox  # noqa: E402
from feartracker_tpu_torch.core import geometry_np  # noqa: E402
from feartracker_tpu_torch.data.crops import get_extended_crop  # noqa: E402
from feartracker_tpu_torch.evaluate.batched_eval import letterbox  # noqa: E402
from feartracker_tpu_torch.ops.resize import (  # noqa: E402
    mean_color,
    pad_color_u8,
    pad_constant_u8,
    resize_linear_u8,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _side(rng):
    return int(rng.choice([1, 2, 3, rng.randint(1, 40), rng.randint(1, 400), rng.randint(100, 1100)]))


def _pairs(seed, n=100):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = (_side(rng), _side(rng))
        dst = tuple(int(rng.choice([128, 256, rng.randint(1, 300)])) for _ in range(2))
        out.append((src, dst))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_resize_matches_cv2(seed):
    """100 seeded (source, output) shape pairs per case, 1,200 in all."""
    rng = np.random.RandomState(100 + seed)
    for (sh, sw), (dh, dw) in _pairs(seed):
        img = rng.randint(0, 256, (sh, sw, 3), dtype=np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        got = resize_linear_u8(torch.from_numpy(img), (dw, dh)).numpy()
        assert np.array_equal(got, want), ((sh, sw), (dh, dw))


@pytest.mark.parametrize("src,dst", [
    ((1, 1), (256, 256)), ((1, 700), (128, 128)), ((512, 512), (256, 256)),
    ((256, 256), (128, 128)), ((256, 256), (256, 256)), ((870, 225), (256, 256)),
    ((64, 64), (128, 128)), ((3, 1100), (256, 256)),
], ids=lambda v: "x".join(map(str, v)))
def test_resize_named_shapes_match_cv2(src, dst):
    """Same-size copy, exact 2× (cv2 takes its area path), 1-pixel and
    the tracker's own search-window shapes."""
    img = np.random.RandomState(sum(src)).randint(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(resize_linear_u8(torch.from_numpy(img), dst[::-1]).numpy(), want)


@pytest.mark.parametrize("value", [2.5, 3.5, 127.5, 254.6, 254.5, 300.0, -3.0, 0.49])
def test_pad_colour_rounds_as_cv2(value):
    img = np.zeros((2, 2, 3), np.uint8)
    want = cv2.copyMakeBorder(img, 1, 0, 0, 0, cv2.BORDER_CONSTANT, value=(value,) * 3)[0, 0]
    assert pad_color_u8(np.full(3, value), "cpu").tolist() == want.tolist()
    assert pad_color_u8(torch.full((3,), value, dtype=torch.float64), "cpu").tolist() == want.tolist()


def test_pad_constant_matches_copy_make_border():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (17, 23, 3), dtype=np.uint8)
    colour = img.mean(axis=(0, 1))
    want = cv2.copyMakeBorder(img, 3, 5, 0, 7, cv2.BORDER_CONSTANT, value=tuple(colour))
    got = pad_constant_u8(torch.from_numpy(img), 3, 5, 0, 7, pad_color_u8(colour, "cpu"))
    assert np.array_equal(got.numpy(), want)


def test_mean_color_equals_numpy():
    img = np.random.RandomState(1).randint(0, 256, (97, 131, 3), dtype=np.uint8)
    np.testing.assert_array_equal(mean_color(torch.from_numpy(img)).numpy(), np.mean(img, axis=(0, 1)))


# boxes in a 240×320 frame: inside, and windows leaving it on each side
CROP_BOXES = [
    (120.0, 90.0, 40.0, 30.0), (2.0, 100.0, 30.0, 40.0), (290.0, 100.0, 28.0, 40.0),
    (150.0, 1.0, 30.0, 25.0), (150.0, 215.0, 30.0, 24.0), (0.0, 0.0, 60.0, 50.0),
    (300.0, 220.0, 19.0, 19.0), (100.5, 80.25, 33.7, 21.9), (10.0, 10.0, 300.0, 220.0),
]


@pytest.mark.parametrize("box", CROP_BOXES)
@pytest.mark.parametrize("crop_size,offset,pad", [(128, 0.2, None), (256, 2.0, "mean"), (256, 3.0, "mean")],
                         ids=["template", "search", "recover"])
def test_extended_crop_matches_jax(box, crop_size, offset, pad):
    img = np.random.RandomState(7).randint(0, 256, (240, 320, 3), dtype=np.uint8)
    bbox = np.asarray(box)
    pad_value = np.mean(img, axis=(0, 1)) * 0.8 if pad else None
    want = jax_crop(img, bbox, crop_size, offset, padding_value=pad_value)
    got = get_extended_crop(img, bbox, crop_size, offset, padding_value=pad_value)
    assert np.array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == want[2].dtype


@pytest.mark.parametrize("hw", [(120, 168), (360, 640), (64, 64)])
def test_letterbox_matches_jax(hw):
    frame = np.random.RandomState(2).randint(0, 256, (160, 224, 3), dtype=np.uint8)
    want, wscale, wplaced = jax_letterbox(frame, hw)
    got, scale, placed = letterbox(frame, hw)
    assert np.array_equal(got.numpy(), want) and scale == wscale and placed == wplaced


@pytest.mark.parametrize("box,offset", [((10.3, 20.7, 33.1, 47.9), 0.2), ((-5.0, 3.0, 40.0, 12.0), 2.0),
                                        ((100.0, 50.0, 45.0, 174.0), 3.0), ((1.0, 1.0, 7.0, 9.0), 0.1)])
def test_geometry_matches_jax(box, offset):
    shape = (256, 480, 3)
    np.testing.assert_array_equal(geometry_np.extend_bbox(box, offset), jgeom.extend_bbox(box, offset))
    for b in (box, (470.0, 250.0, 2.0, 1.0), (-3.0, -4.0, 10.0, 10.0)):
        np.testing.assert_array_equal(geometry_np.ensure_bbox_boundaries(b, shape[:2]),
                                      jgeom.ensure_bbox_boundaries(b, shape[:2]))
        np.testing.assert_array_equal(geometry_np.clamp_bbox(b, shape), jgeom.clamp_bbox(b, shape))
    window = geometry_np.extend_bbox(box, offset)
    crop_box = np.array([box[0] * 1.7, box[1] * 0.3, box[2] * 2.5, box[3] * 0.5], np.float32)
    assert geometry_np.rescale_crop_bbox(crop_box, window, 256) == jgeom.rescale_crop_bbox(crop_box, window, 256)
    rng = np.random.RandomState(0)
    a, b = rng.rand(20, 4) * 50, rng.rand(20, 4) * 50
    np.testing.assert_array_equal(geometry_np.overlap_xywh_np(a, b), jgeom.overlap_xywh_np(a, b))
