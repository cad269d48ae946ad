"""The port's host geometry and crop helpers (``core/geometry_np.py``,
``data/crops.py``, ``ops/resize.py:warp_affine_linear_u8``) against the JAX
package's and cv2's, on the CPU: equal values, dtypes and bytes.

* The eleven helpers of the reference's ``utils/utils.py`` on the cases of
  ``tests/test_geometry*.py`` and on random boxes; ``transform_bbox``
  (cv2.transform in JAX) on diagonal and general maps, forward and back.
* ``warp_affine_linear_u8`` against ``cv2.warpAffine(INTER_LINEAR,
  BORDER_CONSTANT)`` over random frames and boxes: sub-pixel boxes, boxes
  partly or wholly outside the frame, widths on either side of the 16-pixel
  vector step, border colours outside [0, 255]; its fused multiply-add
  rounds once where float64 alone would round twice.
* ``rescale_crop``, ``get_crop_context`` and ``get_subwindow_tracking``
  against JAX's: the same crop bytes, mappings, boxes and crop info, from
  numpy and from a tensor."""

from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from feartracker_tpu.core import geometry as JG
from feartracker_tpu.data import crops as JC
from feartracker_tpu_torch.core import geometry_np as G
from feartracker_tpu_torch.data import crops as C
from feartracker_tpu_torch.ops.resize import _fma_f32, warp_affine_linear_u8

SETTINGS = dict(max_examples=60, deadline=None, derandomize=True, database=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The crops run torch on the CPU: one intra-op thread, as the other
    heavy port files pin it (six test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), (got, want)


# cases of tests/test_geometry.py and tests/test_geometry_extra.py, and more
CASES = [
    ("python2round", (0.5,)), ("python2round", (1.5,)), ("python2round", (2.5,)), ("python2round", (-0.5,)),
    ("python2round", (-2.5,)), ("python2round", (3.2,)), ("python2round", (np.float64(7.5),)),
    ("limit", (0.25,)), ("limit", (4.0,)), ("limit", (np.array([0.5, 2.0, 1.0]),)),
    ("squared_size", (4.0, 4.0)), ("squared_size", (np.array([3.0, 10.0]), np.array([5.0, 1.5]))),
    ("bbox_to_center", ([10, 20, 30, 41],)), ("bbox_to_center", (np.array([1.5, 2.5, 3.0, 4.9]),)),
    ("xywh_to_xyxy", (np.array([[1.0, 2, 3, 4], [5, 6, 7, 8]]),)), ("xywh_to_xyxy", ([0, 0, 10, 10],)),
    ("crop_context_window", ([10, 20, 30, 40], 0.5)), ("crop_context_window", (np.array([-5.5, 3.2, 7.0, 9.0]), 0.2)),
    ("bbox_from_cxy_wh", (np.array([5.0, 5.0]), np.array([20.0, 8.0]))),
    ("bbox_from_cxy_wh", (np.array([50.0, 60.0]), np.array([20.0, 8.0]))),
    ("position_from_bbox", ([10, 20, 30, 40],)), ("position_from_bbox", (np.array([1.5, 2.0, 3.0, 5.0]),)),
    ("get_side_with_context", ([0, 0, 40, 40], 0.5)), ("get_side_with_context", ([3, 4, 17, 5], 0.5)),
    ("get_side_with_context", ([0, 0, 0.2, 0.1], 0.5)),
    ("get_points", ([5, 5, 10, 10],)), ("get_points", (np.array([1.5, -2.0, 3.25, 4.0]),)),
    ("transform_bbox", ([5, 5, 10, 10], np.array([[2.0, 0, 10], [0, 2.0, 20]]))),
    ("transform_bbox", ([20, 30, 20, 20], np.array([[2.0, 0, 10], [0, 2.0, 20]]), True)),
    ("transform_bbox", ([7, 3, 11, 13], np.array([[0.9, 0.2, 3.0], [-0.1, 1.1, -4.0]]))),
]


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_helper_cases_equal_jax(name, args):
    _equal(getattr(G, name)(*args), getattr(JG, name)(*args))


@settings(**SETTINGS)
@given(box=st.tuples(st.floats(-200, 600), st.floats(-200, 600), st.floats(0.5, 400), st.floats(0.5, 400)),
       context=st.floats(0.0, 2.0), x=st.floats(-1e4, 1e4))
def test_helpers_on_random_boxes_equal_jax(box, context, x):
    box = np.array(box)
    for name, args in (("bbox_to_center", (box,)), ("xywh_to_xyxy", (box,)), ("crop_context_window", (box, context)),
                       ("bbox_from_cxy_wh", (box[:2], box[2:])), ("position_from_bbox", (box,)),
                       ("get_side_with_context", (box, context)), ("get_points", (box,)),
                       ("limit", (box[2] / box[3],)), ("squared_size", (box[2], box[3])), ("python2round", (x,))):
        _equal(getattr(G, name)(*args), getattr(JG, name)(*args))


@settings(**SETTINGS)
@given(box=st.tuples(st.floats(-300, 600), st.floats(-300, 600), st.floats(0.1, 500), st.floats(0.1, 500)),
       scale=st.tuples(st.floats(0.01, 20), st.floats(0.01, 20)), shift=st.tuples(st.floats(-2e3, 2e3),
                                                                                   st.floats(-2e3, 2e3)),
       shear=st.tuples(st.floats(-2, 2), st.floats(-2, 2)), diagonal=st.booleans(), inverse=st.booleans())
def test_transform_bbox_equals_cv2_transform(box, scale, shift, shear, diagonal, inverse):
    m = np.array([[scale[0], 0.0 if diagonal else shear[0], shift[0]],
                  [0.0 if diagonal else shear[1], scale[1], shift[1]]])
    _equal(G.transform_bbox(list(box), m, inverse), JG.transform_bbox(list(box), m, inverse))
    pts = G.get_points(list(box))
    _equal(G._transform_points(pts, m), cv2.transform(pts, m))


def _frame(seed, h, w):
    rng = np.random.RandomState(seed)
    # smooth content plus noise, so interpolated values land near .5 often
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0)[..., None] * 90 + np.cos(yy / 5.0)[..., None] * 60 + 128 + rng.randn(h, w, 3) * 20)
    return np.clip(base, 0, 255).astype(np.uint8)


@settings(**SETTINGS)
@given(seed=st.integers(0, 10**6), hw=st.tuples(st.integers(1, 200), st.integers(1, 200)),
       out=st.integers(1, 150), xy=st.tuples(st.floats(-1.0, 1.2), st.floats(-1.0, 1.2)),
       wh=st.tuples(st.floats(0.02, 2.0), st.floats(0.02, 2.0)),
       pad=st.tuples(st.floats(-20, 280), st.floats(-20, 280), st.floats(-20, 280)))
def test_warp_affine_equals_cv2(seed, hw, out, xy, wh, pad):
    h, w = hw
    img = _frame(seed, h, w)
    box = np.array([xy[0] * w, xy[1] * h, wh[0] * w + 0.3, wh[1] * h + 0.3])
    a, b = (out - 1) / box[2], (out - 1) / box[3]
    m = np.array([[a, 0, -a * box[0]], [0, b, -b * box[1]]])
    want = cv2.warpAffine(img, m, (out, out), borderMode=cv2.BORDER_CONSTANT, borderValue=pad)
    got = warp_affine_linear_u8(torch.from_numpy(img), m, (out, out), pad).numpy()
    assert got.shape == want.shape and np.array_equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("out", [15, 16, 17, 31, 32, 33, 64, 127, 128])
def test_warp_affine_around_the_vector_step(out):
    """The last ``out mod 16`` columns take cv2's scalar tail, whose
    x coordinate rounds twice."""
    img = _frame(out, 97, 131)
    for box in ([10.3, 7.7, 90.1, 70.9], [-20.25, 40.5, 160.0, 33.3], [55.5, 50.5, 3.7, 2.9]):
        a, b = (out - 1) / box[2], (out - 1) / box[3]
        m = np.array([[a, 0, -a * box[0]], [0, b, -b * box[1]]])
        want = cv2.warpAffine(img, m, (out, out), borderMode=cv2.BORDER_CONSTANT, borderValue=(9.5, 200.5, 77.2))
        got = warp_affine_linear_u8(torch.from_numpy(img), m, (out, out), (9.5, 200.5, 77.2)).numpy()
        assert np.array_equal(got, want), int((got != want).sum())


def test_warp_affine_refuses_a_rotation():
    with pytest.raises(ValueError, match="rotates or shears"):
        warp_affine_linear_u8(torch.zeros(8, 8, 3, dtype=torch.uint8), [[1, 0.1, 0], [0, 1, 0]], (4, 4))


def test_fma_rounds_once():
    """a·b = 2⁻²⁴(1 − 2⁻⁴⁶) and c = 1 + 2⁻²³: the exact sum lies just below
    the midpoint 1 + 2⁻²³ + 2⁻²⁴, which float64 rounds onto; rounding that
    half to even would give 1 + 2⁻²², the fused result is 1 + 2⁻²³."""
    a = torch.tensor([2.0 ** -12 * (1 + 2.0 ** -23)], dtype=torch.float32)
    b = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -23)], dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).float().item() == 1 + 2.0 ** -22
    assert _fma_f32(a, b, c).item() == 1 + 2.0 ** -23
    rng = np.random.RandomState(0)
    a, b, c = (torch.from_numpy(rng.uniform(-300, 300, 4000).astype(np.float32)) for _ in range(3))
    got = _fma_f32(a, b, c).tolist()
    want = [_round_f32(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a.tolist(), b.tolist(),
                                                                                    c.tolist())]
    assert got == want


def _round_f32(q: Fraction) -> float:
    """A rational rounded once to float32, half to even."""
    lo = float(np.float32(float(q)))
    for cand in (np.nextafter(np.float32(lo), np.float32(-np.inf)), np.float32(lo),
                 np.nextafter(np.float32(lo), np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - q)
        up = abs(Fraction(float(np.nextafter(cand, np.float32(np.inf)))) - q)
        dn = abs(Fraction(float(np.nextafter(cand, np.float32(-np.inf)))) - q)
        if d < up and d < dn or (d == min(up, dn) and int(np.float32(cand).view(np.int32)) % 2 == 0):
            return float(cand)
    raise AssertionError(q)


@settings(**SETTINGS)
@given(seed=st.integers(0, 10**6), hw=st.tuples(st.integers(16, 200), st.integers(16, 200)),
       xy=st.tuples(st.floats(-0.5, 1.1), st.floats(-0.5, 1.1)), wh=st.tuples(st.floats(0.02, 1.0),
                                                                             st.floats(0.02, 1.0)),
       crop=st.sampled_from([64, 127, 128]), context=st.floats(0.1, 1.0), side=st.integers(10, 300))
def test_crops_equal_jax(seed, hw, xy, wh, crop, context, side):
    h, w = hw
    img = _frame(seed, h, w)
    box = np.array([xy[0] * w, xy[1] * h, max(wh[0] * w, 1.0), max(wh[1] * h, 1.0)])
    pad = tuple(np.random.RandomState(seed).uniform(0, 255, 3))
    _equal(C.rescale_crop(img, box, crop, pad), JC.rescale_crop(img, box, crop, pad))
    _equal(C.get_crop_context(img, box, context, 0.25, crop), JC.get_crop_context(img, box, context, 0.25, crop))
    avg = np.mean(img, axis=(0, 1))
    _equal(C.get_subwindow_tracking(img, box, crop, side, avg), JC.get_subwindow_tracking(img, box, crop, side, avg))


@pytest.mark.parametrize("name", ["rescale", "context", "subwindow"])
def test_crops_of_jax_s_tests_and_of_a_tensor(name):
    """The cases of ``tests/test_geometry_extra.py``, from numpy and from a
    tensor (which comes back a tensor on its device)."""
    if name == "rescale":
        img = np.zeros((50, 60, 3), np.uint8)
        img[10:20, 10:30] = 200
        args = (np.array([10, 10, 20, 10]), 40)
        port, jax_ = C.rescale_crop, JC.rescale_crop
    elif name == "context":
        img = np.full((100, 120, 3), 60, np.uint8)
        args = (np.array([40, 40, 20, 20]), 0.5, 0.25, 128)
        port, jax_ = C.get_crop_context, JC.get_crop_context
    else:
        img = np.full((40, 50, 3), 100, np.uint8)
        args = (np.array([0, 0, 10, 10]), 32, 60, np.array([7, 8, 9]))
        port, jax_ = C.get_subwindow_tracking, JC.get_subwindow_tracking
    want = jax_(img, *args)
    _equal(port(img, *args), want)
    got = port(torch.from_numpy(img), *args)
    assert isinstance(got[0], torch.Tensor)
    _equal((got[0].numpy(),) + tuple(got[1:]), want)
