"""The plain twins of K1 against the JAX decode: the decode alone
(core.postprocess.postprocess) against its XLA form and its Pallas kernel
run in interpret mode, and the batched step's whole decode region
(ops.cuda.decode.decode_step_plain) against JAX's step region. Tolerances as
in tests/test_pallas_decode.py: bbox rtol 1e-5 / atol 1e-4, confidence rtol
1e-5, coordinates exact; the region's own are stated where they are used."""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.core import box_coder as jbc
from feartracker_tpu.core import geometry_jax as jgeo
from feartracker_tpu.core import postprocess as jpp
from feartracker_tpu.ops import crop as jcrop
from feartracker_tpu.ops.pallas.decode import postprocess_pallas
from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.core import postprocess as pp
from feartracker_tpu_torch.core.geometry import clamp_bbox, ensure_bbox_boundaries, rescale_crop_bbox
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops import crop as tcrop
from feartracker_tpu_torch.ops.cuda import build as kbuild
from feartracker_tpu_torch.ops.cuda import decode as k1
from feartracker_tpu_torch.ops.cuda.decode import (
    box_and_confidence,
    decode_step_cuda,
    decode_step_plain,
    postprocess_cuda,
)
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker
from feartracker_tpu_torch.utils.constants import TARGET_CLASSIFICATION_KEY, TARGET_REGRESSION_LABEL_KEY

REPO = Path(__file__).resolve().parents[1]


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


def test_dispatcher_rejects_other_devices_for_the_step_region():
    x = torch.empty(2, 16, 16, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_step_cuda(x, torch.empty(2, 16, 16, 4, device="meta"), pp.PostprocessConfig(),
                         torch.empty(2, 4, device="meta"), torch.empty(2, 4, device="meta"), (64, 64))


# -- the batched step's decode region (K1's whole contract) ---------------------

@functools.cache
def _smoke():
    """``chip_smoke.py``, loaded by path: phase 3 holds K1 to its twin on the
    card on the same inputs as these tests."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


FRAME_HW = (120, 160)


def _region_inputs(seed: int, nan: bool = False):
    """``chip_smoke.py``'s decode-region inputs for 8 streams as float32
    numpy: 0 a tie on the peak; 1 a box whose rescale lands on exactly .5;
    2 and 4 boxes past the left and top edges of the frame; 3 and 5 past the
    right and bottom edges (clamped to zero width / height, then the
    min-side fix-up); 6 an all-NaN map (random unless ``nan``); 7 random."""
    smoke = _smoke()
    assert smoke.K1_FRAME_HW == FRAME_HW
    cls, reg, state, windows = (t.numpy() for t in smoke._k1_region_inputs(8, torch.float32, "cpu", seed))
    if not nan:
        cls[6] = np.random.RandomState(seed).randn(16, 16, 1)
    return cls, reg, state, windows


def _head(cls, reg, dtype):
    """Port-side tensors in the head's dtype, and their exact float32 values."""
    c, r = torch.from_numpy(cls).to(dtype), torch.from_numpy(reg).to(dtype)
    return c, r, c.float().numpy(), r.float().numpy()


def _jax_region(cls, reg, state, windows, smooth, dtype, decode="pallas"):
    """JAX's step region (feartracker_tpu/tracker/runtime.py): the head's
    outputs cast to float32, prev size, decode, rescale, clamp, APCE."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    c = jnp.asarray(cls, jdt).astype(jnp.float32)
    r = jnp.asarray(reg, jdt).astype(jnp.float32)
    prev = jax.vmap(jcrop.crop_bbox_in_window, (0, 0, None))(jnp.asarray(state), jnp.asarray(windows), 256)[:, 2:]
    cfg = jpp.PostprocessConfig(smooth=smooth)
    if decode == "pallas":
        res = postprocess_pallas(c, r, cfg, prev_size=prev, interpret=True)
    else:
        res = jpp.postprocess(c, r, cfg, prev_size=prev)
    bbox = jgeo.clamp_bbox(jgeo.rescale_crop_bbox(res.bbox, jnp.asarray(windows), 256), FRAME_HW)
    return res, bbox, jpp.apce(jax.nn.sigmoid(c)[..., 0])


def _assert_region_close(got, ref, nan=False):
    res, bbox, apce = got
    jres, jbbox, japce = ref
    # crop-space box and confidence: the decode's own tolerances (above)
    np.testing.assert_allclose(res.bbox.numpy(), np.asarray(jres.bbox), rtol=1e-5, atol=1e-4, equal_nan=nan)
    np.testing.assert_allclose(res.confidence.numpy(), np.asarray(jres.confidence), rtol=1e-5, equal_nan=nan)
    np.testing.assert_array_equal(res.pred_coords.numpy(), np.asarray(jres.pred_coords))
    # frame box: integers after rounding, so one ulp at a .5 boundary is a
    # pixel (XLA divides where torch multiplies by a reciprocal)
    np.testing.assert_allclose(bbox.numpy(), np.asarray(jbbox), rtol=0, atol=1.0, equal_nan=nan)
    # APCE: a mean over the map, summed in another order
    np.testing.assert_allclose(apce.numpy(), np.asarray(japce), rtol=1e-5, equal_nan=nan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("smooth", [False, True])
def test_decode_step_plain_matches_jax(smooth, dtype):
    cls, reg, state, windows = _region_inputs(seed=4)
    c, r, c32, r32 = _head(cls, reg, dtype)
    cfg = pp.PostprocessConfig(smooth=smooth)
    got = decode_step_plain(c, r, cfg, torch.from_numpy(state), torch.from_numpy(windows), FRAME_HW)
    _assert_region_close(got, _jax_region(c32, r32, state, windows, smooth, dtype))
    # the cases the inputs are built for are there
    res, bbox, _ = got
    assert res.pred_coords[0].tolist() == [4, 9]
    assert res.bbox[1, 0].item() == 111.5 and windows[1, 2] == 256.0
    rescaled = rescale_crop_bbox(res.bbox, torch.from_numpy(windows), 256)
    assert float(rescaled[1, 0]) == round(float(windows[1, 0]) + 111.5)  # half to even
    H, W = FRAME_HW
    x, y, w, h = rescaled.unbind(-1)
    assert (x < 0).any() and (x + w > W).any() and (y < 0).any() and (y + h > H).any()
    inside = ensure_bbox_boundaries(rescaled, FRAME_HW)
    assert (inside[:, 2] < 3).any() and (inside[:, 3] < 3).any()  # both min-side fix-ups
    assert ((bbox[:, 2] >= 3) & (bbox[:, 3] >= 3)).all()


@pytest.mark.parametrize("smooth", [False, True])
def test_decode_step_all_nan_map_matches_jax(smooth):
    """An all-NaN score map: the port (and K1) take cell 0, as JAX's XLA
    decode does (``jnp.argmax``). JAX's Pallas kernel differs there: its
    first-match ``min(where(pscore == peak))`` finds no cell equal to a NaN
    peak and returns the out-of-range index H·W."""
    cls, reg, state, windows = _region_inputs(seed=5, nan=True)
    c, r, c32, r32 = _head(cls, reg, torch.float32)
    cfg = pp.PostprocessConfig(smooth=smooth)
    got = decode_step_plain(c, r, cfg, torch.from_numpy(state), torch.from_numpy(windows), FRAME_HW)
    _assert_region_close(got, _jax_region(c32, r32, state, windows, smooth, torch.float32, "xla"), nan=True)
    assert got.result.pred_coords[6].tolist() == [0, 0]
    assert np.isnan(got.result.confidence[6].item()) and np.isnan(got.apce[6].item())


def test_decode_step_cuda_runs_the_plain_twin_on_cpu():
    cls, reg, state, windows = _region_inputs(seed=6)
    args = (torch.from_numpy(cls).to(torch.bfloat16), torch.from_numpy(reg).to(torch.bfloat16),
            pp.PostprocessConfig(smooth=True), torch.from_numpy(state), torch.from_numpy(windows), FRAME_HW)
    before = postprocess_cuda.launches
    got, ref = decode_step_cuda(*args), decode_step_plain(*args)
    assert postprocess_cuda.launches == before  # no kernel on the CPU
    for a, b in zip([*got.result, got.bbox, got.apce], [*ref.result, ref.bbox, ref.apce]):
        assert torch.equal(a, b)


def test_postprocess_cuda_writes_box_and_confidence_in_one_buffer():
    logits, reg, prev = _inputs(S=1, seed=7)
    res = postprocess_cuda(torch.from_numpy(logits), torch.from_numpy(reg), pp.PostprocessConfig(smooth=True),
                           prev_size=torch.from_numpy(prev))
    both = box_and_confidence(res)
    assert both.shape == (5,) and torch.equal(both, torch.cat([res.bbox[0], res.confidence]))
    with pytest.raises(ValueError, match="one buffer"):
        box_and_confidence(pp.PostprocessResult(res.bbox.clone(), res.confidence.clone(), res.pred_coords))


class _FakeLibrary:
    """Stands in for the built library: takes ``fear_decode``'s arguments
    through their ctypes types, as a call would, and records them."""

    def __init__(self):
        self.calls = []

    def fear_decode(self, *args):
        types = kbuild.SIGNATURES["fear_decode"]
        assert len(args) == len(types)
        self.calls.append([t(a).value for t, a in zip(types, args)])
        return 0


@pytest.mark.parametrize("mode", ["step", "postprocess"])
def test_wrappers_pass_the_c_signature(monkeypatch, mode):
    """What the CPU can check of a launch: the argument list matches the C
    signature, and the results view the buffers the kernel is told to write."""
    fake = _FakeLibrary()
    monkeypatch.setattr(k1, "load_library", lambda: fake)
    monkeypatch.setattr(k1.torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    monkeypatch.setattr(k1.torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 7})())
    S = 3
    cls = torch.zeros(S, 16, 16, 1, dtype=torch.bfloat16).permute(0, 2, 1, 3)  # strided
    reg = torch.zeros(S, 16, 16, 4, dtype=torch.bfloat16)
    cfg = pp.PostprocessConfig(smooth=True)
    if mode == "step":
        state, windows = torch.zeros(S, 4), torch.ones(S, 4)
        out, coords = k1._launch(cls[..., 0], reg, cfg, torch.device("cpu"), state=state, windows=windows,
                                 frame_hw=(120, 160))
        frame, bbox, conf, apce = out[:4 * S], out[4 * S:8 * S], out[8 * S:9 * S], out[9 * S:]
    else:
        prev = torch.ones(S, 2)
        out, coords = k1._launch(cls[..., 0], reg, cfg, torch.device("cpu"), prev=prev)
        bbox, conf = out[:4 * S], out[4 * S:]
    (a,) = fake.calls
    assert a[2] == 1 and a[3:6] == list(cls[..., 0].stride()) and a[6:10] == list(reg.stride())
    assert a[16] == bbox.data_ptr() and a[17] == conf.data_ptr() and a[18] == coords.data_ptr()
    if mode == "step":
        assert a[10] is None and a[11] == state.data_ptr() and a[12] == windows.data_ptr()
        assert a[19] == frame.data_ptr() and a[20] == apce.data_ptr()
        assert a[30:32] == [120.0, 160.0] and out.shape == (10 * S,)
    else:
        assert a[10] == prev.data_ptr() and a[11] is None and a[12] is None and a[19] is None and a[20] is None
    assert a[21:25] == [S, 16, 16, 1] and a[33] == 7 and len(a) == 34
    np.testing.assert_allclose(a[25:30] + a[32:33], [0.062, 0.62, 0.38, 0.765, 256.0, 3.0], rtol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_tracker_step_equals_the_region_as_it_was(dtype):
    """``ScanTracker.step`` on the CPU, field by field, against the step as
    it ran before K1 took the decode region: the head's outputs cast and made
    contiguous, prev size, postprocess, rescale, clamp, APCE, as separate ops."""
    torch.manual_seed(0)
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32).eval()
    cfg = TrackerConfig(template_size=32, instance_size=64, score_size=8, total_stride=8, smooth=True)
    tr = ScanTracker(model, cfg, dtype=dtype, device="cpu")
    rng = np.random.RandomState(8)
    frames = rng.randint(0, 255, (3, 2, 96, 128, 3), np.uint8)
    boxes = np.array([[40.0, 30, 30, 24], [2, 60, 24, 30]], np.float32)
    state = tr.init(frames[0], boxes)
    for f in frames[1:]:
        f = torch.from_numpy(f)
        with torch.inference_mode():
            windows = tcrop.extended_crop_window(state.bbox, cfg.search_context)
            crops = tr._crop(f, windows, cfg.instance_size, state.mean_color)
            # the tracker's crop route returns the normalized crop (K3's twin on the CPU)
            out = tr.model.connector(state.template_feats, tr._features(crops), None)
            cls = out[TARGET_CLASSIFICATION_KEY].float().contiguous()
            reg = out[TARGET_REGRESSION_LABEL_KEY].float().contiguous()
            prev = tcrop.crop_bbox_in_window(state.bbox, windows, cfg.instance_size)[:, 2:].contiguous()
            res = pp.postprocess(cls, reg, cfg.postprocess, prev_size=prev)
            want = {"bbox": clamp_bbox(rescale_crop_bbox(res.bbox, windows, cfg.instance_size), (96, 128)),
                    "confidence": res.confidence, "apce": pp.apce(torch.sigmoid(cls[..., 0])),
                    "failure": res.confidence < cfg.confidence_threshold}
        state, got = tr.step(state, f)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(state.bbox, want["bbox"]) and torch.equal(state.confidence, want["confidence"])


def test_k1_timing_refuses_without_cuda():
    proc = subprocess.run([sys.executable, "k1_timing.py"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
