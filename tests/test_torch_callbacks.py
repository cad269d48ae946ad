"""The port's training callbacks against the JAX package's on the same
inputs: ``EarlyStopping``'s decisions on seeded metric sequences in both
modes, ``BestWorstMiner``'s best and worst scores (NaN scores and NaN boxes
skipped) and mosaics, and ``batch_mosaic``'s bytes, also with cv2 blocked
in the port's process. Exact: the port draws with ``utils/cv_host.py``'s
twins of cv2, JAX with cv2."""

import os
import subprocess
import sys

import numpy as np
import pytest

from feartracker_tpu.train import callbacks as J
from feartracker_tpu_torch.train import callbacks as P
from feartracker_tpu_torch.utils import constants as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("patience", [1, 3])
def test_early_stopping_decides_as_jax(mode, seed, patience):
    rng = np.random.RandomState(seed)
    # a rising (falling) trend with noise and repeats, so plateaus happen
    metrics = np.round(np.cumsum(rng.randn(40) * 0.1 + (0.02 if mode == "max" else -0.02)), 2)
    j, p = J.EarlyStopping(patience, mode), P.EarlyStopping(patience, mode)
    jd = [j.update(float(m)) for m in metrics]
    pd = [p.update(float(m)) for m in metrics]
    assert jd == pd and any(pd)
    assert (j.best, j.bad_epochs) == (p.best, p.bad_epochs)


def _batch(seed, B=4, size=64, template=32):
    rng = np.random.RandomState(seed)
    batch = {
        C.TRACKER_TARGET_SEARCH_IMAGE_KEY: rng.randn(B, size, size, 3).astype(np.float32),
        C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: rng.randn(B, template, template, 3).astype(np.float32),
        C.TRACKER_TARGET_BBOX_KEY: np.concatenate([rng.uniform(0, 30, (B, 2)), rng.uniform(5, 30, (B, 2))],
                                                  1).astype(np.float32),
        C.TARGET_VISIBILITY_KEY: (rng.rand(B, 1) > 0.3).astype(np.float32),
    }
    outputs = {
        C.TARGET_CLASSIFICATION_KEY: rng.randn(B, 8, 8, 1).astype(np.float32),
        C.TARGET_REGRESSION_LABEL_KEY: rng.uniform(0, 40, (B, 8, 8, 4)).astype(np.float32),
    }
    return batch, outputs


@pytest.mark.parametrize("kw", [{}, {"max_images": 2, "score_size": 8, "stride": 8, "instance_size": 64}],
                         ids=["defaults", "tiny"])
def test_batch_mosaic_bytes_equal_jax(kw):
    pytest.importorskip("cv2")
    batch, outputs = _batch(0)
    got = P.batch_mosaic(batch, outputs, 0.123, **kw)
    want = J.batch_mosaic(batch, outputs, 0.123, **kw)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("score", [float("inf"), float("-inf"), float("nan")], ids=["inf", "-inf", "nan"])
def test_batch_mosaic_non_finite_score_equals_jax(score):
    """A direct call with a score the callback would filter out: the header
    prints ``inf``, ``-inf`` or ``nan`` (glyphs i, n, f, a), as JAX's does."""
    pytest.importorskip("cv2")
    batch, outputs = _batch(5)
    got = P.batch_mosaic(batch, outputs, score)
    want = J.batch_mosaic(batch, outputs, score)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", ["min", "max"])
def test_best_worst_miner_matches_jax(mode):
    pytest.importorskip("cv2")
    rng = np.random.RandomState(3)
    j, p = J.BestWorstMiner(mode, max_images=3), P.BestWorstMiner(mode, max_images=3)
    scores = rng.rand(12)
    scores[[2, 7]] = np.nan
    for i, s in enumerate(scores):
        batch, outputs = _batch(10 + i)
        if i == 5:  # a finite score with a NaN box: skipped too
            outputs[C.TARGET_REGRESSION_LABEL_KEY][0, 0, 0, 0] = np.nan
            s = -1.0 if mode == "min" else 2.0
        j.update(float(s), batch, outputs)
        p.update(float(s), batch, outputs)
    finite = [s for i, s in enumerate(scores) if np.isfinite(s) and i != 5]
    assert p.best_score == j.best_score == (min(finite) if mode == "min" else max(finite))
    assert p.worst_score == j.worst_score == (max(finite) if mode == "min" else min(finite))
    assert p.best_mosaic.tobytes() == j.best_mosaic.tobytes()
    assert p.worst_mosaic.tobytes() == j.worst_mosaic.tobytes()
    p.reset()
    assert p.best_score is None and p.worst_mosaic is None


def test_batch_mosaic_without_cv2_equals_jax(tmp_path):
    """cv2 blocked in the port's process: the mosaics (rectangles, border,
    header text) equal JAX's, drawn with cv2 here, byte for byte."""
    pytest.importorskip("cv2")
    cases = [(0, 0.123, {}), (1, -12.5, {}),
             (2, 4321.0625, {"max_images": 2, "score_size": 8, "stride": 8, "instance_size": 64})]
    inputs = {}
    for i, (seed, _, _) in enumerate(cases):
        batch, outputs = _batch(seed)
        inputs.update({f"{i}/b/{k}": v for k, v in batch.items()})
        inputs.update({f"{i}/o/{k}": v for k, v in outputs.items()})
    np.savez(tmp_path / "inputs.npz", **inputs)
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from feartracker_tpu_torch.train import callbacks as P\n"
        f"cases, d = {cases!r}, {str(tmp_path)!r}\n"
        "z = np.load(d + '/inputs.npz')\n"
        "got = {}\n"
        "for i, (_, score, kw) in enumerate(cases):\n"
        "    part = lambda t: {k.split('/', 2)[2]: z[k] for k in z.files if k.startswith(f'{i}/{t}/')}\n"
        "    got[str(i)] = P.batch_mosaic(part('b'), part('o'), score, **kw)\n"
        "np.savez(d + '/mosaics.npz', **got)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(tmp_path / "mosaics.npz")
    for i, (seed, score, kw) in enumerate(cases):
        batch, outputs = _batch(seed)
        want = J.batch_mosaic(batch, outputs, score, **kw)
        assert got[str(i)].shape == want.shape and got[str(i)].tobytes() == want.tobytes(), i
