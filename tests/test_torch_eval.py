"""The port's evaluation protocols against the JAX package's on the CPU.

* Protocol arithmetic on seeded inputs (``summarize``, ``precision_stats``,
  ``ope_metrics``, ``eao_from_segments``, ``supervised_run`` and
  ``evaluate_vot`` with a scripted tracker): equal within 1e-12.
* Each registry dataset parses one temp layout to the same frames,
  annotations and names; the submission writers write the same files.
* The quality-gate mini suite (``tools.make_synthetic_dataset.generate``,
  seed 3, 3×12 drift frames, as ``tests/test_quality_gate.py``) with
  full-width FEAR-XS in float32 on both sides: sequential AO ≥ 0.78 and
  within 0.005 of JAX's, letterboxed batched AO (canvas 120×168) likewise,
  and the VOT supervised protocol with the same failure count and accuracy
  within 0.005. The port scores with the float64 numpy IoU where the JAX
  OPE scorer uses a float32 one, hence the AO tolerance.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.make_synthetic_dataset import generate  # noqa: E402

from feartracker_tpu.convert.load import PACKAGED_FEAR_XS as J_WEIGHTS  # noqa: E402
from feartracker_tpu.convert.load import load_variables  # noqa: E402
from feartracker_tpu.data import sequence as jseq  # noqa: E402
from feartracker_tpu.evaluate import batched_eval as jbatched  # noqa: E402
from feartracker_tpu.evaluate import got10k_eval as jgot  # noqa: E402
from feartracker_tpu.evaluate import vot_eval as jvot  # noqa: E402
from feartracker_tpu.models.fear_net import FEARNet as JFEARNet  # noqa: E402
from feartracker_tpu.tracker.runtime import ScanTracker as JScanTracker  # noqa: E402
from feartracker_tpu.tracker.tracker import FEARTracker as JFEARTracker  # noqa: E402
from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net, variables_from_npz  # noqa: E402
from feartracker_tpu_torch.data import sequence as seq  # noqa: E402
from feartracker_tpu_torch.evaluate import batched_eval, got10k_eval, vot_eval  # noqa: E402
from feartracker_tpu_torch.models.fear_net import build_family_model  # noqa: E402
from feartracker_tpu_torch.tracker.runtime import ScanTracker  # noqa: E402
from feartracker_tpu_torch.tracker.tracker import FEARTracker  # noqa: E402

SEED, FRAMES, SEQS = 3, 12, 3
SMALL_CANVAS = (120, 168)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores, and an
    OpenMP team per small op then waits on descheduled threads (10× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trajectories(seed, n_seq=4):
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_seq):
        n = rng.randint(5, 40)
        gt = np.concatenate([rng.rand(n, 2) * 200, rng.rand(n, 2) * 60 + 5], axis=1)
        preds.append(gt + rng.randn(n, 4) * rng.choice([1.0, 8.0, 30.0]))
        gts.append(gt)
    return preds, gts


def _close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_protocol_arithmetic_matches_jax(seed):
    preds, gts = _trajectories(seed)
    for p, g in zip(preds, gts):
        _close(got10k_eval.precision_stats(p, g), jgot.precision_stats(p, g))
    _close(got10k_eval.ope_metrics(preds, gts), jgot.ope_metrics(preds, gts))
    ovs = [got10k_eval._overlap(p, g) for p, g in zip(preds, gts)]
    names = [f"s{i}" for i in range(len(ovs))]
    precs = [got10k_eval.precision_stats(p, g) for p, g in zip(preds, gts)]
    _close(got10k_eval.summarize(ovs, names, precs), jgot.summarize(ovs, names, precs))
    rng = np.random.RandomState(seed)
    segments = [rng.rand(rng.randint(1, 60)) for _ in range(rng.randint(1, 12))]
    for interval in (None, (3, 20)):
        _close(vot_eval.eao_from_segments(segments, interval), jvot.eao_from_segments(segments, interval))


class ScriptedTracker:
    """Replays a fixed box per frame index; re-init snaps to the given box."""

    def __init__(self, script):
        self.script, self.frame = script, 0

    def initialize(self, image, bbox):
        pass

    def update(self, image):
        self.frame += 1
        return {"bbox": np.asarray(self.script.get(self.frame, self.script[-1]), np.float64)}


class OneSeq:
    def __init__(self, files, anno):
        self.files, self.anno = files, anno

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.files, self.anno, "synthetic"

    def sequence_name(self, i):
        return "seq0"


@pytest.mark.parametrize("skip,burnin", [(5, 10), (2, 0), (1, 3)])
def test_supervised_protocol_matches_jax(tmp_path, skip, burnin):
    n = 30
    files = []
    for i in range(n):
        files.append(str(tmp_path / f"{i:03d}.png"))
        cv2.imwrite(files[-1], np.zeros((8, 8, 3), np.uint8))
    rng = np.random.RandomState(skip)
    anno = np.concatenate([rng.rand(n, 2) * 20 + 10, np.full((n, 2), 10.0)], axis=1)
    script = {i: anno[i] + rng.randn(4) * 3 for i in range(n)}
    for i in (4, 13, 21):
        script[i] = anno[i] + [200, 200, 0, 0]  # no overlap: a failure
    script[-1] = anno[-1]
    for a, b in zip(vot_eval.supervised_run(ScriptedTracker(script), files, anno, skip=skip),
                    jvot.supervised_run(ScriptedTracker(script), files, anno, skip=skip)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _close(vot_eval.evaluate_vot(ScriptedTracker(script), OneSeq(files, anno), skip=skip, burnin=burnin),
           jvot.evaluate_vot(ScriptedTracker(script), OneSeq(files, anno), skip=skip, burnin=burnin))


def _jpg(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))


def _write(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(rows))


def _layout(root, name):
    """A two-sequence temp layout of one registry dataset; returns the
    constructor kwargs."""
    r = str(root)
    box = ["10,20,30,40", "11,21,31,41", "12,22,32,42"]
    if name == "got10k":
        for s in ("GOT-10k_Val_000002", "GOT-10k_Val_000001"):
            for i in range(3):
                _jpg(f"{r}/val/{s}/{i:08d}.jpg")
            _write(f"{r}/val/{s}/groundtruth.txt", box)
        _write(f"{r}/val/list.txt", ["GOT-10k_Val_000002", "GOT-10k_Val_000001"])
        return {"subset": "val"}
    if name == "lasot":
        for s in ("cat/cat-1", "dog/dog-3"):
            for i in range(3):
                _jpg(f"{r}/{s}/img/{i:08d}.jpg")
            _write(f"{r}/{s}/groundtruth.txt", box)
        return {}
    if name == "nfs":
        for s in ("ball", "car"):
            for i in range(3):
                _jpg(f"{r}/{s}/30/{s}/{i:05d}.jpg")
            _write(f"{r}/{s}/30/{s}.txt", [f"{i} 5 6 25 36 0 0" for i in range(3)])
        return {}
    if name == "otb":
        for i in range(4):
            _jpg(f"{r}/David/img/{i:04d}.jpg")
            _jpg(f"{r}/Jogging/img/{i:04d}.jpg")
        _write(f"{r}/David/groundtruth_rect.txt", box)
        _write(f"{r}/Jogging/groundtruth_rect.1.txt", ["1\t2\t3\t4"] * 4)
        _write(f"{r}/Jogging/groundtruth_rect.2.txt", ["5,6,7,8"] * 5)
        return {}
    if name == "vot":
        for i in range(3):
            _jpg(f"{r}/ants/color/{i:08d}.jpg")
            _jpg(f"{r}/bag/{i:08d}.jpg")
        _write(f"{r}/ants/groundtruth.txt", ["1,2,9,2,9,8,1,8"] * 3)
        _write(f"{r}/bag/groundtruth.txt", box)
        return {}
    if name == "trackingnet":
        for chunk in ("TRAIN_0", "TRAIN_1"):
            for i in (0, 2, 10):
                _jpg(f"{r}/{chunk}/frames/seq_{chunk}/{i}.jpg")
            _write(f"{r}/{chunk}/anno/seq_{chunk}.txt", box)
        return {"subset": "train"}
    raise KeyError(name)


@pytest.mark.parametrize("name", sorted(jseq.DATASET_REGISTRY))
def test_registry_datasets_parse_like_jax(tmp_path, name):
    kwargs = _layout(tmp_path, name)
    ours, theirs = seq.DATASET_REGISTRY[name](str(tmp_path), **kwargs), jseq.DATASET_REGISTRY[name](str(tmp_path), **kwargs)
    assert len(ours) == len(theirs) >= 1
    for i in range(len(ours)):
        (f, a, n), (jf, ja, jn) = ours[i], theirs[i]
        assert f == jf and n == jn and ours.sequence_name(i) == theirs.sequence_name(i)
        np.testing.assert_array_equal(a, ja)


def test_get_sequence_datasets_matches_jax(tmp_path):
    _layout(tmp_path / "g", "got10k")
    cfg = [{"name": "got10k", "root_dir": str(tmp_path / "g"), "subset": "val"},
           {"name": "lasot", "root_dir": str(tmp_path / "missing")}]
    ours, theirs = seq.get_sequence_datasets(cfg), jseq.get_sequence_datasets(cfg)
    assert [type(d).__name__ for d in ours] == [type(d).__name__ for d in theirs] == ["GOT10kDataset"]


@pytest.mark.parametrize("writer", ["write_got10k_submission", "write_trackingnet_submission"])
def test_submission_writers_match_jax(tmp_path, writer):
    _layout(tmp_path / "data", "got10k")
    ds, jds = seq.GOT10kDataset(str(tmp_path / "data")), jseq.GOT10kDataset(str(tmp_path / "data"))
    script = {1: [1.5, 2.25, 30.0, 40.125], 2: [3.0, 4.0, 5.0, 6.0], -1: [0.0, 0.0, 1.0, 1.0]}
    getattr(got10k_eval, writer)(ScriptedTracker(dict(script)), ds, str(tmp_path / "ours"))
    getattr(jgot, writer)(ScriptedTracker(dict(script)), jds, str(tmp_path / "jax"))
    walk = {}
    for side in ("ours", "jax"):
        base = tmp_path / side
        walk[side] = sorted(str(p.relative_to(base)) for p in base.rglob("*.txt"))
    assert walk["ours"] == walk["jax"] and walk["ours"]
    for rel in walk["ours"]:
        if rel.endswith("_time.txt"):  # wall times: only the row count is comparable
            assert len((tmp_path / "ours" / rel).read_text().splitlines()) == \
                len((tmp_path / "jax" / rel).read_text().splitlines())
        else:
            assert (tmp_path / "ours" / rel).read_text() == (tmp_path / "jax" / rel).read_text()


# -- the quality-gate mini suite, full-width FEAR-XS, float32 --------------


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("quality_gate"))
    generate(root, tracks=1, frames=FRAMES, val_sequences=SEQS, seed=SEED,
             scenario="drift", appearance_drift=0.5)
    path = os.path.join(root, "got10k")
    return seq.GOT10kDataset(path, subset="val"), jseq.GOT10kDataset(path, subset="val")


@pytest.fixture(scope="module")
def models():
    jmodel = JFEARNet()
    port = load_fear_net(build_family_model("fear_xs"), variables_from_npz(PACKAGED_FEAR_XS))
    return jmodel, load_variables(J_WEIGHTS), port


def test_sequential_ao_matches_jax(suite, models):
    ds, jds = suite
    jmodel, v, port = models
    res = got10k_eval.evaluate_tracker(FEARTracker(port, device="cpu"), ds)
    jres = jgot.evaluate_tracker(JFEARTracker(jmodel, v), jds)
    assert res["num_sequences"] == jres["num_sequences"] == SEQS
    assert res["ao"] >= 0.78, res["ao"]
    assert abs(res["ao"] - jres["ao"]) <= 0.005, (res["ao"], jres["ao"])


def test_batched_letterboxed_ao_matches_jax(suite, models):
    ds, jds = suite
    jmodel, v, port = models
    res = batched_eval.batched_evaluate(ScanTracker(port, device="cpu"), ds, streams=SEQS, frame_hw=SMALL_CANVAS)
    jres = jbatched.batched_evaluate(JScanTracker(jmodel, v, dtype=jnp.float32), jds,
                                     streams=SEQS, frame_hw=SMALL_CANVAS)
    assert res["ao"] >= 0.78, res["ao"]
    assert abs(res["ao"] - jres["ao"]) <= 0.005, (res["ao"], jres["ao"])


def test_vot_supervised_matches_jax(suite, models):
    ds, jds = suite
    jmodel, v, port = models
    res = vot_eval.evaluate_vot(FEARTracker(port, device="cpu"), ds, burnin=2)
    jres = jvot.evaluate_vot(JFEARTracker(jmodel, v), jds, burnin=2)
    assert res["robustness_failures"] == jres["robustness_failures"]
    assert res["total_frames"] == jres["total_frames"]
    assert abs(res["accuracy"] - jres["accuracy"]) <= 0.005, (res["accuracy"], jres["accuracy"])
