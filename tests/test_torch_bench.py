"""The port's bench (``python -m feartracker_tpu_torch.bench``) on the CPU,
in the style of ``tests/test_bench_provenance.py``: one JSON line with
``bench.py``'s keys and ``weights: "fear_xs"``; a run whose weights cannot
load exits non-zero and prints no result (there is no random-weights run).
Also the synthetic streams it tracks: the JAX harness's pixels for the same
seed, the stream axis an expanded view."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from feartracker_tpu.evaluate import harness as jharness
from feartracker_tpu_torch.evaluate.harness import synthetic_streams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"BENCH_DEVICE": "cpu", "BENCH_WARMUP": "1", "BENCH_TIMED": "1", "BENCH_STREAMS": "2",
       "BENCH_CHUNK": "2", "BENCH_REPEATS": "1", "OMP_NUM_THREADS": "1"}


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, **ENV}, timeout=300)


def test_bench_prints_one_json_line():
    proc = _run("from feartracker_tpu_torch import bench; bench.main()")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "weights", "vs_baseline"}
    assert rec["weights"] == "fear_xs" and rec["vs_baseline"] > 0 and rec["value"] > 0
    assert rec["unit"] == "frames/sec/cpu"  # a CPU run is never labelled a card's
    assert proc.stdout.splitlines()[0] == "cpu"


def test_bench_without_weights_fails():
    proc = _run(
        "import feartracker_tpu_torch.convert.load as cl\n"
        "def _boom(*a, **k): raise IOError('weights unavailable')\n"
        "cl.variables_from_npz = _boom\n"
        "from feartracker_tpu_torch import bench; bench.main()\n"
    )
    assert proc.returncode != 0
    assert "weights unavailable" in proc.stderr
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_streams_match_jax_and_store_one_video(seed):
    S, T = 3, 2
    f0, chunk, boxes = synthetic_streams(S, T, frame_hw=(32, 48), seed=seed, device="cpu")
    jf0, jchunk, jboxes = jharness.synthetic_streams(S, T, frame_hw=(32, 48), seed=seed)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    np.testing.assert_array_equal(chunk.numpy(), np.asarray(jchunk))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jboxes))
    assert tuple(chunk.shape) == (T, S, 32, 48, 3) and chunk.stride(1) == 0 and f0.stride(0) == 0


def test_synthetic_streams_default_to_the_card():
    assert inspect.signature(synthetic_streams).parameters["device"].default == "cuda"
