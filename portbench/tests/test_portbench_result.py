"""The result line: its keys, their order, and the refusal without a card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, run


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(small_cells, trace):
    out, checks = run.execute("fear_xs.track.s128", 11, 0.5, trace, torch.device("cpu"), time.time())
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] is not None, name
    wanted = {m["name"] for m in harness.cell_metrics(harness.benchmark(), "fear_xs.track.s128", trace)}
    assert set(out["metrics"]) <= wanted
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] is not None
    if not trace:
        assert set(out["metrics"]) == wanted
    json.dumps(out)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fear_xs.track.s128", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == "" and "CUDA" in p.stderr
