"""The port's throughput tools (``feartracker_tpu_torch/tools``), each run
through its ``main`` on the CPU at S=2, T=2: the device line first, then
JSON lines that parse, with the fields the JAX tools print."""

import json

import pytest
import torch

from feartracker_tpu_torch.tools import (
    family_bench,
    multiobject_bench,
    serving_bench,
    sweep_streams,
    unroll_probe,
)

SMALL = ["--warmup", "1", "--timed", "1"]
CASES = {
    "unroll_probe": (unroll_probe, ["--unrolls", "1,2"], "unroll", 2),
    "sweep_streams": (sweep_streams, ["--streams", "2", "--chunk", "2", "--repeats", "1", *SMALL], "S", 1),
    "serving_bench": (serving_bench, ["--streams", "2", "--chunk", "2", *SMALL], "mode", 4),
    "multiobject_bench": (multiobject_bench, ["--objects", "2", "--chunk", "2", "--chunks", "1",
                                              "--height", "256", "--width", "480"], "mode", 2),
    "family_bench": (family_bench, ["--streams", "2", "--chunk", "2", "--repeats", "1", *SMALL], "model", 3),
}


@pytest.fixture(autouse=True)
def _small_cpu_run(monkeypatch):
    for k, v in {"BENCH_DEVICE": "cpu", "PROBE_WARMUP": "1", "PROBE_TIMED": "1", "PROBE_STREAMS": "2",
                 "PROBE_CHUNK": "2", "PROBE_REPEATS": "1"}.items():
        monkeypatch.setenv(k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tool_prints_json_lines(name, capsys):
    tool, argv, key, n_lines = CASES[name]
    tool.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    records = [json.loads(line) for line in out if line.startswith("{")]
    assert len(records) == n_lines and all(key in r for r in records), out
    if name == "family_bench":
        assert [(r["model"], r["weights"]) for r in records] == [
            ("fear_xs", "fear_xs"), ("fear_m", "random"), ("fear_l", "random")]
        assert all(r["finite"] for r in records)
    if name == "unroll_probe":
        assert [r["unroll"] for r in records] == [1, 2] and all(r["fps"] > 0 for r in records)


def test_seeded_family_init_is_reproducible():
    a, b = family_bench.seeded_model("fear_m"), family_bench.seeded_model("fear_m")
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
