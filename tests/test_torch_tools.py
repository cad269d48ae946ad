"""The port's throughput tools (``feartracker_tpu_torch/tools``), each run
through its ``main`` on the CPU at S=2, T=2: the device line first, then
JSON lines that parse, with the fields the JAX tools print."""

import json

import pytest
import torch

from feartracker_tpu_torch.tools import (
    family_bench,
    fused_trunk_bench,
    ir_block_micro,
    multiobject_bench,
    recovery_throughput,
    serving_bench,
    sweep_streams,
    train_profile,
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
    "sweep_streams_xla": (sweep_streams, ["--streams", "2", "--chunk", "2", "--repeats", "1", "--trunk_impl", "xla",
                                          *SMALL], "S", 1),
    "recovery_throughput": (recovery_throughput, [], "weights", 3),
    "fused_trunk_bench": (fused_trunk_bench, ["--streams", "2", "--chunk", "2", "--check_streams", "2",
                                              "--repeats", "1", *SMALL], "chunk", 3),
    "ir_block_micro": (ir_block_micro, ["--streams", "2", "--blocks", "3,4", "--inner", "1", "--timed", "1",
                                        "--repeats", "1"], "plain_ms", 2),
}
# the JAX tools' keys in each tool's lines, a rate as ``<name>_on_cpu`` (a CPU
# run's rates are no device metric)
JAX_KEYS = {
    "recovery_throughput": [{"recover_context", "fps_on_cpu", "streams", "chunk", "weights"}] * 2
    + [{"summary", "baseline_fps_on_cpu", "recovery_fps_on_cpu", "overhead_pct", "weights"}],
    "fused_trunk_bench": [{"check", "max_abs_px", "mean_abs_px"}]
    + [{"impl", "weights", "compile_s", "ms_per_call", "tracked_fps_on_cpu", "k2_launches_per_call"}] * 2,
    "ir_block_micro": [{"block", "spec", "in", "eligible", "plain_ms"}, {"block", "spec", "in", "eligible",
                                                                         "plain_ms", "fused_ms", "speedup"}],
}


@pytest.fixture(autouse=True)
def _small_cpu_run(monkeypatch):
    for k, v in {"BENCH_DEVICE": "cpu", "PROBE_WARMUP": "1", "PROBE_TIMED": "1", "PROBE_STREAMS": "2",
                 "PROBE_CHUNK": "2", "PROBE_REPEATS": "1", "BENCH_WARMUP": "1", "BENCH_TIMED": "1",
                 "BENCH_STREAMS": "2", "BENCH_CHUNK": "2", "BENCH_REPEATS": "1"}.items():
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
    for want, r in zip(JAX_KEYS.get(name, ()), records):
        assert want <= set(r), (want - set(r), r)
    if name == "recovery_throughput":
        assert [r.get("recover_context") for r in records] == [0.0, 3.0, None]
    if name == "fused_trunk_bench":
        assert [r.get("impl") for r in records] == [None, "xla", "fused"]
        assert all(r["k2_launches_per_call"] == 0 for r in records[1:])  # the CPU runs the twins
    if name == "ir_block_micro":
        assert [(r["block"], r["eligible"]) for r in records] == [(3, False), (4, True)]
        assert records[1]["max_abs_err"] == 0.0 and records[1]["bound_share_pct"] is None


def test_seeded_family_init_is_reproducible():
    a, b = family_bench.seeded_model("fear_m"), family_bench.seeded_model("fear_m")
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("extra", [[], ["--scan_steps", "2"], ["--dual", "--dtype", "float32"]],
                         ids=["plain", "scan_steps", "dual_f32"])
def test_train_profile_prints_json_lines(extra, capsys):
    """The training sweep on the tiny model at B=2 on the CPU: a line per
    batch size with the step time, the FLOPs counted at B=1 times B, and a
    loss that falls over the steps on the fixed batch."""
    train_profile.main(["--device", "cpu", "--model", "tiny", "--batches", "2,3", "--warmup", "1",
                        "--timed", "3", *extra])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    records = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["batch"] for r in records] == [2, 3]
    for r in records:
        assert r["step_ms"] > 0 and r["samples_per_s"] > 0 and r["device"] == "cpu"
        assert r["mfu_pct"] is None and r["peak_mem_bytes"] is None  # no device metric from a CPU run
        assert r["loss_last"] < r["loss_first"]
        assert r["steps"] == 4 * r["scan_steps"]
    assert records[1]["flops_per_step"] * 2 == records[0]["flops_per_step"] * 3


def test_train_profile_trace_line(tmp_path, capsys):
    train_profile.main(["--device", "cpu", "--model", "tiny", "--batches", "2", "--warmup", "1", "--timed", "1",
                        "--trace", str(tmp_path)])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(records) == 2 and records[1]["traced_steps"] == 3
    assert records[1]["busy_ms_per_step"] is None  # a CPU trace holds no device rows
    assert (tmp_path / "trace.json").exists()


def test_train_profile_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_profile.main(["--batches", "2", "--model", "tiny"])
