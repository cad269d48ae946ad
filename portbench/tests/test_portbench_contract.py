"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds by that name."""

import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m) <= allowed
    for w in m.get("workloads", []):
        assert w in CELLS


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_every_metric_has_its_reader(m):
    mod = harness.reader(m["name"])
    assert mod.NAME == m["name"] and mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    if "moves" in m:
        assert mod.MOVES == m["moves"] and mod.LAYER == m["layer"]
    assert mod.read({"window": {}, "counts": {}}) is None


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    wl, cfg, mix = harness.cell(name)
    assert wl["chips"] in (1, 4) and 1 <= len(wl["why"]) <= 200 and NAME.match(wl["traffic"])
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers", f"{mix['driver']}.py"))
    assert harness.limits(name), f"no limits file for {name}"
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, name, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, name, True)


@pytest.mark.parametrize("c", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(c):
    assert c["file"].startswith("portbench/") and c["source"].startswith("https://")
    cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    assert os.path.exists(os.path.join(harness.ROOT, cfg["weights"]))


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as new files
    and entries, in a copy, are found without an edit of any file there."""
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    cfg = json.load(open(os.path.join(harness.ROOT, "portbench/configs/fear_xs.json")))
    (root / "portbench/configs/fear_xs_f32.json").write_text(json.dumps(dict(cfg, name="fear_xs_f32", dtype="float32")))
    mix = json.load(open(os.path.join(harness.ROOT, "portbench/traffic/track.s128.json")))
    (root / "portbench/traffic/track.s32.json").write_text(json.dumps(dict(mix, streams=32)))
    (root / "portbench/metrics/calls_per_s.py").write_text(
        'NAME = "calls_per_s"\nUNIT = "calls/s"\nLAYER = "tracker.runtime"\nMOVES = "frames_per_s"\n'
        'SOURCE = "host_clock"\n\n\ndef read(rec):\n    w = rec["window"]\n'
        '    return w["calls"] / w["seconds"] if "calls" in w else None\n')
    (root / "portbench/limits/fear_xs_f32.track.s32.json").write_text(json.dumps({"limits": {"conf_gap": 0.1}}))
    bench["configs"] = BENCH["configs"] + [{"name": "fear_xs_f32", "source": "https://example.org/x",
                                              "file": "portbench/configs/fear_xs_f32.json", "reduced": [],
                                              "why": "test"}]
    cell = {"name": "fear_xs_f32.track.s32", "config": "fear_xs_f32", "traffic": "track.s32", "chips": 1,
            "why": "test"}
    bench["workloads"] = BENCH["workloads"] + [cell]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + [cell["name"]]) if m["name"] == "frames_per_s" else m
                           for m in BENCH["end_to_end"]]
    bench["per_layer"] = BENCH["per_layer"] + [{"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                                                "source": "host_clock", "layer": "tracker.runtime",
                                                "moves": "frames_per_s", "workloads": [cell["name"]]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    wl, c, m = harness.cell(cell["name"], root=str(root))
    assert c["dtype"] == "float32" and m["streams"] == 32 and m["driver"] == "track_chunks"
    assert harness.limits(cell["name"], root=str(root)) == {"conf_gap": 0.1}
    names = [x["name"] for x in harness.cell_metrics(bench, cell["name"], True)]
    assert "calls_per_s" in names
    assert harness.reader("calls_per_s", root=str(root)).read({"window": {"calls": 4, "seconds": 2.0}}) == 2.0
    assert harness.driver("track_chunks", root=str(root)).Run
