"""What every cell of the benchmark shares: finding a cell's configuration,
traffic mix, driver and metric readers by name; the guard against the JAX
package; the device line; and the reduction of a ``torch.profiler`` trace
to device busy time, kernels by name and idle gaps by the benchmark span
the host was in.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model, its weights and its precision;
* ``traffic/<traffic>.json``: the mix's parameters, and under ``driver`` the
  module of ``drivers/`` that runs this kind of traffic;
* ``metrics/<metric>.py``: a reader ``read(rec)`` of one metric from the
  run's records, ``None`` where the run has nothing to read;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` for the cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "feartracker_tpu")
SPAN_PREFIX = "portbench."


def _json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Tuple[Dict, Dict, Dict]:
    """(the workload's entry, its configuration, its traffic mix)."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = found[0]
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    cfg = _json(os.path.join(root, entry["file"]))
    mix = _json(os.path.join(root, "portbench", "traffic", f"{wl['traffic']}.json"))
    return wl, cfg, mix


def limits(name: str, root: str = ROOT) -> Dict[str, float]:
    path = os.path.join(root, "portbench", "limits", f"{name}.json")
    return _json(path)["limits"] if os.path.exists(path) else {}


def load_file(path: str, modname: str):
    """A module from a file, whatever its name (``idle_pct.track.py``)."""
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: str = ROOT):
    return load_file(os.path.join(root, "portbench", "drivers", f"{kind}.py"), f"portbench_driver_{kind}")


def reader(metric: str, root: str = ROOT):
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    return load_file(path, "portbench_metric_" + metric.replace(".", "_"))


def cell_metrics(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    (``trace`` false) or its per-layer metrics (``trace`` true)."""
    def applies(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if m["moves"] in names and applies(m)]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name, compared whole,
    is the JAX package or a JAX library."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of card 0."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def process_start_wall() -> Optional[float]:
    """The wall-clock time at which this process started, from ``/proc``."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        import time

        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def cache_env() -> None:
    """Every kernel cache inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")


# -- traces ---------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(path: str, slice_span: str = SPAN_PREFIX + "slice") -> Dict:
    """A Chrome trace of ``torch.profiler`` → the traced slice's seconds
    (the host span ``slice_span``), the seconds in which an operation ran
    on the device (the union of kernels, copies and memsets), every kernel
    by name, the ten device operations that took most time and the ten
    longest idle gaps, each named by the innermost benchmark span that the
    host was in when the gap began."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    # the host's record_function ranges (the device's copies of them are
    # "gpu_user_annotation")
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    outer = [e for e in spans if e["name"] == slice_span]
    if not outer:
        raise ValueError(f"trace {path} holds no span {slice_span}")
    t0 = outer[0]["ts"]
    t1 = t0 + outer[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    merged = _union([(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)) for e in dev])
    busy = sum(b - a for a, b in merged)
    kernels = [(e["name"], e.get("dur", 0) / 1e6) for e in dev if e.get("cat") == "kernel"]
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0) / 1e6
    inner = [e for e in spans if e["name"] != slice_span]

    def host_span(ts: float) -> str:
        best = None
        for e in inner:
            if e["ts"] <= ts < e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best else "(between benchmark spans)"

    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": kernels,
        "device_ops": sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10],
        "idle_gaps": [[host_span(a), (b - a) / 1e6] for a, b in gaps[:10]],
    }


def profiled_slice(path: str, body) -> Dict:
    """Run ``body()`` under ``torch.profiler`` (host and CUDA activity)
    inside the span ``portbench.slice``, write the Chrome trace to ``path``,
    and return :func:`reduce_trace` of it. ``body`` ends with a device
    sync, so that the slice holds all of its work."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "slice"):
            body()
    prof.export_chrome_trace(path)
    try:
        return reduce_trace(path)
    finally:
        os.remove(path)
