"""The program's own spans, counters and layer marks, read from a traced
slice: the per-layer numbers that the benchmark's spans round whole calls
cannot give.

:func:`trace_program` takes a driver's ``Run`` after its window and traced
slice, before its ``free_program``: it turns the program's tracing
(``feartracker_tpu_torch/utils/tracing.py``) on, runs one call or ``depth``
steps (which captures the marked CUDA graphs), a slice of ``trace_calls``
calls or ``trace_steps`` steps timed by the spans on the host's clock alone,
the same slice again under ``torch.profiler``, and turns tracing off. The
per-layer readers ``metrics/crop_ms.track.py`` … ``refresh_ms.pool.py`` read
what it returns from ``rec["program"]``, and read nothing without it.

:func:`reduce_program_trace` attributes every device operation of the
profiled slice: an eagerly launched one to the innermost ``fear.`` span open
on the launching thread when its runtime call was made (by the correlation
id that ``torch.profiler`` gives the call and the operation); one of a CUDA
graph replay, whose kernels all share the replay's one ``cudaGraphLaunch``,
to the layer of the last ``fear_mark<k>`` kernel before it in time order.
"""

from __future__ import annotations

import collections
import json
import os
import re
import statistics
from typing import Dict, List, Optional, Sequence

from portbench import harness

PROGRAM_PREFIX = "fear."
MARK = re.compile(r"fear_mark<(\d+)>")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside the program's spans)"


def _corr(e: Dict) -> Optional[int]:
    return (e.get("args") or {}).get("correlation")


def _dur(e: Dict) -> float:
    return e.get("dur", 0) / 1e6


def reduce_program_trace(path: str, layers: Sequence[str], slice_span: str = harness.SPAN_PREFIX + "slice") -> Dict:
    """A Chrome trace of ``torch.profiler`` holding the program's spans and
    marks → a dict of

    * ``spans``: each ``fear.`` and ``portbench.`` span's host seconds, a
      list with one entry per occurrence;
    * ``span_device_s``: each ``fear.`` span's device seconds per
      occurrence, of the operations launched eagerly inside it (its child
      spans' included) and of the graph replays launched inside it;
    * ``self_device_s``: device seconds by the innermost ``fear.`` span of
      each eager launch (``OUTSIDE`` where none was open), and of a
      replay's operations ahead of its first mark;
    * ``segments``: by layer (``layers[k]`` for ``fear_mark<k>``), the
      device seconds of each segment of a replay from one mark to the next,
      the marks' own time left out (``marks_s``);
    * ``top_ops``: by span or layer as above, its eight operations that
      took most device time, by name;
    * ``device_s`` (every device operation's time), ``unattributed_s``
      (operations with no runtime call in the trace), ``kernels`` and
      ``kernel_s`` (marks included), ``marks``, ``window_s``, ``busy_s``
      and ``idle_gaps``: the slice's ten longest idle gaps, each named by
      the innermost ``fear.`` or ``portbench.`` span the host was in when
      it began.

    ``self_device_s``, ``segments``, ``marks_s`` and ``unattributed_s`` sum
    to ``device_s``: every operation is counted in exactly one of them."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    prefixes = (PROGRAM_PREFIX, harness.SPAN_PREFIX)
    spans = [e for e in xs if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(prefixes)]
    outer = [e for e in spans if e["name"] == slice_span]
    if not outer:
        raise ValueError(f"trace {path} holds no span {slice_span}")
    t0, t1 = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"]
    inner = [e for e in spans if e is not outer[0] and t0 <= e["ts"] < t1]
    program = [e for e in inner if e["name"].startswith(PROGRAM_PREFIX)]
    by_thread = collections.defaultdict(list)
    for i, e in enumerate(program):
        by_thread[(e.get("pid"), e.get("tid"))].append(i)

    dev = [e for e in xs if e.get("cat") in harness.DEVICE_CATS and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    ops = collections.defaultdict(list)
    for e in dev:
        ops[_corr(e)].append(e)
    span_dev = [0.0] * len(program)
    self_dev: Dict[str, float] = collections.defaultdict(float)
    segments: Dict[str, List[float]] = collections.defaultdict(list)
    by_name: Dict[str, Dict[str, float]] = collections.defaultdict(lambda: collections.defaultdict(float))
    marks_s, attributed = 0.0, 0.0
    for r in xs:
        if r.get("cat") not in RUNTIME_CATS or _corr(r) is None or _corr(r) not in ops:
            continue
        launched = ops.pop(_corr(r))
        candidates = by_thread.get((r.get("pid"), r.get("tid")), range(len(program)))
        enclosing = [i for i in candidates if program[i]["ts"] <= r["ts"] < program[i]["ts"] + program[i]["dur"]]
        owner = program[min(enclosing, key=lambda i: program[i]["dur"])]["name"] if enclosing else OUTSIDE
        total = sum(_dur(o) for o in launched)
        attributed += total
        for i in enclosing:
            span_dev[i] += total
        if "GraphLaunch" not in r.get("name", ""):
            self_dev[owner] += total
            for o in launched:
                by_name[owner][o.get("name", "")] += _dur(o)
            continue
        layer = None
        for o in sorted(launched, key=lambda o: o["ts"]):
            m = MARK.search(o.get("name", ""))
            if m:
                marks_s += _dur(o)
                layer = layers[int(m.group(1))]
                segments[layer].append(0.0)
                continue
            if layer is None:
                self_dev[owner] += _dur(o)
            else:
                segments[layer][-1] += _dur(o)
            by_name[layer or owner][o.get("name", "")] += _dur(o)

    host: Dict[str, List[float]] = collections.defaultdict(list)
    for e in inner:
        host[e["name"]].append(_dur(e))
    on_device: Dict[str, List[float]] = collections.defaultdict(list)
    for e, s in zip(program, span_dev):
        on_device[e["name"]].append(s)

    merged = harness._union([(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)) for e in dev])
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)

    def host_span(ts: float) -> str:
        open_ = [e for e in inner if e["ts"] <= ts < e["ts"] + e["dur"]]
        return min(open_, key=lambda e: e["dur"])["name"] if open_ else "(between spans)"

    device_s = sum(_dur(e) for e in dev)
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(b - a for a, b in merged) / 1e6,
        "device_s": device_s,
        "kernels": sum(1 for e in dev if e.get("cat") == "kernel"),
        "kernel_s": sum(_dur(e) for e in dev if e.get("cat") == "kernel"),
        "marks": sum(1 for e in dev if MARK.search(e.get("name", ""))),
        "marks_s": marks_s,
        "unattributed_s": device_s - attributed,
        "spans": dict(host),
        "span_device_s": dict(on_device),
        "self_device_s": dict(self_dev),
        "segments": dict(segments),
        "top_ops": {k: sorted(v.items(), key=lambda kv: kv[1], reverse=True)[:8] for k, v in by_name.items()},
        "idle_gaps": [[host_span(a), (b - a) / 1e6] for a, b in gaps[:10]],
    }


# -- the readers' shared arithmetic -----------------------------------------------


def segment_ms_per_frame(rec: Dict, layer: str) -> Optional[float]:
    """Device ms a frame of ``layer``'s segments of the program slice's
    graph replays."""
    p = rec.get("program")
    seg = p and p["segments"].get(layer)
    return sum(seg) / p["steps"] * 1e3 if seg else None


def span_device_ms_per_frame(rec: Dict, name: str) -> Optional[float]:
    """Device ms a frame of the operations launched inside span ``name``."""
    p = rec.get("program")
    got = p and p["span_device_s"].get(name)
    return sum(got) / p["steps"] * 1e3 if got else None


def median_host_ms(rec: Dict, name: str) -> Optional[float]:
    """The median host ms of an occurrence of span ``name`` in the slice
    timed with no profiler running."""
    p = rec.get("program")
    got = p and p["host_s"].get(name)
    return statistics.median(got) * 1e3 if got else None


# -- tracing the program ------------------------------------------------------------


def trace_program(run, path: str) -> Optional[Dict]:
    """The program's traced slice of a driver's ``Run`` (before its
    ``free_program``) → :func:`reduce_program_trace` of the profiled slice,
    with ``steps`` (the frames of the slice: a time step of the S streams,
    or a pool step), ``counters`` (the program's, over the profiled slice)
    and ``host_s`` (each span's host seconds an occurrence, over the slice
    run before it with no profiler: the profiler's own cost a launch slows
    the host's side). None where the program has no tracing."""
    import torch

    try:
        from feartracker_tpu_torch.utils import tracing
    except ImportError:
        return None
    mix = run.mix
    tracing.enable()
    try:
        # outside the profiler: the marked graphs are captured here
        if mix["driver"] == "pool_pipelined":
            run._run(mix["depth"], None)
            steps = mix["trace_steps"]

            def body():
                run._run(steps, None)
                run._sync()
        else:
            run._call()
            steps = mix["trace_calls"] * run.T

            def body():
                for _ in range(mix["trace_calls"]):
                    run._call()
                run._sync()
        run._sync()
        tracing.reset()
        body()
        host_s = tracing.host_times()
        tracing.reset()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(harness.SPAN_PREFIX + "slice"):
                body()
        prof.export_chrome_trace(path)
        try:
            rec = reduce_program_trace(path, tracing.LAYERS)
        finally:
            os.remove(path)
        rec.update(steps=steps, counters=tracing.counters(), host_s=host_s)
        return rec
    finally:
        tracing.disable()
