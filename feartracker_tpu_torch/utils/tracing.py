"""The port's one tracing system: spans, counters and in-graph layer marks,
off by default.

* :func:`span` opens a ``torch.profiler.record_function`` range. Any
  ``torch.profiler`` trace taken around the work then holds it on the clock
  of the device's events, and ties the kernels launched eagerly inside it
  to it through their runtime correlation ids. The profiler keeps the spans
  in memory; they are written only when its caller exports the trace. Each
  span also keeps its own host seconds (:func:`host_times`), so host times
  can be read with no profiler running, which slows the host's side.
* :func:`count` adds to an in-memory dict; :func:`counters` returns a
  snapshot of it, with the kernel wrappers' own launch counters beside it.
* :func:`mark` records a layer boundary inside a CUDA graph being captured:
  a one-thread, empty kernel named ``fear_mark<k>`` (``csrc/mark.cu``),
  ``k`` the layer's index in :data:`LAYERS`. A graph replay runs no Python,
  so the marks are what carry its layer boundaries, in time order, into the
  device trace. :func:`layer` is a mark and a span of the same name.

Off, :func:`span` and :func:`layer` return one shared no-op context and
:func:`count` and :func:`mark` return at once: a flag test each. No mark is
captured then, so the graphs are those of a program without tracing.

Turn it on around the work to read (``enable()``, ``reset()``, the work,
under ``torch.profiler`` for device times, ``counters()`` and
``host_times()``, ``disable()``). A tracker's captured graphs are keyed by
the flag, so work traced after ``enable()`` captures marked graphs once,
and ``disable()`` goes back to the unmarked ones.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from feartracker_tpu_torch.ops.cuda.build import check_launch, load_library
from feartracker_tpu_torch.ops.cuda.crop import crop_cuda
from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block

# the layers of a tracking step, in the order a step runs them; a mark's
# kernel carries its layer's index here
LAYERS = ("fear.crop", "fear.trunk", "fear.head", "fear.decode", "fear.refresh", "fear.state")

_NULL = contextlib.nullcontext()
_enabled = False
_counts: Dict[str, int] = {}
_host: Dict[str, List[float]] = {}


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


class _Span:
    """A ``record_function`` range that keeps its host seconds."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _host.setdefault(self.name, []).append(time.perf_counter() - self._t0)
        return self._range.__exit__(*exc)


def span(name: str):
    """A ``record_function`` range named ``name``, timed on the host's
    clock, while tracing is on; the shared no-op context while it is off."""
    if not _enabled:
        return _NULL
    return _Span(name)


def layer(name: str):
    """:func:`mark` the layer ``name`` (one of :data:`LAYERS`) and return
    its :func:`span`."""
    if not _enabled:
        return _NULL
    mark(name)
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    if _enabled:
        _counts[name] = _counts.get(name, 0) + n


def reset() -> None:
    _counts.clear()
    _host.clear()


def counters() -> Dict[str, int]:
    """Every counter the port keeps: those of :func:`count` since the last
    :func:`reset`, and the kernel wrappers' launch counters, which count
    from the process's start (eager launches, and kernels recorded at
    capture)."""
    return dict(_counts, **{"postprocess_cuda.launches": postprocess_cuda.launches,
                            "fused_ir_block.launches": fused_ir_block.launches,
                            "crop_cuda.launches": crop_cuda.launches})


def host_times() -> Dict[str, List[float]]:
    """Each span's host seconds since the last :func:`reset`, one entry an
    occurrence."""
    return {k: list(v) for k, v in _host.items()}


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph: work recorded
    then runs only at the graph's replays."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def mark(name: str) -> None:
    """Launch ``fear_mark<k>`` on the current stream, ``k`` =
    ``LAYERS.index(name)``, if tracing is on and that stream is capturing a
    CUDA graph; otherwise nothing (eager work is tied to its spans by the
    profiler, and the CPU has no graphs)."""
    if not _enabled or not capturing():
        return
    k = LAYERS.index(name)
    check_launch(load_library().fear_mark_launch(k, torch.cuda.current_stream().cuda_stream), "fear_mark")
