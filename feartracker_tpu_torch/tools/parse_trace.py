"""Summarise a ``torch.profiler`` Chrome trace: device time by kernel and by
the aten op that launched it. The counterpart of ``tools/parse_trace.py``,
which reads a JAX xplane; here the trace is the ``trace.json`` that
``evaluate/profiling.py:trace`` writes (``chip_smoke.py`` phase 5c,
``tools/train_profile.py --trace``), so that a step's breakdown is measured,
not estimated.

Only device rows count: kernels, memcpys and memsets (``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset``). Host ranges (``cpu_op``, runtime calls) and
device-side annotation ranges contain those rows and would count them again,
as the JAX tool skips its container events.

Two tables, device ms and share of the total:

* by kernel name, template and argument lists stripped
  (``void at::native::elementwise_kernel<128, 4, ...>(int, ...)`` →
  ``at::native::elementwise_kernel``): the JAX tool's table by op kind;
  memcpys and memsets keep their own names;
* by the aten op that launched each row, with that op's input shapes (where
  the trace recorded them): the row's ``correlation`` id leads to the
  runtime call that launched it, and the innermost ``cpu_op`` that encloses
  that call on its thread is the op. A row launched outside any aten op (a
  kernel launched through ctypes, such as K1 and K2) is labelled
  ``(no aten op)`` with its kernel name. The JAX tool's table by output
  shape.

    python -m feartracker_tpu_torch.tools.parse_trace <trace.json, or a directory holding one> [--top 25]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_trace(path: str) -> List[dict]:
    """The events of a Chrome trace: ``path`` is the JSON file, or a
    directory whose newest ``*.json`` (searched recursively) is read."""
    if os.path.isdir(path):
        found = glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
        if not found:
            raise FileNotFoundError(f"no *.json trace under {path}")
        path = max(found, key=os.path.getmtime)
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def kernel_name(name: str) -> str:
    """A kernel's name without ``void``, ``(anonymous namespace)::``,
    template arguments and the argument list."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def _op_label(op: dict) -> str:
    dims = (op.get("args") or {}).get("Input Dims")
    if dims:
        shapes = [d for d in dims if d not in ([], None)]
        return f"{op['name']} {json.dumps(shapes, separators=(',', ':'))}"
    return op["name"]


def _launching_ops(events: Sequence[dict], wanted: set) -> Dict[int, dict]:
    """{correlation id: the innermost cpu_op enclosing its launch} for the
    launches whose correlation is in ``wanted``: one sweep a thread, with a
    stack of the ops open at each launch (host ops on a thread nest)."""
    launches, ops = collections.defaultdict(list), collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "cpu_op":
            ops[(e.get("pid"), e.get("tid"))].append(e)
        elif e.get("cat") in LAUNCH_CATS and (e.get("args") or {}).get("correlation") in wanted:
            launches[(e.get("pid"), e.get("tid"))].append(e)
    found = {}
    for key, lns in launches.items():
        lst = sorted(ops.get(key, ()), key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[dict] = []
        j = 0
        for ln in sorted(lns, key=lambda e: e["ts"]):
            while j < len(lst) and lst[j]["ts"] <= ln["ts"]:
                while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < lst[j]["ts"]:
                    stack.pop()
                stack.append(lst[j])
                j += 1
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < ln["ts"]:
                stack.pop()
            if stack:
                found[ln["args"]["correlation"]] = stack[-1]
    return found


def summarize(events: Sequence[dict]) -> dict:
    """→ ``{"total_ms", "rows", "by_kernel": [(name, ms)], "by_op": [(label,
    ms)]}``, each table sorted by ms, largest first."""
    rows = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    corr = {(e.get("args") or {}).get("correlation") for e in rows} - {None}
    ops = _launching_ops(events, corr)
    by_kernel: Dict[str, float] = collections.Counter()
    by_op: Dict[str, float] = collections.Counter()
    total = 0.0
    for e in rows:
        ms = e.get("dur", 0) / 1e3
        total += ms
        name = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_kernel[name] += ms
        op = ops.get((e.get("args") or {}).get("correlation"))
        by_op[_op_label(op) if op is not None else f"(no aten op) {name}"] += ms
    return {"total_ms": total, "rows": len(rows),
            "by_kernel": sorted(by_kernel.items(), key=lambda kv: -kv[1]),
            "by_op": sorted(by_op.items(), key=lambda kv: -kv[1])}


def format_tables(summary: dict, top: int = 25) -> str:
    total = summary["total_ms"] or 1.0
    lines = [f"== {summary['total_ms']:.3f} ms device time in {summary['rows']} kernel, memcpy and memset rows =="]
    for title, key in (("by kernel", "by_kernel"), ("by aten op (input shapes)", "by_op")):
        lines.append(f"{title}:")
        lines += [f"  {ms:9.3f} ms {100 * ms / total:5.1f}%  {name}" for name, ms in summary[key][:top]]
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a Chrome trace .json, or a directory holding one")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    print(format_tables(summarize(load_trace(args.trace)), args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
