"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload fear_xs.track.s128 --seed 7 --seconds 20 --trace 0

The cell's configuration, traffic mix and driver are found by the names in
``BENCHMARK.json`` (see ``portbench/harness.py``). A run:

1. refuses to start without as many CUDA cards as the cell asks for;
2. builds the program under test (``feartracker_tpu_torch``) and its inputs
   from ``--seed`` and warms up every shape the traffic uses: that is
   ``setup_s``, counted from the process's start;
3. measures for ``--seconds`` seconds; with ``--trace 1`` it then traces a
   bounded slice of further calls with ``torch.profiler``;
4. reads the device's peak memory, frees the program, and judges what the
   timed path produced with the plain reference (``portbench/reference``);
5. prints each number compared beside its limit on standard error, and as
   its last line of standard output one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
   with ``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced
   runs) and, last, ``checks``.

It exits non-zero and prints no result if the process holds a module of
the JAX package or of a JAX library once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

T_IMPORT = time.time()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def execute(workload: str, seed: int, seconds: float, trace: bool, device, start: float):
    """One run of ``workload`` on ``device`` → (result line, checks). The
    card's check and the exit codes are :func:`main`'s; the tests call this
    on the CPU."""
    import torch

    bench = harness.benchmark()
    wl, cfg, mix = harness.cell(workload)
    on_card = device.type == "cuda"
    run = harness.driver(mix["driver"]).Run(cfg, mix, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    rec = {"cell": wl, "config": cfg, "mix": mix, "setup_s": time.time() - start}
    rec["window"] = run.window(seconds)
    if trace:
        path = os.path.join(tempfile.gettempdir(), f"portbench_trace_{os.getpid()}.json")
        rec["trace"] = run.trace_slice(path)
    rec["counts"] = run.counts()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.free_program()
    limits = harness.limits(wl["name"])
    numbers = run.judge()
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = bool(limits) and all(limits.get(k) is not None and v <= limits[k] for k, v in numbers.items())

    metrics = {}
    for m in harness.cell_metrics(bench, wl["name"], trace):
        v = harness.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "count": wl["chips"],
           "memory_peak_bytes": int(memory_peak), "card": harness.card_line() if on_card else "cpu"}
    out = {"correct": correct, "attempted": rec["window"]["attempted"], "failed": rec["window"].get("failed", 0),
           "metrics": metrics, "device": dev}
    if trace:
        tr = rec["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    return out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = harness.process_start_wall() or T_IMPORT
    wl = harness.cell(args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    harness.cache_env()
    torch.set_num_threads(4)
    out, checks = execute(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), start)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds the JAX package or a JAX library: {found}", file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
