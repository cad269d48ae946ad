"""Readings for the limits that decide ``correct``: the program's numbers
over many seeds, and the control's (the reference in float8 put in the
program's place, on the same traffic), in one process.

    python3 portbench/calibrate.py --workload fear_xs.track.s128 --seeds 11,12,13 --control 11,12 --seconds 3

The cell is named ``<config>.<traffic>`` and found by those files, so a
cell that ``BENCHMARK.json`` does not hold yet can be read too. Each seed
builds the cell as a run does, runs a short window at the cell's
own load and judges it; one JSON line a seed and side. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True,
                    help="<config>.<traffic>: a cell of BENCHMARK.json, or one named by its files alone")
    ap.add_argument("--seeds", required=True, help="comma list: the program's seeds")
    ap.add_argument("--control", default="", help="comma list: seeds on which the control runs too")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from portbench.reference import fear

    config, traffic = args.workload.split(".", 1)
    cfg = json.load(open(os.path.join(harness.BENCH_DIR, "configs", f"{config}.json")))
    mix = json.load(open(os.path.join(harness.BENCH_DIR, "traffic", f"{traffic}.json")))
    harness.cache_env()
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    control = {int(s) for s in args.control.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        run = harness.driver(mix["driver"]).Run(cfg, mix, seed, device)
        run.window(args.seconds)
        run.free_program()
        print(json.dumps({"seed": seed, "side": "program", **run.judge(),
                          "seconds": time.time() - t0}), flush=True)
        if seed in control:
            print(json.dumps({"seed": seed, "side": "control",
                              **run.judge(control=fear.Precision("fp8"))}), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
