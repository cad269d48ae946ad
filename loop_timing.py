#!/usr/bin/env python3
"""The training loop's step call on the host, with the card's loader stopped
and running, to tell apart why the call slows while the loader works.

FEAR-XS from ``fear_xs.npz`` in bfloat16 at B=32 with device augmentations,
on the rendered ``.npy`` clips of ``tools/make_npy_dataset.py`` (the data
path of ``chip_smoke.py``'s phase 12c), stepping as ``Trainer.train_epoch``
does: the batches through ``prefetch_to_device``, one step call, one read of
its scalars. Each way below runs ``--steps`` steps, after warm-up steps on
one staged batch:

* ``stopped``: the loader's batches all made first, its threads gone;
* ``running``: the loader's worker threads run beside the steps, as in the
  loop (run twice, first and last, to show the drift between runs);
* ``one_thread``: the same, each worker thread at one intra-op thread
  (under OpenMP ``torch.set_num_threads`` is the calling thread's own
  setting), so 8 workers keep 8 busy threads on the host, not 8 teams;
  ``one_thread_fewer``: the same with one worker fewer, so that the
  workers and the main thread together need no more cores than the host
  has;
* ``switch``: ``running`` with Python's GIL switch interval at 0.5 ms
  (5 ms by default), so a main thread that waits for the GIL gets it back
  sooner;
* ``core_hogs`` and ``gil_hogs``: ``stopped`` beside threads that stand
  in for the workers: ``WORKERS`` ``torch.mm`` loops at one intra-op
  thread each, which keep every core busy and hold the GIL only between
  products; or one pure Python loop, which holds the GIL and keeps one
  core busy;
* ``process_hogs``: ``stopped`` beside ``WORKERS`` processes, each a
  ``torch.mm`` loop at one intra-op thread: every core busy, and no other
  thread in this process wants the GIL.

A step call that is slow under ``running`` and near ``stopped`` under
``one_thread`` says the workers' intra-op thread teams oversubscribe the
cores; one that stays slow there but speeds up under ``switch`` says the
GIL; so does a call that ``gil_hogs`` slows and ``core_hogs`` does not.
A call that ``process_hogs`` slows as much as ``core_hogs`` is slowed by
the cores' load itself. Prints each way's step call, read and step-to-step
ms (the first step apart; median, min and max of the others), the main
thread's CPU time (``time.thread_time``) in its slow calls (over twice
``stopped``'s median) against their wall, and the loader alone a batch
with and without one intra-op thread, the card's name and power limit, and
last one JSON object of them all::

    python3 loop_timing.py [--steps 8] [--ways running,core_hogs]

A way stops early once it has run ``WAY_SECONDS``.

Needs one CUDA card; builds no kernel (the train step launches none).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
B = 32
WORKERS = 8  # the loader's threads, as phase 13 and the configuration's num_workers
WARMUP = 3  # steps on one staged batch before the first way
WAY_SECONDS = 60.0  # a way stops after its first step call that ends past this wall time


class _OneThread:
    """A dataset whose items are made at one intra-op thread in each thread
    that makes them."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i):
        import torch

        if torch.get_num_threads() != 1:
            torch.set_num_threads(1)
        return self.dataset[i]


def _hog(kind: str, stop: threading.Event) -> None:
    if kind == "gil":
        while not stop.is_set():
            sum(range(1000))
        return
    import torch

    torch.set_num_threads(1)
    a = torch.randn(384, 384)
    while not stop.is_set():
        torch.mm(a, a)


def _stats(xs) -> dict:
    ms = [x * 1e3 for x in xs]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8, help="steps (and loader batches) in each way")
    ap.add_argument("--ways", default="running,one_thread,one_thread_fewer,switch,core_hogs,process_hogs,gil_hogs,"
                                      "running",
                    help="the ways to run, in order, after stopped (which always runs first)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))

    import torch

    if not torch.cuda.is_available():
        print("loop_timing: no CUDA card", file=sys.stderr)
        return 1
    from feartracker_tpu_torch.data import device_augs as augs
    from feartracker_tpu_torch.data.dataset import SiameseTrackingDataset
    from feartracker_tpu_torch.data.loader import BatchLoader, prefetch_to_device
    from feartracker_tpu_torch.evaluate.harness import device_line
    from feartracker_tpu_torch.tools.make_npy_dataset import write_npy_dataset
    from feartracker_tpu_torch.tools.train_profile import build_model
    from feartracker_tpu_torch.train.loop import _SCALARS
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state, make_train_step

    dev = torch.device("cuda")
    card = device_line(dev)
    main_threads = torch.get_num_threads()
    tx = build_optimizer({"name": "adam", "lr": 1e-4})
    state = create_train_state(build_model("fear_xs")[0], tx, device=dev)
    step = make_train_step(tx, device_augs=augs.DeviceAugConfig(
        search_size=256, scale=0.35, shift=48.0, grid_size=16, total_stride=16), aug_seed=0, dtype=torch.bfloat16)
    out: dict = {"card": card, "batch": B, "steps": args.steps, "workers": WORKERS,
                 "intra_op_threads_main": main_threads,
                 "parallel_backend": next(line.strip() for line in torch.__config__.parallel_info().splitlines()
                                          if "backend" in line)}

    with tempfile.TemporaryDirectory() as root:
        sizes = {"search_image_size": 256, "template_image_size": 128, "search_context": 2,
                 "template_bbox_offset": 0.2, "search_image_shift": 48, "search_image_scale": 0.35,
                 "context_range": 3}  # chip_smoke.py's TRAIN_SIZES
        cfg = {"root": root, "name": "rendered", "sizes": sizes, "regression_weight_label_size": 16,
               "device_augs": True,
               "sampling": {"type": "track", "data_path": write_npy_dataset(root), "negative_ratio": 0.0,
                            "frame_offset": 70, "num_samples": B * args.steps, "clip_range": True}}
        dataset = SiameseTrackingDataset(cfg, {"score_size": 16, "total_stride": 16}, seed=0)

        def loader(ds, workers=WORKERS):
            return BatchLoader(ds, B, num_workers=workers, seed=0)

        def loader_alone(ds) -> float:
            t0 = time.perf_counter()
            n = sum(1 for _ in loader(ds))
            return (time.perf_counter() - t0) * 1e3 / n

        out["loader_alone_ms"] = loader_alone(dataset)
        host = list(loader(dataset))
        staged = next(prefetch_to_device(iter(host[:1]), dev))
        for _ in range(WARMUP):
            state, m = step(state, dict(staged))
        torch.cuda.synchronize()

        def way(name, batches):
            nonlocal state
            call, read, period, cpu = [], [], [], []
            start = last = time.perf_counter()
            for batch in prefetch_to_device(batches, dev):
                if len(call) >= 2 and time.perf_counter() - start > WAY_SECONDS:
                    break
                c0, t0 = time.thread_time(), time.perf_counter()
                state, m = step(state, batch)
                t1, c1 = time.perf_counter(), time.thread_time()
                cpu.append(c1 - c0)
                values = torch.stack([m[k].float() for k in _SCALARS]).cpu()
                t2 = time.perf_counter()
                assert bool(torch.isfinite(values).all()), values
                call.append(t1 - t0)
                read.append(t2 - t1)
                period.append(t2 - last)
                last = t2
            rec = {"way": name, "first_call_ms": call[0] * 1e3, "first_period_ms": period[0] * 1e3,
                   "call_ms": _stats(call[1:]), "read_ms": _stats(read[1:]), "period_ms": _stats(period[1:]),
                   "calls_ms": [c * 1e3 for c in call]}
            slow_at = 2 * (ways[0]["call_ms"]["median"] if ways else float("inf")) / 1e3
            slow = [i for i, c in enumerate(call) if c > slow_at]
            rec["fast_cpu_ms"] = _stats([cpu[i] for i in range(len(call)) if i not in slow] or [0.0])
            if slow:
                wall, slow_cpu = sum(call[i] for i in slow), sum(cpu[i] for i in slow)
                rec["slow_calls"] = {"count": len(slow), "wall_ms": wall * 1e3, "cpu_ms": slow_cpu * 1e3}
                print(f"[loop_timing] {name}: {len(slow)} slow step calls, {wall * 1e3:.1f} ms of wall, the main "
                      f"thread's CPU {slow_cpu * 1e3:.1f} ms (the other calls' median "
                      f"{rec['fast_cpu_ms']['median']:.1f} ms each) [{card}]", flush=True)
            print(f"[loop_timing] {name}: step call {rec['call_ms']['median']:.1f} ms "
                  f"({rec['call_ms']['min']:.1f}-{rec['call_ms']['max']:.1f}; first {rec['first_call_ms']:.1f}), "
                  f"read {rec['read_ms']['median']:.1f} ms, step to step {rec['period_ms']['median']:.1f} ms "
                  f"({rec['period_ms']['min']:.1f}-{rec['period_ms']['max']:.1f}) [{card}]", flush=True)
            return rec

        def with_hogs(kind, n):
            stop = threading.Event()
            hogs = [threading.Thread(target=_hog, args=(kind, stop), daemon=True) for _ in range(n)]
            for t in hogs:
                t.start()
            try:
                return way(f"{kind}_hogs", iter(host))
            finally:
                stop.set()
                for t in hogs:
                    t.join()

        def with_switch():
            default = sys.getswitchinterval()
            sys.setswitchinterval(5e-4)
            try:
                return way("switch", iter(loader(dataset)))
            finally:
                sys.setswitchinterval(default)

        def with_processes(n):
            code = ("import sys, torch; torch.set_num_threads(1); a = torch.randn(384, 384); print(flush=True)\n"
                    "while True: torch.mm(a, a)")
            procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE) for _ in range(n)]
            try:
                for p in procs:
                    p.stdout.readline()  # its loop has started
                return way("process_hogs", iter(host))
            finally:
                for p in procs:
                    p.kill()
                    p.wait()

        runs = {
            "stopped": lambda: way("stopped", iter(host)),
            "running": lambda: way("running", iter(loader(dataset))),
            "one_thread": lambda: way("one_thread", iter(loader(_OneThread(dataset)))),
            "one_thread_fewer": lambda: way("one_thread_fewer",
                                            iter(loader(_OneThread(dataset), WORKERS - 1))),
            "switch": with_switch,
            "core_hogs": lambda: with_hogs("core", WORKERS),
            "gil_hogs": lambda: with_hogs("gil", 1),
            "process_hogs": lambda: with_processes(WORKERS),
        }
        ways: list = []
        for name in ["stopped"] + [w for w in args.ways.split(",") if w != "stopped"]:
            ways.append(runs[name]())
        out["ways"] = ways
        out["loader_alone_one_thread_ms"] = loader_alone(_OneThread(dataset))
        out["intra_op_threads_main_after"] = torch.get_num_threads()

    print(f"[loop_timing] loader alone a batch of {B} on {WORKERS} threads: {out['loader_alone_ms']:.1f} ms, "
          f"at one intra-op thread each {out['loader_alone_one_thread_ms']:.1f} ms; main thread's intra-op "
          f"threads {main_threads} → {out['intra_op_threads_main_after']} ({out['parallel_backend']}) [{card}]")
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
