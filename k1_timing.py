"""K1's time: the batched step's decode region and the decode alone, beside the card's launch floor.

Times the decode region of ``ScanTracker.step`` as the ``feartracker_tpu_torch``
found under ``--root`` (default: this checkout) runs it: one
``decode_step_cuda`` launch where the checkout has it, else the checkout's
own sequence (the head's outputs cast to contiguous float32, the prev size
from ``crop_bbox_in_window``, ``postprocess_cuda``, ``rescale_crop_bbox``,
``clamp_bbox`` and the APCE of the sigmoid map). Cells: the region at S=128
with bfloat16 head outputs (the bench's step) and at S=1 in float32; the
decode alone (``postprocess_cuda`` on contiguous float32 maps, the
sequential tracker's call) at S=1 and S=128; and an empty kernel (torch's
spin kernel asked for 0 cycles) back to back, the card's launch floor. Two
timers, as in ``k2_timing.py``, both CUDA events around a run of calls:

* ``device``: ``evaluate/profiling.py:time_ms`` of this checkout (loaded
  by path, whatever ``--root`` holds), whose calls a spin kernel holds back
  until the host has queued them all, so it reads device time
  (runs of 10 calls, averaged over 20 runs: see :func:`_device_ms`);
* ``queued``: events around calls queued back to back as the host issues
  them, so a gap the host leaves between two launches counts too.

The inputs are made with numpy from ``--seed`` (``chip_smoke.py``'s
``_k1_region_inputs``, random streams only), so two checkouts see the same
ones; each cell also prints sums of its outputs, which equal across
checkouts when the two compute the same boxes. Pointing ``--root`` at an
unpacked older commit compares two versions in one call on one card::

    git archive HEAD | tar -x -C _scratch/parent
    python3 k1_timing.py --root _scratch/parent
    python3 k1_timing.py

Needs one CUDA card and ``nvcc``; the kernels build under ``--root`` at first
use. Prints one line per cell, the card's name and power limit, and last one
JSON object of the times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _beside(name: str):
    """A script beside this one, loaded by path (``--root`` may hold another)."""
    spec = importlib.util.spec_from_file_location(f"_k1_timing_{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(time_ms, fn, calls: int = 10, reps: int = 20) -> float:
    """Device ms per call: ``time_ms`` over runs of ``calls`` calls, few
    enough that an op sequence's ≈70 launches a call stay under the ≈1021
    launches the card queues before the host blocks (past that the spin
    ends before the host has queued the run, and host gaps count again),
    averaged over ``reps`` runs."""
    return sum(time_ms(fn, iters=calls, warmup=1) for _ in range(reps)) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose feartracker_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200, help="calls per run of the queued timer")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("k1_timing: no CUDA card", file=sys.stderr)
        return 1
    import feartracker_tpu_torch

    if not Path(feartracker_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"feartracker_tpu_torch imported from {feartracker_tpu_torch.__file__}, not {root}")
    from feartracker_tpu_torch.core import postprocess as pp
    from feartracker_tpu_torch.core.geometry import clamp_bbox, rescale_crop_bbox
    from feartracker_tpu_torch.evaluate.harness import device_line
    from feartracker_tpu_torch.ops.crop import crop_bbox_in_window
    from feartracker_tpu_torch.ops.cuda import decode as k1

    smoke, k2 = _beside("chip_smoke"), _beside("k2_timing")
    queued_ms, time_ms = k2._queued_ms, k2._device_timer()
    dev = torch.device("cuda")
    card = device_line(dev)
    cfg = pp.PostprocessConfig()
    hw = smoke.K1_FRAME_HW
    fused = hasattr(k1, "decode_step_cuda")

    def region_fn(cls, reg, state, windows):
        if fused:
            return lambda: k1.decode_step_cuda(cls, reg, cfg, state, windows, hw)

        def sequence():  # the step's region before K1 took it
            c, r = cls.float().contiguous(), reg.float().contiguous()
            prev = crop_bbox_in_window(state, windows, cfg.instance_size)[:, 2:].contiguous()
            res = k1.postprocess_cuda(c, r, cfg, prev_size=prev)
            bbox = clamp_bbox(rescale_crop_bbox(res.bbox, windows, cfg.instance_size), hw)
            return res, bbox, pp.apce(torch.sigmoid(c[..., 0]))
        return sequence

    cells = {}
    for what, S, dtype in (("region", 128, torch.bfloat16), ("region", 1, torch.float32),
                           ("decode", 1, torch.float32), ("decode", 128, torch.float32)):
        batch = smoke._k1_region_inputs(max(S, 8), dtype, dev, seed=args.seed)
        cls, reg, state, windows = (t[-S:].contiguous() for t in batch)  # random streams only
        sums = {}
        if what == "region":
            fn = region_fn(cls, reg, state, windows)
            res, bbox, apce = fn()
            sums.update(frame=bbox.sum().item(), apce=apce.sum().item())
        else:
            prev = state[:, 2:] * 4.0
            fn = lambda: k1.postprocess_cuda(cls, reg, cfg, prev_size=prev)  # noqa: E731
            res = fn()
        sums.update(crop=res.bbox.sum().item(), coords=int(res.pred_coords.sum().item()))
        name = f"{what} S={S} {str(dtype)[6:]}"
        cells[name] = {"device_ms": _device_ms(time_ms, fn), "queued_ms": queued_ms(fn, args.iters),
                       "sums": sums}
        print(f"K1 {name} ({'one launch' if fused or what == 'decode' else 'the op sequence'}): "
              f"{cells[name]['device_ms']:.6f} ms device, {cells[name]['queued_ms']:.6f} ms queued; output sums "
              f"{sums} [{card}]", flush=True)
    floor = {"device_ms": _device_ms(time_ms, lambda: torch.cuda._sleep(0)),
             "queued_ms": queued_ms(lambda: torch.cuda._sleep(0), args.iters)}
    print(f"launch floor (empty kernel): {floor['device_ms']:.6f} ms device, {floor['queued_ms']:.6f} ms queued "
          f"[{card}]", flush=True)
    print(card)
    print(json.dumps({"root": str(root), "fused_region": fused, "card": card, "cells": cells, "floor": floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
