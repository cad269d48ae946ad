"""K2's time per FEAR-XS block beside its plain twin: bfloat16 at S=128 and S=1, or float32 at S=1.

Times ``fused_ir_block`` and ``plain_ir_block`` of the ``feartracker_tpu_torch``
found under ``--root`` (default: this checkout) on the packaged FEAR-XS
weights folded in ``--dtype`` (bfloat16, the default, at S=128 and S=1;
float32, the sequential tracker's precision, at S=1), at every block with
expansion > 1, at the search (256²) and template (128²) crops. Two timers,
both CUDA events around a run of calls:

* ``device``: ``evaluate/profiling.py:time_ms`` of this checkout (loaded
  by path, whatever ``--root`` holds), whose calls a spin kernel holds back
  until the host has queued them all, so it reads device time;
* ``queued``: events around calls queued back to back as the host issues
  them, so a gap the host leaves between two launches counts too.

Pointing ``--root`` at an unpacked older commit times that commit's kernel
with the same timers, so two versions compare in one call on one card::

    git archive HEAD | tar -x -C _scratch/parent
    python3 k2_timing.py --root _scratch/parent --dtype float32
    python3 k2_timing.py --dtype float32

Needs one CUDA card and ``nvcc``; the kernels build under ``--root`` at first
use. Prints one line per block, the card's name and power limit, and last one
JSON object of the sums.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    """``chip_smoke.py`` beside this script, loaded by path (``--root`` may
    hold another one)."""
    spec = importlib.util.spec_from_file_location("_k2_timing_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_timer():
    """``time_ms`` of this checkout's ``evaluate/profiling.py``, loaded by
    path, so that two checkouts are timed by one timer."""
    path = HERE / "feartracker_tpu_torch" / "evaluate" / "profiling.py"
    spec = importlib.util.spec_from_file_location("_timing_profiling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.time_ms


def _queued_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose feartracker_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("k2_timing: no CUDA card", file=sys.stderr)
        return 1
    import feartracker_tpu_torch

    if not Path(feartracker_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"feartracker_tpu_torch imported from {feartracker_tpu_torch.__file__}, not {root}")
    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, device_line
    from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK
    from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block
    from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block

    smoke, device_ms = _smoke(), _device_timer()
    card = device_line("cuda")
    dt = getattr(torch, args.dtype)
    if dt == torch.float32:  # f32 means f32: no TF32 in the twin's convolutions
        torch.backends.cudnn.allow_tf32 = False
    tracker, prov = build_scan_tracker(dtype=dt, device="cuda")
    if prov != "fear_xs":
        raise AssertionError(f"weights provenance {prov!r}, expected fear_xs")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    sums = {}
    for S, iters in ((128, 20), (1, 50)) if dt == torch.bfloat16 else ((1, 50),):
        for crop in (256, 128):
            tot = {"device_ms": 0.0, "queued_ms": 0.0, "plain_device_ms": 0.0, "plain_queued_ms": 0.0}
            for i, spec, cin, h in smoke._block_shapes(FEAR_XS_TRUNK, crop):
                if spec.expansion == 1:
                    continue
                blk = tracker.folded["blocks"][i]
                x = torch.randn(S, h, h, cin, generator=gen, device="cuda").to(dt)
                got, want = fused_ir_block(x, blk, spec).float(), plain_ir_block(x, blk, spec).float()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"K2 block{i} S={S} crop {crop}: non-finite output")
                err, mag = (got - want).abs().max().item(), want.abs().max().item()
                kern, plain = (lambda: fused_ir_block(x, blk, spec)), (lambda: plain_ir_block(x, blk, spec))
                row = {"device_ms": device_ms(kern, iters=iters), "queued_ms": _queued_ms(kern, iters),
                       "plain_device_ms": device_ms(plain, iters=iters),
                       "plain_queued_ms": _queued_ms(plain, iters)}
                for key in tot:
                    tot[key] += row[key]
                print(f"K2 block{i:2d} S={S} x ({S},{h},{h},{cin}) {args.dtype}: max|err| {err:.3e} of max|out| {mag:.3e}; "
                      f"kernel {row['device_ms']:.4f} ms device, {row['queued_ms']:.4f} queued; plain "
                      f"{row['plain_device_ms']:.4f} device, {row['plain_queued_ms']:.4f} queued", flush=True)
            sums[f"S{S}_{crop}"] = tot
            print(f"K2 sum S={S} {crop}² {args.dtype}: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) + f" [{card}]",
                  flush=True)
    print(card)
    print(json.dumps({"root": str(root), "dtype": args.dtype, "card": card, "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
