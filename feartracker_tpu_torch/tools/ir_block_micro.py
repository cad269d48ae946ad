"""Per-block microbenchmark: the fused block kernel (K2) against its plain
twin, one FEAR-XS search-path block at a time. The counterpart of
``tools/ir_block_micro.py``.

Walks FEAR-XS's search path from the stem's output (128², 16 channels).
Each block gets random folded weights and input from ``RandomState(0)``,
drawn as the JAX tool draws them (bfloat16 blocks packed by ``pack_block``,
as ``fold_fear_net`` packs them). Per block: ``plain_ms``
(``ops/fused_trunk.plain_ir_block``, the JAX tool's ``xla_ms``), and for
every block with expansion > 1, which K2 takes (``eligible``), ``fused_ms``,
``speedup``, K2's max|err| against the twin, and its bound from the H100's
published peaks (``evaluate/profiling.ir_block_bound``) with the kernel's
share of it. On the card the times are device times
(``evaluate/profiling.time_ms``: ``--inner`` × ``--timed`` calls a run, the
best of ``--repeats``); a CPU run (the tests) times the host and prints no
share.

    python -m feartracker_tpu_torch.tools.ir_block_micro --streams 128 [--blocks 4,5,8]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from feartracker_tpu_torch.evaluate.harness import DTYPES, bench_device, device_line
from feartracker_tpu_torch.evaluate.profiling import ir_block_bound, time_ms
from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK
from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block, pack_block
from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block


def block_walk(specs=FEAR_XS_TRUNK):
    """(block index, spec, H, C) of each block on the search path, from the
    stem's 128² × 16 output."""
    shapes, H, C = [], 128, 16
    for i, sp in enumerate(specs):
        shapes.append((i, sp, H, C))
        H //= sp.stride
        C = sp.out_channels
    return shapes


def random_block(rng: np.random.RandomState, C: int, sp, dtype, device) -> dict:
    """The JAX tool's draws (``randn · 0.2``, in its order) as a folded
    block: matmul weights in ``dtype``, taps and biases float32."""
    ce = C * sp.expansion

    def mk(*shape, dt=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.2).to(device=device, dtype=dt)

    blk = {
        "expand": None if sp.expansion == 1 else {"w": mk(C, ce, dt=dtype), "b": mk(ce)},
        "dw": {"w": mk(sp.kernel, sp.kernel, ce), "b": mk(ce)},
        "project": {"w": mk(ce, sp.out_channels, dt=dtype), "b": mk(sp.out_channels)},
    }
    if dtype == torch.bfloat16 and sp.expansion > 1:
        blk["packed"] = pack_block(blk, C, sp.kernel)
    return blk


def _host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--inner", type=int, default=20, help="block applications per timed dispatch")
    ap.add_argument("--timed", type=int, default=5, help="dispatches per repeat")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--blocks", default=None, help="comma list of block ids (default: all)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--force", action="store_true",
                    help="accepted for the JAX tool's command lines; changes nothing (K2 takes every block "
                         "with expansion > 1)")
    ap.add_argument("--device", default=None, help="default: BENCH_DEVICE, else the card")
    args = ap.parse_args(argv)

    device = torch.device(args.device) if args.device else bench_device()
    dtype, S = DTYPES[args.dtype], args.streams
    on_card = device.type == "cuda"
    iters = args.inner * args.timed

    def timed(fn) -> float:
        if on_card:
            return min(time_ms(fn, iters=iters) for _ in range(args.repeats))
        return min(_host_ms(fn, iters) for _ in range(args.repeats))

    print(device_line(device), flush=True)
    rng = np.random.RandomState(0)
    wanted = None if args.blocks is None else {int(b) for b in args.blocks.split(",")}
    for i, sp, H, C in block_walk():
        if wanted is not None and i not in wanted:
            continue
        blk = random_block(rng, C, sp, dtype, device)
        x = torch.from_numpy(rng.randn(S, H, H, C).astype(np.float32)).to(device=device, dtype=dtype)
        eligible = sp.expansion > 1
        row = {"block": i, "spec": list(sp), "in": f"{H}x{H}x{C}", "eligible": eligible,
               "plain_ms": timed(lambda: plain_ir_block(x, blk, sp))}
        if eligible:
            ref = plain_ir_block(x, blk, sp).float()
            got = fused_ir_block(x, blk, sp).float()
            bound, by, _ = ir_block_bound(S, H, C, sp, args.dtype)
            row["fused_ms"] = timed(lambda: fused_ir_block(x, blk, sp))
            row.update({"speedup": row["plain_ms"] / row["fused_ms"],
                        "max_abs_err": (got - ref).abs().max().item(), "max_abs_out": ref.abs().max().item(),
                        "bound_ms": bound, "bound_by": by,
                        "bound_share_pct": 100.0 * bound / row["fused_ms"] if on_card else None})
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
