"""Training-step batch sweep: for each batch size, time the full train step
(forward in train mode, loss, in-step metrics, backward, the optimizer
update) on a fixed synthetic batch, and print one JSON line with the step
time, samples/s, the card's peak memory and the share of its peak rate the
step's convolutions and matmuls reach. The counterpart of
``tools/train_profile.py``.

    python -m feartracker_tpu_torch.tools.train_profile --batches 32,64,128 --warmup 3 --timed 20
    python -m feartracker_tpu_torch.tools.train_profile --batches 32 --trace outputs/trace_train

FEAR-XS runs ``fear_xs.npz`` at 256² search / 128² template, bfloat16, Adam
1e-4 (the training configuration's). ``flops_per_step`` is counted by
``torch.utils.flop_counter.FlopCounterMode`` over one forward and backward
at B=1 on the CPU, times B (with the depthwise convolutions' backward
counted per group: torch's formula counts it C times over); ``mfu_pct`` divides it by the H100's published
dense peak (989 TFLOP/s bfloat16, 67 TFLOP/s float32). The loss of the first
and the last step on the fixed batch are printed too: it must fall; and the
first step's wall time, which holds each new shape's first calls (cuDNN's
plans, the caching allocator's first blocks).
Times are the host's wall clock over ``--timed`` steps closed by a device
sync, per optimizer step.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import time
from typing import Dict, Tuple

import torch

from feartracker_tpu_torch.convert.load import PACKAGED_FEAR_XS, load_fear_net, variables_from_npz
from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.evaluate.harness import DTYPES, device_line, sync
from feartracker_tpu_torch.evaluate.profiling import BF16_FLOPS, F32_FLOPS
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet, build_family_model
from feartracker_tpu_torch.train.optim import build_optimizer
from feartracker_tpu_torch.train.step import (
    create_train_state,
    make_loss_and_grads,
    make_train_multistep,
    make_train_step,
)
from feartracker_tpu_torch.utils import constants as C

H100_PEAK_FLOPS = {torch.bfloat16: BF16_FLOPS, torch.float32: F32_FLOPS}
# (template side, search side, box coder) per model; "tiny" is the tests' size
GEOMETRY = {
    "tiny": (32, 64, bc.BoxCoderSpec(score_size=8, total_stride=8, instance_size=64)),
    "default": (128, 256, bc.BoxCoderSpec()),
}


def build_model(name: str, seed: int = 0) -> Tuple[FEARNet, str]:
    """(model, weights' provenance): FEAR-XS with ``fear_xs.npz``, any other
    name with torch's init seeded with ``seed``."""
    if name == "fear_xs":
        return load_fear_net(FEARNet(), variables_from_npz(PACKAGED_FEAR_XS)), "fear_xs"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if name == "tiny":
            return FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), "random"
        return build_family_model(name), "random"


def synthetic_train_batch(B: int, template: int, search: int, spec: bc.BoxCoderSpec, device,
                          seed: int = 0, aux: bool = False) -> Dict[str, torch.Tensor]:
    """A full-geometry Siamese batch made on ``device`` from a seeded
    generator: images in [0, 1), boxes inside the search crop, their label
    maps (the step's cost does not depend on the labels' contents)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.rand(shape, generator=g, device=device)  # noqa: E731
    k = search / 256.0
    boxes = torch.stack([64 + 64 * r(B), 64 + 64 * r(B), 32 + 64 * r(B), 32 + 64 * r(B)], dim=1) * k
    enc = bc.encode(boxes, spec)
    batch = {
        C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: r(B, template, template, 3),
        C.TRACKER_TARGET_SEARCH_IMAGE_KEY: r(B, search, search, 3),
        C.TRACKER_TARGET_BBOX_KEY: boxes,
        C.TARGET_CLASSIFICATION_KEY: enc.classification_label,
        C.TARGET_REGRESSION_LABEL_KEY: enc.regression_map,
        C.TARGET_REGRESSION_WEIGHT_KEY: enc.classification_label[..., 0],
        C.TARGET_VISIBILITY_KEY: torch.ones(B, 1, device=device),
    }
    if aux:
        batch[C.TRACKER_TARGET_AUX_IMAGE_KEY] = r(B, template, template, 3)
    return batch


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """FLOPs of ``aten.convolution_backward``: each gradient asked for
    (input, weight) costs what the forward did, 2·|out|·|w|/Cout. torch's
    own formula leaves out ``groups`` for the weight's gradient and counts a
    depthwise convolution's C times over."""
    output_mask = args[7]
    per_gradient = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return per_gradient * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def flops_per_sample(model: FEARNet, template: int, search: int, spec, dual: bool) -> int:
    """Convolution and matmul FLOPs of one forward and backward at B=1, on
    the CPU in float32, of a copy of ``model``."""
    from torch.utils.flop_counter import FlopCounterMode

    net = copy.deepcopy(model).cpu().float()
    batch = synthetic_train_batch(1, template, search, spec, "cpu", aux=dual)
    mapping = {torch.ops.aten.convolution_backward: _conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        make_loss_and_grads(dual_template=dual)(net, batch)
    return int(counter.get_total_flops())


def trace_steps(step, state, batch, out_dir: str, n: int = 3) -> Dict[str, object]:
    """``n`` steps under ``torch.profiler`` (``<out_dir>/trace.json``) → per
    step: the device's kernel, copy and memset rows (op rows repeat their
    kernels' time), their busy ms and span, the idle share, and convolution
    / GEMM / other ms; ``None`` for each where the trace holds no device
    rows (a CPU run)."""
    from feartracker_tpu_torch.evaluate.profiling import trace

    with trace(out_dir):
        for _ in range(n):
            state, _ = step(state, batch)
        sync(batch[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY].device)
    with open(f"{out_dir}/trace.json") as fh:
        rows = [e for e in json.load(fh)["traceEvents"] if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    rec: Dict[str, object] = {"trace": f"{out_dir}/trace.json", "traced_steps": n}
    if not rows:
        return {**rec, **dict.fromkeys(("kernels_per_step", "busy_ms_per_step", "span_ms_per_step", "idle_pct",
                                        "conv_ms_per_step", "gemm_ms_per_step", "other_ms_per_step"))}
    fam = {"conv": 0.0, "gemm": 0.0, "other": 0.0}
    for e in rows:
        name = e.get("name", "").lower()
        key = ("gemm" if ("gemm" in name or "xmma" in name or "cutlass" in name) else
               "conv" if ("conv" in name or "cudnn" in name) else "other")
        fam[key] += e.get("dur", 0) / 1e3
    busy = sum(e.get("dur", 0) for e in rows) / 1e3
    span = (max(e["ts"] + e.get("dur", 0) for e in rows) - min(e["ts"] for e in rows)) / 1e3
    return {**rec, "kernels_per_step": len(rows) / n, "busy_ms_per_step": busy / n, "span_ms_per_step": span / n,
            "idle_pct": 100.0 * (1 - busy / span), **{f"{k}_ms_per_step": v / n for k, v in fam.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", default="32,64,128")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--timed", type=int, default=20)
    ap.add_argument("--dual", action="store_true", help="profile the dual-template step")
    ap.add_argument("--scan_steps", type=int, default=1,
                    help="optimizer steps per call (make_train_multistep)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--model", default="fear_xs", help="fear_xs (fear_xs.npz), another family name, or tiny")
    ap.add_argument("--trace", default=None,
                    help="trace 3 steps at the first batch size into this directory and print their breakdown")
    args = ap.parse_args(argv)

    device, dtype = torch.device(args.device), DTYPES[args.dtype]
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_profile: CUDA is not available; pass --device cpu to run on the host")
    line = device_line(device)
    print(line, flush=True)
    template, search, spec = GEOMETRY["tiny" if args.model == "tiny" else "default"]
    model0, provenance = build_model(args.model)
    flops_1 = flops_per_sample(model0, template, search, spec, args.dual)
    K = max(1, args.scan_steps)
    for B in [int(b) for b in args.batches.split(",")]:
        tx = build_optimizer({"name": "adam", "lr": 1e-4})
        state = create_train_state(build_model(args.model)[0], tx, device=device)
        step = make_train_step(tx, spec=spec, dual_template=args.dual, dtype=dtype)
        batch = synthetic_train_batch(B, template, search, spec, device, aux=args.dual)
        if K > 1:  # the same batch at every step of a call
            step = make_train_multistep(step, K)
            batch = {k: v.expand((K,) + v.shape).contiguous() for k, v in batch.items()}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses = []
        for i in range(max(1, args.warmup)):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            if i == 0:
                losses.append(float(metrics["loss"].reshape(-1)[0]))
                first_ms = (time.perf_counter() - t0) * 1e3
        sync(device)
        t0 = time.perf_counter()
        for _ in range(args.timed):
            state, metrics = step(state, batch)
        sync(device)
        dt = (time.perf_counter() - t0) / max(1, args.timed) / K
        losses.append(float(metrics["loss"].reshape(-1)[-1]))
        flops = flops_1 * B
        peak = H100_PEAK_FLOPS[dtype]
        on_card = device.type == "cuda"
        print(json.dumps({
            "batch": B,
            "scan_steps": K,
            "model": args.model,
            "weights": provenance,
            "dtype": args.dtype,
            "dual": args.dual,
            "steps": state.step,
            "step_ms": dt * 1e3,
            "first_step_ms": first_ms,
            "samples_per_s": B / dt,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if on_card else None,
            "flops_per_step": flops,
            "mfu_pct": 100.0 * flops / dt / peak if on_card else None,
            "compute_floor_ms": 1e3 * flops / peak,
            "loss_first": losses[0],
            "loss_last": losses[-1],
            "device": line,
        }), flush=True)
        if args.trace:
            print(json.dumps({"batch": B, **trace_steps(step, state, batch, args.trace)}), flush=True)
            args.trace = None  # the first batch size only
        del state, step, batch, metrics


if __name__ == "__main__":
    main()
