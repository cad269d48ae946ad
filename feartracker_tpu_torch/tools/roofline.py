"""The whole ``ScanTracker.track`` call against the H100's published peaks,
counted from shapes. The counterpart of ``tools/roofline.py``, which reads
XLA's cost model and prices it against a TPU's peaks; here no compiler is
asked and no TPU figure is used.

**Work.** The products the step needs, whatever implements them. The
model's are counted over one plain frame of the tracker's ``step`` at S=1
on the CPU under :class:`ProductCounter`, which applies
``torch.utils.flop_counter``'s formulas at dispatch (the same total as
``FlopCounterMode``): convolutions, matrix products, the correlation's bmm;
no elementwise work, as ``evaluate/flops.py`` says, so it is no XLA count
and is not compared with one. The crop is counted by what a bilinear crop
needs, four taps a value at a multiply-add each (:func:`crop_flops`), not
by the products its implementation runs: ``crop_impl="mm"`` contracts with
dense (out, H) and (out, W) matrices of two nonzeros a row, 0.3775 GFLOP a
256×480 frame against the 1.6 MFLOP the crop needs, ``"gather"`` runs no
product and ``"kernel"`` (K3, the default) runs the taps. What the step
runs as implemented is printed apart as information
(``executed_flops_per_frame``, ``executed_crop_flops_per_frame``); it sets
no floor. The count is scaled by S·T. It is a function of the tracker's
configuration (model, dtype), not of the kernels or of ``crop_impl``: K2
and its plain twin count the same. Products are split by the unit that can
run them:

* CUDA cores, 67 TFLOP/s: the crop's taps (float32 whatever the tracker's
  dtype), every product of a float32 tracker (TF32 off), and every
  depthwise convolution;
* tensor cores, 989 TFLOP/s: bfloat16 dense products.

**Bytes** are what the call must move, each once: the frames in
(S·T·H·W·3 uint8), the model's parameters once a call in the tracker's
dtype, each stream's carried state (template features included) in and
out, and the outputs written. The unfused activation bytes per frame (each
leaf module's output of the unfolded model written once and read once, in
the tracker's dtype) are printed as information; they set no floor.

**Keys.** ``bound_ms`` = max(CUDA-core FLOPs / 67e12, tensor-core FLOPs /
989e12, bytes / 3.35e12), and ``binding_roofline`` names the largest
("cuda_core", "tensor_core" or "hbm"); ``compute_floor_ms`` is the larger
of the first two, ``hbm_floor_ms`` the third. ``mfu_pct`` = all counted
FLOPs / (ms per call × 989 TFLOP/s): the share of the card's bf16
tensor-core peak, the same work counted whatever implements it.
``hbm_util_pct`` = bytes / (ms × 3.35 TB/s); ``bound_share_pct`` =
``bound_ms`` / ms. MB are 10^6 bytes. A CPU run (``BENCH_DEVICE=cpu`` or
``--device cpu``: the tests) prints its times, its rate as ``fps_on_cpu``
and null for every share and floor.

    python -m feartracker_tpu_torch.tools.roofline --streams 128 --chunk 16 --timed 8 [--scan_unroll 4]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from feartracker_tpu_torch.evaluate.harness import (
    DTYPES,
    bench_device,
    build_scan_tracker,
    device_line,
    power_limit_w,
    rate_key,
    synthetic_streams,
    timed_track_calls,
)
from feartracker_tpu_torch.evaluate.profiling import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S

aten = torch.ops.aten
CONVOLUTIONS = (aten.convolution, aten._convolution)
BATCHED = (aten.bmm, aten.baddbmm)


class ProductCounter(TorchDispatchMode):
    """FLOPs of every op that torch's FLOP counter has a formula for: inside
    the crop (while :attr:`in_crop`) into :attr:`crop_executed`, elsewhere
    by part ("depthwise", "conv", "bmm" or "mm") and by unit ("cuda_core":
    depthwise or float32; else "tensor_core")."""

    def __init__(self):
        super().__init__()
        self.in_crop = False
        self.crop_executed = 0
        self.by_part: Dict[str, int] = defaultdict(int)
        self.by_unit: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is None:
            # a composite op (conv2d, matmul) reaches here whole under
            # inference mode: count what it decomposes into, as
            # FlopCounterMode does
            if func is not torch.ops.prim.device.default:
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        n = int(formula(*args, **kwargs, out_val=out))
        if self.in_crop:
            self.crop_executed += n
            return out
        if packet in CONVOLUTIONS:
            groups = args[8] if len(args) > 8 else kwargs.get("groups", 1)
            kind = "depthwise" if groups > 1 and groups == args[0].shape[1] else "conv"
        else:
            kind = "bmm" if packet in BATCHED else "mm"
        self.by_part[kind] += n
        f32 = out.dtype in (torch.float32, torch.float64)
        self.by_unit["cuda_core" if kind == "depthwise" or f32 else "tensor_core"] += n
        return out


def crop_flops(out_size: int, channels: int) -> int:
    """The products a bilinear ``out_size``² crop needs: four taps a value,
    a multiply-add (2 FLOPs) each."""
    return 2 * 4 * out_size * out_size * channels


def count_step(tracker, state, frames) -> Dict:
    """The products one ``tracker.step(state, frames)`` needs over its S
    streams: the model's as counted, the crop's by :func:`crop_flops`; and
    what it runs as implemented (``executed``)."""
    counter, crop = ProductCounter(), tracker._crop

    def counted_crop(*args, **kwargs):
        counter.in_crop = True
        try:
            return crop(*args, **kwargs)
        finally:
            counter.in_crop = False

    tracker._crop = counted_crop
    try:
        with counter:
            tracker.step(state, frames)
    finally:
        del tracker._crop
    model = sum(counter.by_part.values())
    needed = crop_flops(tracker.config.instance_size, frames.shape[-1]) * state.template_feats.shape[0]
    # K3's taps are no torch op, so the counter sees none of them (on the CPU
    # its twin gathers): it runs what the crop needs
    executed_crop = needed if tracker.crop_impl == "kernel" else counter.crop_executed
    return {"flops": model + needed, "by_part": {**counter.by_part, "crop": needed},
            "cuda_core": counter.by_unit["cuda_core"] + needed, "tensor_core": counter.by_unit["tensor_core"],
            "executed": model + executed_crop, "executed_crop": executed_crop}


def _nbytes(tensors) -> int:
    """Bytes of the distinct tensors (a field passed through twice counts once)."""
    return sum(t.numel() * t.element_size() for t in {id(t): t for t in tensors}.values())


def unfused_activation_bytes(model, search: torch.Tensor, template_feats: torch.Tensor) -> int:
    """Each leaf module's output of ``model.track`` written once and read
    once, in ``search``'s dtype: information, no floor."""
    itemsize, total = search.element_size(), [0]

    def hook(_module, _inputs, out):
        if isinstance(out, torch.Tensor):
            total[0] += 2 * out.numel() * itemsize

    handles = [m.register_forward_hook(hook) for m in model.modules() if not any(m.children())]
    try:
        with torch.inference_mode():
            model.track(search, template_feats)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def frame_cost(dtype: torch.dtype, crop_impl: str = "mm") -> Dict:
    """One plain frame (256×480, FEAR-XS from ``fear_xs.npz``) at S=1 on the
    CPU: :func:`count_step`'s products, the state's bytes per stream (in
    and out), the outputs' bytes per frame and stream, the weights' bytes
    and the unfused activation bytes."""
    tracker, _ = build_scan_tracker(dtype=dtype, device="cpu", crop_impl=crop_impl)
    frames0, chunk, boxes = synthetic_streams(1, 1, device="cpu")
    state = tracker.init(frames0, boxes)
    cost = count_step(tracker, state, chunk[0])
    _, out = tracker.step(state, chunk[0])
    size = tracker.config.instance_size
    search = torch.zeros((1, size, size, 3), dtype=dtype)
    return {
        **cost,
        "frame_hw": tuple(frames0.shape[1:3]),
        "weight_bytes": _nbytes(tracker.model.parameters()),
        "state_bytes": 2 * _nbytes(state),
        "output_bytes": _nbytes(out.values()),
        "activation_bytes": unfused_activation_bytes(tracker.model, search, state.template_feats),
    }


def call_bytes(cost: Dict, S: int, T: int) -> int:
    """What one ``track`` call of T frames over S streams must move."""
    H, W = cost["frame_hw"]
    return S * T * H * W * 3 + cost["weight_bytes"] + S * cost["state_bytes"] + S * T * cost["output_bytes"]


def roofline_record(cost: Dict, S: int, T: int, seconds: float, card: str) -> Dict:
    """One S's line: the measured call against the counted work; shares and
    floors null for a CPU run (``card`` == "cpu")."""
    frames = S * T
    flops, nbytes = cost["flops"] * frames, call_bytes(cost, S, T)
    cuda, tensor = cost["cuda_core"] * frames, cost["tensor_core"] * frames
    floors = {"cuda_core": cuda / F32_FLOPS * 1e3, "tensor_core": tensor / BF16_FLOPS * 1e3,
              "hbm": nbytes / HBM_BYTES_PER_S * 1e3}
    binding = max(floors, key=floors.get)
    ms = seconds * 1e3
    on_card = card != "cpu"

    def card_only(v):
        return v if on_card else None

    return {
        "S": S,
        "chunk": T,
        "ms_per_call": ms,
        rate_key("fps", "cuda" if on_card else "cpu"): frames / seconds,
        "flops_per_call": flops,
        "bytes_per_call": nbytes,
        "cuda_core_flops_per_call": cuda,
        "tensor_core_flops_per_call": tensor,
        "flops_per_frame_G": cost["flops"] / 1e9,
        "bytes_per_frame_MB": nbytes / frames / 1e6,
        "mfu_pct": card_only(100.0 * flops / seconds / BF16_FLOPS),
        "hbm_util_pct": card_only(100.0 * nbytes / seconds / HBM_BYTES_PER_S),
        "compute_floor_ms": card_only(max(floors["cuda_core"], floors["tensor_core"])),
        "hbm_floor_ms": card_only(floors["hbm"]),
        "bound_ms": card_only(floors[binding]),
        "bound_share_pct": card_only(100.0 * floors[binding] / ms),
        "binding_roofline": card_only(binding),
        "power_limit_w": power_limit_w(card),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", default="128", help="comma list of S")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--timed", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--scan_unroll", type=int, default=1, help="ScanTracker's scan_unroll (1 = eager)")
    ap.add_argument("--device", default=None, help="default: BENCH_DEVICE, else the card")
    args = ap.parse_args(argv)

    device = torch.device(args.device) if args.device else bench_device()
    dtype = DTYPES[args.dtype]
    card = device_line(device)
    print(card, flush=True)
    tracker, provenance = build_scan_tracker(dtype=dtype, device=device, scan_unroll=args.scan_unroll)
    cost = frame_cost(dtype, tracker.crop_impl)
    print(json.dumps({
        "count": "one plain step at S=1 on the CPU, per frame", "weights": provenance, "dtype": args.dtype,
        "flops_per_frame": cost["flops"], "flops_by_part_per_frame": cost["by_part"],
        "cuda_core_flops_per_frame": cost["cuda_core"], "tensor_core_flops_per_frame": cost["tensor_core"],
        "executed_flops_per_frame": cost["executed"], "executed_crop_flops_per_frame": cost["executed_crop"],
        "executed_note": "information only: the products the tracker runs as implemented (the crop's by "
                         "its crop_impl); sets no floor",
        "weight_bytes": cost["weight_bytes"], "state_bytes_per_stream": cost["state_bytes"],
        "output_bytes_per_frame_stream": cost["output_bytes"],
        "unfused_activation_bytes_per_frame_MB": cost["activation_bytes"] / 1e6,
        "unfused_activation_note": "information only: each leaf module's output written once and read once; "
                                   "sets no floor",
    }), flush=True)
    for S in [int(s) for s in args.streams.split(",")]:
        frames0, chunk, bboxes = synthetic_streams(S, args.chunk, device=device)
        state = tracker.init(frames0, bboxes)
        _, _, elapsed = timed_track_calls(tracker, state, chunk, args.warmup, args.timed, 1)
        rec = roofline_record(cost, S, args.chunk, elapsed[0] / args.timed, card)
        print(json.dumps({**rec, "scan_unroll": args.scan_unroll}), flush=True)
        del state, frames0, chunk, bboxes


if __name__ == "__main__":
    main()
