#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this checkout; imports nothing of JAX or
of ``feartracker_tpu``. Phases, each printing its own lines:

1. the card: ``nvidia-smi`` name and power limit;
2. build both kernels from ``feartracker_tpu_torch/csrc`` (seconds, ptxas);
3. K1 (fused decode) against its plain twin on the card, S=128, both
   ``smooth`` modes and a tie-break case;
4. K2 (fused inverted-residual block) against its plain twin on the card,
   every FEAR-XS block with expansion > 1 at its search (256²) and template
   (128²) shapes, S=8, in float32 and bfloat16; then every such block of
   the FEAR-M and FEAR-L trunks at both shapes, S=2;
5. the tracking slice with the packaged ``fear_xs.npz``: float32 at S=4,
   T=8 against the same port on the CPU; then bfloat16 at S=128, T=16, with
   the kernels' launch counts over ``init`` + one ``track`` and the time per
   ``track`` call;
6. each kernel's time beside its plain twin at the main path's shapes.

Then one JSON line of kernels and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def _random_block(gen, cin, spec, dtype, device):
    """Folded block weights at fan-in scale (unit-scale activations)."""
    import torch

    ce, k, cout = cin * spec.expansion, spec.kernel, spec.out_channels

    def mk(*shape, fan_in=1, dt=torch.float32):
        w = torch.randn(*shape, generator=gen, device=device) / fan_in ** 0.5
        return w.to(dt).contiguous()

    return {
        "expand": None if spec.expansion == 1 else {"w": mk(cin, ce, fan_in=cin, dt=dtype), "b": mk(ce) * 0.1},
        "dw": {"w": mk(k, k, ce, fan_in=k * k), "b": mk(ce) * 0.1},
        "project": {"w": mk(ce, cout, fan_in=ce, dt=dtype), "b": mk(cout) * 0.1},
    }


def _block_shapes(specs, crop: int):
    """(block index, spec, Cin, H) of every block, for a crop² input."""
    h, cin, out = crop // 2, 16, []
    for i, spec in enumerate(specs):
        out.append((i, spec, cin, h))
        h //= spec.stride
        cin = spec.out_channels
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False  # cuDNN convs run TF32 by default
    torch.backends.cuda.matmul.allow_tf32 = False
    from feartracker_tpu_torch.core import postprocess as pp
    from feartracker_tpu_torch.evaluate.harness import build_scan_tracker, synthetic_streams
    from feartracker_tpu_torch.models.fbnet import FEAR_XS_TRUNK, TRUNKS
    from feartracker_tpu_torch.ops.cuda import build as kbuild
    from feartracker_tpu_torch.ops.cuda.decode import postprocess_cuda
    from feartracker_tpu_torch.ops.cuda.ir_block import fused_ir_block
    from feartracker_tpu_torch.ops.fused_trunk import plain_ir_block

    dev = torch.device("cuda")
    card = _card_line()
    print(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # -- 2: build -------------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.load_library()
    print(f"[2] built {[p.name for p in kbuild.sources()]} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (kbuild.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[2]   " + line.strip())

    # -- 3: K1 against pp.postprocess -------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    S = 128
    reg = torch.rand(S, 16, 16, 4, generator=gen, device=dev) * 40 + 4
    logits = torch.randn(S, 16, 16, 1, generator=gen, device=dev)
    prev = torch.rand(S, 2, generator=gen, device=dev) * 60 + 20
    tie = torch.full((S, 16, 16, 1), -5.0, device=dev)
    tie[:, 4, 9, 0] = 3.0
    tie[:, 11, 2, 0] = 3.0
    k1_err = 0.0
    for name, cls_in, smooth in (("plain", logits, False), ("smooth", logits, True), ("tie", tie, False)):
        cfg = pp.PostprocessConfig(smooth=smooth)
        ref = pp.postprocess(cls_in, reg, cfg, prev_size=prev)
        got = postprocess_cuda(cls_in, reg, cfg, prev_size=prev)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.bbox, ref.bbox, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got.confidence, ref.confidence, rtol=1e-5, atol=1e-6)
        if not torch.equal(got.pred_coords, ref.pred_coords):
            raise AssertionError(f"K1 {name}: coords differ from the plain twin")
        if name == "tie" and not (got.pred_coords == torch.tensor([4, 9], device=dev, dtype=torch.int32)).all():
            raise AssertionError("K1 tie: not the row-major first match")
        err = (got.bbox - ref.bbox).abs().max().item()
        k1_err = max(k1_err, err)
        print(f"[3] K1 {name:6s} S={S}: bbox max|err| {err:.3e}, coords exact", flush=True)

    # -- 4: K2 against plain_ir_block -------------------------------------------
    tol = {torch.float32: 1e-4, torch.bfloat16: 0.15}
    k2_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checked = 0
    # FEAR-XS at S=8; the family trunks at S=2 add ragged chunks (Ce=108),
    # padded widths (Cin=36) and Cout up to 224 (the bfloat16 kernel's limit)
    for name, streams in (("fear_xs", 8), ("fear_m", 2), ("fear_l", 2)):
        for crop in (256, 128):
            for i, spec, cin, h in _block_shapes(TRUNKS[name], crop):
                if spec.expansion == 1:
                    continue
                for dt in (torch.float32, torch.bfloat16):
                    blk = _random_block(gen, cin, spec, dt, dev)
                    x = torch.randn(streams, h, h, cin, generator=gen, device=dev).to(dt)
                    ref = plain_ir_block(x, blk, spec).float()
                    got = fused_ir_block(x, blk, spec).float()
                    torch.cuda.synchronize()
                    err = (got - ref).abs().max().item()
                    if not err <= tol[dt]:
                        raise AssertionError(f"K2 {name} block{i} crop {crop} {dt}: max|err| {err} > {tol[dt]}")
                    k2_err[dt] = max(k2_err[dt], err)
                    n_checked += 1
            print(f"[4] K2 {name} crop {crop}: every block with expansion > 1 ok (S={streams})", flush=True)
    print(f"[4] K2 {n_checked} checks: max|err| f32 {k2_err[torch.float32]:.3e} (atol 1e-4), "
          f"bf16 {k2_err[torch.bfloat16]:.3e} (atol 0.15)", flush=True)

    # -- 5a: the slice, f32 on the card against the port on the CPU ------------
    n_fused = sum(s.expansion > 1 for s in FEAR_XS_TRUNK)
    f0, chunk, boxes = synthetic_streams(4, 8, seed=0)
    results = {}
    for device in ("cuda", "cpu"):
        tracker, prov = build_scan_tracker(dtype=torch.float32, device=device)
        if prov != "fear_xs":
            raise AssertionError(f"weights provenance {prov!r}, expected fear_xs")
        state = tracker.init(f0, boxes)
        _, out = tracker.track(state, chunk)
        results[device] = {k: v.cpu() for k, v in out.items()}
    box_err = (results["cuda"]["bbox"] - results["cpu"]["bbox"]).abs().max().item()
    conf_err = (results["cuda"]["confidence"] - results["cpu"]["confidence"]).abs().max().item()
    if not (box_err <= 1.0 and conf_err <= 1e-3):
        raise AssertionError(f"slice f32 cuda vs cpu: bbox {box_err} px, confidence {conf_err}")
    print(f"[5] slice f32 S=4 T=8 cuda vs cpu: bbox max|err| {box_err} px (<= 1), "
          f"confidence {conf_err:.2e} (<= 1e-3)", flush=True)

    # -- 5b: the main path, bf16, S=128, T=16 ----------------------------------
    S, T = 128, 16
    tracker, _ = build_scan_tracker(dtype=torch.bfloat16, device="cuda")
    f0, chunk, boxes = synthetic_streams(S, T, seed=1, device="cuda")
    torch.cuda.synchronize()
    postprocess_cuda.launches = 0
    fused_ir_block.launches = 0
    state = tracker.init(f0, boxes)
    k2_init = fused_ir_block.launches
    state, out = tracker.track(state, chunk)
    torch.cuda.synchronize()
    launches = {"K1": postprocess_cuda.launches, "K2": fused_ir_block.launches}
    if k2_init != n_fused or launches != {"K1": T, "K2": n_fused * (T + 1)}:
        raise AssertionError(f"launch counts {launches} (init K2 {k2_init}); expected K1 {T}, "
                             f"K2 {n_fused} at init + {n_fused}*{T}")
    for k, v in out.items():
        if v.shape[:2] != (T, S):
            raise AssertionError(f"output {k}: shape {tuple(v.shape)}")
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"output {k} has non-finite values")
    for _ in range(2):
        state, out = tracker.track(state, chunk)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        state, out = tracker.track(state, chunk)
    torch.cuda.synchronize()
    track_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"[5] slice bf16 S={S} T={T}: launches {launches} over init + 1 track; finite outputs; "
          f"{track_ms:.2f} ms/track, {S * T / track_ms * 1e3:.1f} frames/s [{card}]", flush=True)

    # -- 6: kernels beside their plain twins at the main path's shapes ---------
    cfg = tracker.config.postprocess
    cls_m, reg_m = logits.contiguous(), reg.contiguous()
    k1_ms = _time_ms(lambda: postprocess_cuda(cls_m, reg_m, cfg, prev_size=prev), iters=200)
    k1_plain = _time_ms(lambda: pp.postprocess(cls_m, reg_m, cfg, prev_size=prev), iters=200)
    print(f"[6] K1 S=128: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms [{card}]", flush=True)
    k2_ms = k2_plain = 0.0
    for i, spec, cin, h in _block_shapes(FEAR_XS_TRUNK, 256):
        if spec.expansion == 1:
            continue
        blk = tracker.folded["blocks"][i]
        x = torch.randn(128, h, h, cin, generator=gen, device=dev).to(torch.bfloat16)
        km = _time_ms(lambda: fused_ir_block(x, blk, spec))
        pm = _time_ms(lambda: plain_ir_block(x, blk, spec))
        k2_ms += km
        k2_plain += pm
        print(f"[6] K2 block{i:2d} x (128,{h},{h},{cin}) bf16 {spec}: kernel {km:.3f} ms, "
              f"plain {pm:.3f} ms", flush=True)
    print(f"[6] K2 sum over {n_fused} blocks, search crop, S=128 bf16: kernel {k2_ms:.3f} ms, "
          f"plain {k2_plain:.3f} ms [{card}]", flush=True)

    kernels = [
        {"name": "K1 fused decode", "route": "cuda", "source": "feartracker_tpu_torch/csrc/decode.cu",
         "replaces": "feartracker_tpu/ops/pallas/decode.py:27", "launches": launches["K1"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 fused inverted-residual block", "route": "cuda",
         "source": "feartracker_tpu_torch/csrc/ir_block.cu",
         "replaces": "feartracker_tpu/ops/pallas/ir_block.py:131", "launches": launches["K2"],
         "max_abs_err": k2_err[torch.float32], "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
