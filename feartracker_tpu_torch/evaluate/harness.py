"""Shared setup for runs of the tracking path: a ScanTracker with the
packaged FEAR-XS weights over S synthetic 256×480 streams (the counterpart
of ``feartracker_tpu/evaluate/harness.py``)."""

from __future__ import annotations

import os
import subprocess
import time
from typing import Tuple

import numpy as np
import torch

from feartracker_tpu_torch.convert.load import (
    PACKAGED_FEAR_XS,
    load_fear_net,
    load_variables,
    resolve_weights,
)
from feartracker_tpu_torch.models.fear_net import build_family_model
from feartracker_tpu_torch.tracker.runtime import ScanTracker

DEMO_BBOX = (163.0, 53.0, 45.0, 174.0)  # the demo's default initial box
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}  # a tool's --dtype


def load_model(weights_path: str = PACKAGED_FEAR_XS, model_name: str = "fear_xs", towernum: int = 2):
    """(float32 family model with the weights loaded, weights_provenance).
    ``weights_path`` is anything ``convert/load.py:load_variables`` reads:
    an ``.npz`` archive, a bare zoo name ("fear_xs_gate"), an Orbax
    checkpoint of the JAX trainer (a directory), a ``.ckpt`` or an
    ``.mlmodel``; provenance is "fear_xs" when the packaged ``fear_xs.npz``
    loaded, else the weights path's basename. A load failure raises: there
    is no random-weights fallback."""
    weights_path = resolve_weights(weights_path)
    model = build_family_model(model_name, towernum=towernum)
    load_fear_net(model, load_variables(weights_path, towernum=towernum))
    same = os.path.exists(PACKAGED_FEAR_XS) and os.path.samefile(weights_path, PACKAGED_FEAR_XS)
    return model, "fear_xs" if same else os.path.basename(weights_path)


def build_scan_tracker(
    weights_path: str = PACKAGED_FEAR_XS,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    model_name: str = "fear_xs",
    towernum: int = 2,
    **tracker_kw,
) -> Tuple[ScanTracker, str]:
    """(ScanTracker, weights_provenance) over :func:`load_model`'s model;
    ``tracker_kw`` go to :class:`ScanTracker` (e.g. ``dynamic_template``,
    ``update_mode``, ``gate_params``)."""
    model, provenance = load_model(weights_path, model_name, towernum)
    return ScanTracker(model, dtype=dtype, device=device, **tracker_kw), provenance


def bench_device() -> torch.device:
    """Where the bench and the throughput tools run: the card, unless
    ``BENCH_DEVICE`` names another device (``cpu`` in the tests)."""
    return torch.device(os.environ.get("BENCH_DEVICE", "cuda"))


def tool_device(name=None) -> torch.device:
    """Where a tool runs: its ``--device`` if given, else
    :func:`bench_device`. The card on a host without one raises: no tool
    carries on on the CPU."""
    device = torch.device(name) if name else bench_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"asked for {device}, but torch.cuda.is_available() is False on this host "
                           "(pass --device cpu to run on the CPU)")
    return device


def sync(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_track_calls(tracker: ScanTracker, state, chunk, warmup: int, timed: int, repeats: int):
    """The bench protocol's loop: ``warmup`` (at least one) ``track`` calls
    on ``chunk``, then ``repeats`` passes of ``timed`` calls, each pass
    closed by a device sync. → (state, the last call's outputs, seconds per
    pass)."""
    out = None
    for _ in range(max(warmup, 1)):
        state, out = tracker.track(state, chunk)
    sync(tracker.device)
    elapsed = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(timed):
            state, out = tracker.track(state, chunk)
        sync(tracker.device)
        elapsed.append(time.perf_counter() - t0)
    return state, out, elapsed


def device_line(device) -> str:
    """What a measurement runs on, printed beside its numbers: the card's
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line
    (a card below its maximum power limit runs slower under load), or
    ``cpu`` for a CPU run, whose times are no device metric."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def power_limit_w(card_line: str):
    """The power limit in watts from :func:`device_line`'s ``name, limit``
    line; None for a CPU run."""
    return None if card_line == "cpu" else float(card_line.rsplit(",", 1)[1].split()[0])


def rate_key(name: str, device) -> str:
    """The key a rate is printed under: ``name`` on the card, ``name_on_cpu``
    for a CPU run, whose rates are no device metric."""
    return name if torch.device(device).type == "cuda" else f"{name}_on_cpu"


def synthetic_streams(
    streams: int,
    chunk: int,
    frame_hw: Tuple[int, int] = (256, 480),
    seed: int = 0,
    device="cuda",
):
    """(frames0 (S,H,W,3) u8, chunk (T,S,H,W,3) u8, bboxes (S,4) f32) on
    ``device`` (default the card, like every entry point of the port; a
    tracker fed CPU frames copies them to the card on every call, and
    ``.to`` makes the S copies of an expanded view real): the same pixels as
    the JAX harness for the same seed. Every stream sees the same random
    video (throughput is data-independent); the stream axis is an expanded
    view, stored once."""
    rng = np.random.RandomState(seed)
    H, W = frame_hw
    video = torch.from_numpy(rng.randint(0, 255, (chunk + 1, H, W, 3), dtype=np.uint8)).to(device)
    frames0 = video[0].expand(streams, H, W, 3)
    chunk_frames = video[1:, None].expand(chunk, streams, H, W, 3)
    bboxes = torch.tensor([DEMO_BBOX], dtype=torch.float32, device=device).repeat(streams, 1)
    return frames0, chunk_frames, bboxes
