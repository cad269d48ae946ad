"""Shared setup for runs of the tracking path: a ScanTracker with the
packaged FEAR-XS weights over S synthetic 256×480 streams (the counterpart
of ``feartracker_tpu/evaluate/harness.py``)."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from feartracker_tpu_torch.convert.load import (
    PACKAGED_FEAR_XS,
    load_fear_net,
    resolve_weights,
    variables_from_npz,
)
from feartracker_tpu_torch.models.fear_net import build_family_model
from feartracker_tpu_torch.tracker.runtime import ScanTracker

DEMO_BBOX = (163.0, 53.0, 45.0, 174.0)  # the demo's default initial box


def build_scan_tracker(
    weights_path: str = PACKAGED_FEAR_XS,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    model_name: str = "fear_xs",
    towernum: int = 2,
    **tracker_kw,
) -> Tuple[ScanTracker, str]:
    """(ScanTracker, weights_provenance). ``weights_path`` is an ``.npz``
    archive or a bare zoo name ("fear_xs_gate"); ``model_name`` picks the
    family trunk; ``tracker_kw`` go to :class:`ScanTracker` (e.g.
    ``dynamic_template``, ``update_mode``, ``gate_params``). Provenance is
    "fear_xs" when the packaged ``fear_xs.npz`` loaded, else the weights
    file's basename. A load failure raises: there is no random-weights
    fallback."""
    weights_path = resolve_weights(weights_path)
    model = build_family_model(model_name, towernum=towernum)
    load_fear_net(model, variables_from_npz(weights_path))
    same = os.path.exists(PACKAGED_FEAR_XS) and os.path.samefile(weights_path, PACKAGED_FEAR_XS)
    provenance = "fear_xs" if same else os.path.basename(weights_path)
    return ScanTracker(model, dtype=dtype, device=device, **tracker_kw), provenance


def synthetic_streams(
    streams: int,
    chunk: int,
    frame_hw: Tuple[int, int] = (256, 480),
    seed: int = 0,
    device="cpu",
):
    """(frames0 (S,H,W,3) u8, chunk (T,S,H,W,3) u8, bboxes (S,4) f32) on
    ``device``: the same pixels as the JAX harness for the same seed. Every
    stream sees the same random video (throughput is data-independent); the
    stream axis is an expanded view, stored once."""
    rng = np.random.RandomState(seed)
    H, W = frame_hw
    video = torch.from_numpy(rng.randint(0, 255, (chunk + 1, H, W, 3), dtype=np.uint8)).to(device)
    frames0 = video[0].expand(streams, H, W, 3)
    chunk_frames = video[1:, None].expand(chunk, streams, H, W, 3)
    bboxes = torch.tensor([DEMO_BBOX], dtype=torch.float32, device=device).repeat(streams, 1)
    return frames0, chunk_frames, bboxes
