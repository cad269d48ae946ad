"""Stream-sharded tracking, the counterpart of
``feartracker_tpu/parallel/inference.py``.

Streams are independent (per-stream state, no cross-stream math), so
spreading the multi-stream runtime over several devices is data parallelism
over the stream axis with no collective. JAX shards the state and frames of
one ``ScanTracker`` over a mesh and lets XLA partition the scan; the port
holds one :class:`ScanTracker` replica a device, each with its own copy of
the folded weights (K2's packed bf16 weights included), its own CUDA-graph
capture stream and so its own K2 f32 ticket buffer. Every shard runs K1 and
K2 like any ``ScanTracker``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.parallel.mesh import make_mesh, shard_bounds
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker, StreamState


class ShardedState(tuple):
    """The carried state of a :class:`ShardedScanTracker`: one
    :class:`StreamState` a shard, in stream order, each on its shard's
    device. A field read as an attribute (``state.bbox``) is every shard's
    rows concatenated on the first shard's device, a copy."""

    def __getattr__(self, name: str) -> torch.Tensor:
        if name not in StreamState._fields:
            raise AttributeError(name)
        dev = self[0].bbox.device
        return torch.cat([getattr(s, name).to(dev) for s in self])


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ShardedScanTracker:
    """``ScanTracker`` whose S streams are split into contiguous blocks over
    ``devices`` (:func:`~feartracker_tpu_torch.parallel.mesh.make_mesh`,
    default every visible card; a device may repeat). S must divide by the
    number of devices.

    ``init``, ``step`` and ``track`` take the full frames, (S, H, W, 3) or
    (T, S, H, W, 3), and return the outputs in stream order on the first
    device; a shared (H, W, 3) / (T, H, W, 3) video (multi-object mode) goes
    whole to every device. Frames may also come already split, as one
    tensor a shard on its device (``StreamPool`` stages them so). Every
    shard's work is queued before anything waits, so the devices overlap.
    The other arguments are ``ScanTracker``'s, given to each replica;
    ``trunk_impl`` among them: both trunks run here, each replica launching
    its own kernels on its own device (JAX allows only "xla" on a sharded
    stream axis, because a Pallas call has no partitioning rule).
    """

    def __init__(self, model: FEARNet, config: TrackerConfig = TrackerConfig(), dtype: torch.dtype = torch.float32,
                 devices: Optional[Sequence] = None, **kwargs):
        self.devices = make_mesh(devices=devices)
        self.replicas = [ScanTracker(model, config, dtype=dtype, device=d, **kwargs) for d in self.devices]
        first = self.replicas[0]
        self.device, self.dtype, self.config = first.device, dtype, config
        self.template_shape = first.template_shape

    @property
    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches made by every replica's graph replays."""
        return {k: sum(r.replayed_launches[k] for r in self.replicas) for k in ("K1", "K2", "K3")}

    def set_variables(self, model: FEARNet) -> None:
        """``ScanTracker.set_variables`` on every replica."""
        for r in self.replicas:
            with _on(r.device):
                r.set_variables(model)

    def _split(self, x, num_streams: int, axis: int) -> List:
        """``x``'s contiguous stream blocks along ``axis``, one a shard."""
        n = len(self.replicas)
        blocks = []
        for i in range(n):
            lo, hi = shard_bounds(num_streams, i, n)
            blocks.append(x[lo:hi] if axis == 0 else x[:, lo:hi])
        return blocks

    def _frame_blocks(self, frames, num_streams: int, axis: int, shared_rank: int) -> List:
        """Frames as one block a shard: a list or tuple as given (already
        split), a shared video (rank ``shared_rank``) whole to each, else
        split along the stream ``axis``."""
        n = len(self.replicas)
        if isinstance(frames, (list, tuple)):
            if len(frames) != n:
                raise ValueError(f"{len(frames)} frame blocks for {n} shards")
            return list(frames)
        if frames.ndim == shared_rank:
            return [frames] * n
        return self._split(frames, num_streams, axis)

    def _gather(self, outs: List[Dict[str, torch.Tensor]], axis: int) -> Dict[str, torch.Tensor]:
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k].to(self.device) for o in outs], dim=axis) for k in outs[0]}

    def _streams(self, state) -> int:
        if not isinstance(state, ShardedState) or len(state) != len(self.replicas):
            raise ValueError("pass the ShardedState that this tracker's init returned")
        return sum(s.bbox.shape[0] for s in state)

    def init(self, frames, bboxes, mean_color=None) -> ShardedState:
        """``ScanTracker.init`` on each shard's block of streams."""
        bboxes = bboxes if isinstance(bboxes, torch.Tensor) else np.asarray(bboxes, np.float32)
        S = len(bboxes)
        frames = self._frame_blocks(frames, S, 0, shared_rank=3)
        boxes = self._split(bboxes, S, 0)
        colors = [None] * len(self.replicas)
        if mean_color is not None:
            mean_color = mean_color if isinstance(mean_color, torch.Tensor) else np.asarray(mean_color, np.float32)
            colors = self._split(mean_color, S, 0)
        states = []
        for r, f, b, c in zip(self.replicas, frames, boxes, colors):
            with _on(r.device):
                states.append(r.init(f, b, mean_color=c))
        return ShardedState(states)

    def step(self, state: ShardedState, frames, step_index: Optional[int] = None
             ) -> Tuple[ShardedState, Dict[str, torch.Tensor]]:
        frames = self._frame_blocks(frames, self._streams(state), 0, shared_rank=3)
        states, outs = [], []
        for r, s, f in zip(self.replicas, state, frames):
            with _on(r.device):
                s, o = r.step(s, f, step_index=step_index)
            states.append(s)
            outs.append(o)
        return ShardedState(states), self._gather(outs, 0)

    def track(self, state: ShardedState, frames, start_step: int = 0
              ) -> Tuple[ShardedState, Dict[str, torch.Tensor]]:
        frames = self._frame_blocks(frames, self._streams(state), 1, shared_rank=4)
        states, outs = [], []
        for r, s, f in zip(self.replicas, state, frames):
            with _on(r.device):
                s, o = r.track(s, f, start_step=start_step)
            states.append(s)
            outs.append(o)
        return ShardedState(states), self._gather(outs, 1)
