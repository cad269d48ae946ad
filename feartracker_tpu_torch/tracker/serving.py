"""Serving layer: a fixed-capacity pool of live tracking streams, the
counterpart of ``feartracker_tpu/tracker/serving.py``.

  * ``add(frame, bbox)``  — claim a slot, build its template on the device
  * ``remove(slot)``      — release a slot
  * ``step(frames)``      — advance every slot one frame
  * failure policy        — what happens when a slot's confidence drops
    below the threshold:

    - ``"notify"`` (default): the slot keeps tracking and the failure flag is
      surfaced to the caller, who re-inits it with a fresh (frame, bbox).
    - ``"reinit"``: the slot re-templates itself from its current prediction
      (if the box drifted off target, this locks the failure in; use it only
      where no caller can supply a box).

All state lives in fixed-shape tensors on the tracker's device; a slot write
builds new tensors (out of place), so outputs already handed out never
change under the caller. Over a ``ShardedScanTracker`` the slots are split
into the shards' contiguous blocks: a slot's init and write go to the shard
that holds it, and each shard's block of frames is copied from one pinned
staging buffer straight to its device.

Pipelined stepping: ``step_async`` enqueues a step and returns a
``PendingStep`` at once; the pool's state advances at dispatch time. Host
frames are staged through pinned memory and copied with
``non_blocking=True`` (a copy from pageable memory would make the host wait
for every queued step); PyTorch's caching host allocator reuses a pinned
block only after its copy has completed. The outputs the host needs are copied back asynchronously
into pinned memory right after the step, and ``PendingStep.result()`` waits
for that step's event alone.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from feartracker_tpu_torch.tracker.runtime import ScanTracker, StreamState
from feartracker_tpu_torch.utils import tracing

_FETCHED = ("bbox", "confidence", "failure")


class PendingStep:
    """An in-flight ``StreamPool`` step: outputs not yet fetched.

    ``result()`` waits for the step's copies to the host and applies the
    pool's failure policy. Under ``"reinit"`` the re-template happens when
    the result is drained: with k steps in flight, k steps after the failing
    frame, from the frame the failure was detected on.
    """

    def __init__(self, pool: "StreamPool", out: Dict[str, torch.Tensor], active: np.ndarray,
                 frames: Optional[np.ndarray], done: Optional[torch.cuda.Event]):
        self._pool = pool
        self._out = out
        self._active = active
        self._frames = frames  # retained only under the "reinit" policy
        self.done = done  # recorded after the copies to the host (CUDA only)
        self._result: Optional[Dict[str, Any]] = None

    def result(self) -> Dict[str, Any]:
        if self._result is None:
            if self.done is not None:
                with tracing.span("fear.pool.wait"):
                    self.done.synchronize()
            out, self._out = self._out, None
            with tracing.span("fear.pool.drain"):
                self._result = self._pool._drain(out, self._active, self._frames)
            self._frames = None
        return self._result


class StreamPool:
    def __init__(
        self,
        tracker: ScanTracker,  # or a ShardedScanTracker
        capacity: int,
        frame_hw,
        auto_reinit: bool = False,
        failure_policy: Optional[str] = None,
    ):
        self.tracker = tracker
        self.capacity = capacity
        self.frame_hw = tuple(frame_hw)
        # failure_policy wins; auto_reinit=True is the legacy spelling of "reinit"
        policy = failure_policy or ("reinit" if auto_reinit else "notify")
        if policy not in ("notify", "reinit"):
            raise ValueError(f"failure_policy must be 'notify' or 'reinit', got {policy!r}")
        self.failure_policy = policy
        self.auto_reinit = policy == "reinit"
        self.active = np.zeros(capacity, bool)
        self._free: List[int] = list(range(capacity))
        self._step_count = 0  # paces the dual-template update_interval
        self._device = tracker.device
        self._cuda = self._device.type == "cuda"
        # a ShardedScanTracker's replicas, each holding a block of slots
        self._shards = getattr(tracker, "replicas", None)
        if self._shards is None:
            self.state = self._empty_state(capacity, self._device)
        else:
            from feartracker_tpu_torch.parallel.inference import ShardedState

            if capacity % len(self._shards):
                raise ValueError(f"capacity {capacity} does not divide over {len(self._shards)} shards")
            self._per_shard = capacity // len(self._shards)
            self.state = ShardedState(self._empty_state(self._per_shard, r.device) for r in self._shards)

    def _empty_state(self, rows: int, dev: torch.device) -> StreamState:
        with torch.inference_mode():
            feats = torch.zeros((rows,) + tuple(self.tracker.template_shape), dtype=self.tracker.dtype, device=dev)
            bbox = torch.zeros((rows, 4), dtype=torch.float32, device=dev)
            bbox[:, 2:] = 8.0
            return StreamState(
                template_feats=feats,
                dyn_feats=feats,
                bbox=bbox,
                mean_color=torch.zeros((rows, 3), dtype=torch.float32, device=dev),
                confidence=torch.zeros((rows,), dtype=torch.float32, device=dev),
            )

    # -- slot management -----------------------------------------------------

    @staticmethod
    @torch.inference_mode()
    def _written(state: StreamState, row: int, sub: StreamState) -> StreamState:
        """Row ``row`` of every state tensor ← ``sub``'s single row, out of
        place (slices, no index tensor: nothing is copied from the host)."""
        return StreamState(*(
            torch.cat([full[:row], one[:1], full[row + 1:]])
            for full, one in zip(state, sub)
        ))

    def _init_slot(self, slot: int, frame, bbox) -> None:
        box = np.asarray(bbox, np.float32)[None]
        if self._shards is None:
            self.state = self._written(self.state, slot, self.tracker.init(frame[None], box))
            return
        from feartracker_tpu_torch.parallel.inference import ShardedState

        shard, row = divmod(slot, self._per_shard)
        replica = self._shards[shard]
        with torch.cuda.device(replica.device) if replica.device.type == "cuda" else contextlib.nullcontext():
            sub = replica.init(frame[None], box)
        states = list(self.state)
        states[shard] = self._written(states[shard], row, sub)
        self.state = ShardedState(states)

    def add(self, frame: np.ndarray, bbox) -> int:
        """Claim a slot and initialize it from (frame, bbox); returns slot id."""
        if not self._free:
            raise RuntimeError(f"stream pool exhausted ({self.capacity} slots)")
        if tuple(frame.shape[:2]) != self.frame_hw:
            raise ValueError(f"frame is {tuple(frame.shape[:2])}, the pool takes {self.frame_hw}")
        slot = self._free.pop(0)
        self._init_slot(slot, frame, bbox)
        self.active[slot] = True
        return slot

    def remove(self, slot: int) -> None:
        if not self.active[slot]:
            return
        self.active[slot] = False
        self._free.append(slot)

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    # -- host → device -------------------------------------------------------

    def _stage(self, frames, chunk: bool = False):
        """Frames on the tracker's device. Host frames bound for a CUDA card
        go through pinned memory and an asynchronous copy. Over a sharded
        tracker: one block a shard on its device (the stream axis is 1 for a
        ``chunk``, else 0; a shared video goes whole to every shard), each
        copied from the one staging buffer."""
        with tracing.span("fear.pool.stage"):
            return self._staged(frames, chunk)

    def _staged(self, frames, chunk: bool):
        if isinstance(frames, torch.Tensor):
            # by type: a tracker on "cuda" gets tensors on "cuda:0"
            if frames.device.type == self._device.type:
                return self._place(frames, chunk, lambda x, dev: x.to(dev))
            frames = frames.numpy()
        frames = np.asarray(frames)
        tracing.count("pool.staged_bytes", frames.nbytes)
        if not self._cuda:
            return self._place(frames, chunk, lambda x, dev: torch.as_tensor(x, device=dev))
        # the caching host allocator hands this block out again only after
        # the copies below have completed on the card
        dtype = torch.from_numpy(np.empty(0, frames.dtype)).dtype
        if self._shards is not None and chunk and frames.ndim == 5:
            # shard-major, so that each shard's (T, S/N, ...) block is one
            # contiguous run of the buffer (a strided one would be copied
            # through pageable memory, synchronously)
            T, n = frames.shape[0], len(self._shards)
            pinned = torch.empty((n, T, self._per_shard) + frames.shape[2:], dtype=dtype, pin_memory=True)
            np.copyto(pinned.numpy(), frames.reshape((T, n, self._per_shard) + frames.shape[2:]).swapaxes(0, 1))
            return [block.to(r.device, non_blocking=True) for block, r in zip(pinned, self._shards)]
        with tracing.span("fear.pool.pin"):
            pinned = torch.empty(frames.shape, dtype=dtype, pin_memory=True)
        with tracing.span("fear.pool.host_copy"):
            np.copyto(pinned.numpy(), frames)  # one pass, broadcast views included
        with tracing.span("fear.pool.h2d"):
            return self._place(pinned, chunk, lambda x, dev: x.to(dev, non_blocking=True))

    def _place(self, frames, chunk: bool, put):
        """``put(block, device)`` of the frames, or of each shard's block."""
        if self._shards is None:
            return put(frames, self._device)
        shared = frames.ndim == (4 if chunk else 3)
        blocks = []
        for i, r in enumerate(self._shards):
            lo, hi = i * self._per_shard, (i + 1) * self._per_shard
            block = frames if shared else (frames[:, lo:hi] if chunk else frames[lo:hi])
            blocks.append(put(block, r.device))
        return blocks

    def _dispatch(self, out: Dict[str, torch.Tensor], frames) -> PendingStep:
        """Queue the copies of the fetched outputs to pinned host memory and
        record the step's completion event."""
        done = None
        if self._cuda:
            out = {k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=True).copy_(out[k], non_blocking=True)
                   for k in _FETCHED}
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._device))
        return PendingStep(self, out, self.active.copy(), frames if self.auto_reinit else None, done)

    # -- stepping ------------------------------------------------------------

    def step(self, frames) -> Dict[str, Any]:
        """Advance all slots one frame. ``frames``: (capacity, H, W, 3) —
        inactive slots may carry anything (their outputs are masked) — or a
        single (H, W, 3) frame shared by every slot (one camera, many
        tracked objects)."""
        return self.step_async(frames).result()

    def step_async(self, frames) -> PendingStep:
        """Dispatch one step without waiting for its outputs. The pool's
        state advances at once, so further steps can be queued while earlier
        outputs are in flight; fetch them in dispatch order via
        ``PendingStep.result()``."""
        with tracing.span("fear.pool.step_async"):
            self.state, out = self.tracker.step(self.state, self._stage(frames), step_index=self._step_count)
            self._step_count += 1
            tracing.count("pool.steps")
            with tracing.span("fear.pool.fetch"):
                return self._dispatch(out, frames)

    def step_chunk(self, frames) -> Dict[str, Any]:
        """Advance all slots through a (T, capacity, H, W, 3) chunk — or a
        shared (T, H, W, 3) one — in one call; outputs carry the leading T
        axis."""
        return self.step_chunk_async(frames).result()

    def step_chunk_async(self, frames) -> PendingStep:
        """Dispatch a chunk without waiting; pipeline like ``step_async``."""
        T = frames.shape[0]
        self.state, out = self.tracker.track(self.state, self._stage(frames, chunk=True),
                                             start_step=self._step_count)
        self._step_count += T
        return self._dispatch(out, frames[-1])

    def _drain(self, out, active: np.ndarray, frames) -> Dict[str, Any]:
        """Host outputs + failure policy for one dispatched step (per-frame
        outputs (capacity, ...) or chunked (T, capacity, ...))."""
        result = {
            "bbox": np.asarray(out["bbox"]),
            "confidence": np.asarray(out["confidence"]),
            "failure": np.asarray(out["failure"]) & active,  # active broadcasts over T
            "active": active,
        }
        if tracing.enabled() and getattr(self.tracker, "recover_context", 0.0):
            # the slots whose next window widens to recover_context
            low = result["confidence"] < self.tracker.recover_threshold
            tracing.count("pool.recovering_slots", int((low & active).sum()))
        if self.auto_reinit:
            # chunked: a slot that failed on ANY frame of the chunk is
            # re-templated, from the chunk's last frame and prediction
            failure = result["failure"].any(0) if result["failure"].ndim == 2 else result["failure"]
            bbox = result["bbox"][-1] if result["bbox"].ndim == 3 else result["bbox"]
            # ``frames``: the dispatch's last frame, (capacity, H, W, 3) or one
            # shared (H, W, 3), or a whole (T, capacity, H, W, 3) chunk
            if frames.ndim == 5:
                frames = frames[-1]
            for slot in np.nonzero(failure & self.active)[0]:
                self._init_slot(int(slot), frames if frames.ndim == 3 else frames[slot], bbox[slot])
                tracing.count("pool.reinits")
        return result
