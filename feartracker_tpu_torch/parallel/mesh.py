"""Devices and batch shares, the counterpart of
``feartracker_tpu/parallel/mesh.py``.

JAX's mesh is one object that both data-parallel training and stream-sharded
inference place arrays on. In the port the two read it apart:

* a process group (:mod:`.multihost`) joins one process a card for training;
  each process holds its contiguous share of the global batch
  (:func:`shard_batch`);
* the sharded tracker (:class:`~.inference.ShardedScanTracker`) spreads its
  streams over a tuple of devices from one process (:func:`make_mesh`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[Any]] = None
              ) -> Tuple[torch.device, ...]:
    """The devices the sharded tracker spreads its streams over: the first
    ``n_devices`` of ``devices`` (default: every visible card). A device may
    appear more than once (two shards on one card). Raises when fewer are
    present than asked, or when there are none."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("no devices: no CUDA card is visible; pass devices=[...] (e.g. ['cpu', 'cpu'])")
    return devices


def shard_bounds(n: int, index: int, count: int) -> Tuple[int, int]:
    """Rows [lo, hi) of shard ``index`` of ``count`` over ``n`` rows, which
    must divide: contiguous blocks in order, as JAX's ``P(axis)`` lays a
    leading axis over a mesh."""
    if n % count:
        raise ValueError(f"{n} rows do not divide over {count} shards")
    per = n // count
    return index * per, (index + 1) * per


def shard_batch(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Process ``rank``'s contiguous share of a global batch of (B, ...)
    leaves (B divisible by ``world``): what JAX's ``shard_batch`` places on
    the devices of one process, for one process a card."""
    out = {}
    for k, v in batch.items():
        lo, hi = shard_bounds(len(v), rank, world)
        out[k] = v[lo:hi]
    return out


def local_batch_size(batch_size: int, local_world: int) -> int:
    """Each process's batch: JAX's per-host ``batch_size`` split over the
    host's processes (one a card), so that the global batch stays
    ``batch_size × hosts``. Raises where it does not divide."""
    if batch_size % local_world:
        raise ValueError(f"batch_size {batch_size} does not divide over {local_world} processes on this host")
    return batch_size // local_world
