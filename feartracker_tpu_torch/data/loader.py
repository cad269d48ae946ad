"""Batch loader: shuffling, thread-pool item assembly, background prefetch,
and the copy onto the card. The counterpart of
``feartracker_tpu/data/loader.py``: the same batches in the same order,
under host sharding too (``host_id``/``num_hosts``, one shard per process).

Threads do the work: cv2 and numpy release the GIL for the heavy ops.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

STACK_EXCLUDE_TYPES = (str, bytes)


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack arrays; keep strings as lists."""
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], STACK_EXCLUDE_TYPES) or not np.isscalar(vals[0]) and not hasattr(vals[0], "shape"):
            out[k] = vals if isinstance(vals[0], STACK_EXCLUDE_TYPES) else np.asarray(vals)
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A batch's numeric arrays as tensors on ``device``; strings and lists
    stay on the host. On the card each array goes through pinned host
    memory with a ``non_blocking`` copy, so that the host does not wait for
    the steps queued before it."""
    device = torch.device(device)
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t if t.device == device else t.to(device)
        else:
            out[k] = v
    return out


def prefetch_to_device(iterator: Iterator, device="cuda", depth: int = 2) -> Iterator:
    """Copy each batch onto ``device`` ``depth`` batches ahead of the
    consumer, so that batch t+1's copy rides behind step t. Each prefetched
    batch holds device memory, so keep ``depth`` small. There is no
    fallback: ``device="cuda"`` on a host without a card raises."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prefetch_to_device: CUDA is not available; pass device='cpu' to stay on the host")
    buf: List[Any] = []
    for item in iterator:
        buf.append(to_device(item, device))
        if len(buf) >= depth:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 2,
        drop_last: bool = True,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_hosts
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.host_id :: self.num_hosts]  # this host's shard

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self.epoch += 1
        indices = self._indices()
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """A bounded put that keeps checking the stop flag: a consumer
            that leaves early must not park the producer on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        batch_idx = indices[b * self.batch_size : (b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.__getitem__, batch_idx))
                        if not put(collate(items)):
                            return
            except BaseException as e:  # a worker's error reaches the consumer
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
