"""Multi-process training support, the counterpart of
``feartracker_tpu/parallel/multihost.py``.

PyTorch's idiom is one process a card, joined into a process group by
``torch.distributed``: each process draws its own share of the data
(``BatchLoader(host_id=rank, num_hosts=world)``), gradients and BatchNorm
statistics are averaged over the group in the train step, and rank 0 alone
writes logs and checkpoints. The functions here are the seam the trainer
reads; tests monkeypatch ``process_index`` / ``process_count`` to mock a
topology without launching processes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# the variables torchrun sets for an env:// rendezvous
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(config: Dict[str, Any]) -> None:
    """Join the process group (idempotent: a second call does nothing).

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` the rendezvous is ``tcp://host:port`` with that world size
    and rank; without them it is ``env://``, from torchrun's variables.
    ``backend`` names the transport: ``nccl`` (the default, one card a
    process) or ``gloo`` (the CPU, or several processes on one card).
    """
    if dist.is_initialized():
        return
    backend = config.get("backend") or "nccl"
    keys = ("coordinator_address", "num_processes", "process_id")
    given = [k for k in keys if config.get(k) is not None]
    if given:
        if len(given) != len(keys):
            raise ValueError(f"distributed: give all of {keys} or none of them (got {given})")
        dist.init_process_group(backend, init_method=f"tcp://{config['coordinator_address']}",
                                world_size=int(config["num_processes"]), rank=int(config["process_id"]))
    else:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(
                f"distributed: no coordinator_address/num_processes/process_id and no {missing} in the "
                "environment; launch with torchrun --nproc_per_node N, or give the three keys")
        dist.init_process_group(backend, init_method="env://")


def process_group() -> dist.ProcessGroup:
    """The default group: the data-parallel train step's ``mesh``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    return dist.group.WORLD


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_process_count() -> int:
    """Processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else every
    process of the group (a group started by hand on one host)."""
    value = os.environ.get("LOCAL_WORLD_SIZE")
    return process_count() if value is None else int(value)


def local_rank() -> Optional[int]:
    """torchrun's ``LOCAL_RANK``: the card this process drives; None outside
    torchrun."""
    value = os.environ.get("LOCAL_RANK")
    return None if value is None else int(value)


def is_master() -> bool:
    """Rank 0 alone writes the event log and the checkpoints."""
    return process_index() == 0


def _collective_device() -> torch.device:
    """NCCL moves tensors on the process's card, Gloo host tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_rows(rows) -> np.ndarray:
    """Every process's (N_p, C) rows, N_p varying, as one (ΣN_p, C) float32
    array in rank order, the same on every process. ``rows`` must be 2-D
    with the same C everywhere (callers ``reshape(-1, C)`` so that an empty
    block keeps its width).

    One process: the rows, as float32. More: the row counts are gathered,
    every block is NaN-padded to the largest, one ``all_gather`` moves them,
    and the padding is stripped."""
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2:
        raise ValueError(f"rows must be (N, C), got shape {rows.shape}")
    world = process_count()
    if world == 1:
        return rows
    dev = _collective_device()
    count = torch.tensor([rows.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in torch.cat(counts).cpu()]
    padded = torch.full((max(counts), rows.shape[1]), float("nan"), dtype=torch.float32, device=dev)
    padded[: rows.shape[0]] = torch.from_numpy(rows).to(dev)
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    return np.concatenate([g[:n].cpu().numpy() for g, n in zip(gathered, counts)], axis=0)


def all_equal(flag: int) -> bool:
    """Whether every process passed the same integer (the resume check:
    every rank must see the same checkpoint)."""
    if process_count() == 1:
        return True
    t = torch.tensor([flag, -flag], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0]) == -int(t[1])
