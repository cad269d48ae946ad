"""One process of a multi-process test of the port, over Gloo on the CPU,
and the launcher the tests call (:func:`run_workers`).

    python tests/torch_dist_worker.py <scenario> <rank> <world> <port> <in.npz> <out.npz>

Each process joins the group at ``127.0.0.1:<port>`` through
``parallel.multihost.initialize``, runs ``<scenario>`` on its inputs and
writes its outputs to ``<out.npz>`` with ``.<rank>`` appended. The port only:
no JAX here (the tests hold the outputs to JAX in their own process).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(scenario: str, world: int, inputs: dict, tmp_path, timeout: float = 120.0) -> list:
    """Run ``world`` processes of ``scenario`` on ``inputs`` (arrays, and a
    ``config`` dict sent as JSON); → each rank's outputs as a dict. One
    intra-op thread a process. A process that fails makes the others be
    killed at once; all are killed after ``timeout`` seconds, so a hung
    rendezvous fails the test instead of stalling the suite."""
    inp = os.path.join(str(tmp_path), f"{scenario}_in.npz")
    out = os.path.join(str(tmp_path), f"{scenario}_out.npz")
    arrays = {k: v for k, v in inputs.items() if k != "config"}
    np.savez(inp, config=np.asarray(json.dumps(inputs.get("config", {}))), **arrays)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, __file__, scenario, str(r), str(world), str(port), inp, out],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate(timeout=30) for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {scenario} exited {p.returncode}:\n{err[-4000:]}"
    results = []
    for r in range(world):
        with np.load(f"{out}.{r}.npz", allow_pickle=False) as z:
            results.append({k: z[k] for k in z.files})
    return results


# -- scenarios (run in the worker processes) -----------------------------------


def _allgather(rank, world, inp, cfg):
    from feartracker_tpu_torch.parallel.multihost import allgather_rows

    rows = np.array([[float(rank), 0.5 + rank + 0.1 * r, float(r)] for r in range(rank + 1)])
    return {"rows": allgather_rows(rows), "empty": allgather_rows(np.zeros((0, 3)))}


def _bn(rank, world, inp, cfg):
    """A train-mode FlaxBatchNorm2d with cross-process statistics on this
    rank's NHWC block; the loss sum(y · g) with the rank's cotangent g."""
    import torch

    from feartracker_tpu_torch.models.blocks import FlaxBatchNorm2d, set_sync_bn

    C = inp["scale"].shape[0]
    bn = set_sync_bn(FlaxBatchNorm2d(C, eps=1e-5, momentum=0.1))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["var"]))
    bn.train()
    x = torch.from_numpy(inp[f"x{rank}"]).requires_grad_(True)
    y = bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (y * torch.from_numpy(inp[f"g{rank}"])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _tiny_state(inp, cfg, rank_batch=None):
    import torch

    from feartracker_tpu_torch.convert.load import load_fear_net
    from feartracker_tpu_torch.models.blocks import set_sync_bn
    from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
    from feartracker_tpu_torch.models.fear_net import FEARNet
    from feartracker_tpu_torch.train.optim import build_optimizer
    from feartracker_tpu_torch.train.step import create_train_state

    flat = {k[len("var/"):]: inp[k] for k in inp if k.startswith("var/")}
    model = load_fear_net(FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32), flat)
    set_sync_bn(model, bool(cfg.get("sync_bn", False)))
    tx = build_optimizer(cfg["optimizer"])
    return tx, create_train_state(model, tx, device="cpu")


def _batch(inp, step, rank):
    import torch

    prefix = f"batch/{step}/{rank}/"
    return {k[len(prefix):]: torch.from_numpy(inp[k]) for k in inp if k.startswith(prefix)}


def _state_out(state, metrics):
    out = {f"param/{k}": p.detach().numpy() for k, p in state.model.named_parameters()}
    out.update({f"stat/{k}": b.numpy() for k, b in state.model.named_buffers() if k.endswith(("mean", "var"))})
    for k in ("loss", "cls_loss", "reg_loss", "box_iou", "failure_rate"):
        out[f"metric/{k}"] = np.asarray([float(m[k]) for m in metrics])
    out["metric/ious"] = np.stack([m["ious"].numpy() for m in metrics])
    return out


def _step(rank, world, inp, cfg):
    """``cfg["steps"]`` data-parallel steps of the tiny model over the group."""
    from feartracker_tpu_torch.core import box_coder as bc
    from feartracker_tpu_torch.parallel.multihost import process_group
    from feartracker_tpu_torch.train.step import make_train_step

    tx, state = _tiny_state(inp, cfg)
    step = make_train_step(tx, spec=bc.BoxCoderSpec(score_size=8, total_stride=8, instance_size=64),
                           mesh=process_group(), guard_non_finite=bool(cfg.get("guard", False)))
    metrics, snapshots = [], {}
    for i in range(int(cfg["steps"])):
        state, m = step(state, _batch(inp, i, rank))
        metrics.append(m)
        snapshots.update({f"{i}/{k}": v.copy() for k, v in _state_out(state, metrics).items()
                          if not k.startswith("metric/")})
    out = _state_out(state, metrics)
    out.update(snapshots)
    out["opt/count"] = np.asarray(int(state.opt_state.get("count", -1)))
    return out


def _world1(rank, world, inp, cfg):
    """A group of one process against no group: the same steps, both ways."""
    from feartracker_tpu_torch.core import box_coder as bc
    from feartracker_tpu_torch.parallel.multihost import process_group
    from feartracker_tpu_torch.train.step import make_train_step

    out = {}
    for name, mesh in (("group", process_group()), ("alone", None)):
        tx, state = _tiny_state(inp, cfg)
        step = make_train_step(tx, spec=bc.BoxCoderSpec(score_size=8, total_stride=8, instance_size=64), mesh=mesh)
        metrics = []
        for i in range(int(cfg["steps"])):
            state, m = step(state, _batch(inp, i, 0))
            metrics.append(m)
        out.update({f"{name}/{k}": v for k, v in _state_out(state, metrics).items()})
    return out


def _loop(rank, world, inp, cfg):
    """``Trainer.fit`` (``cfg["trainer"]``) on this rank; its final state,
    the rows its validation gathered, and what it wrote."""
    import torch

    from feartracker_tpu_torch.convert.load import load_fear_net
    from feartracker_tpu_torch.parallel import multihost
    from feartracker_tpu_torch.train import loop as L

    gathered = []
    allgather = multihost.allgather_rows

    def recording(rows):
        got = allgather(rows)
        gathered.append(got)
        return got

    multihost.allgather_rows = recording
    trainer = L.Trainer(cfg["trainer"])
    trainer.setup_data()
    trainer.setup_state(0)
    flat = {k[len("var/"):]: inp[k] for k in inp if k.startswith("var/")}
    if flat:
        load_fear_net(trainer.state.model, flat)
    writer_null = isinstance(trainer.writer, L._NullWriter)  # the writer fit uses
    trainer.fit()
    out = {f"param/{k}": p.detach().numpy() for k, p in trainer.state.model.named_parameters()}
    out.update({f"stat/{k}": b.numpy() for k, b in trainer.state.model.named_buffers() if k.endswith(("mean", "var"))})
    out["step"] = np.asarray(trainer.state.step)
    out["batch_size"] = np.asarray(trainer.batch_size)
    out["loader"] = np.asarray(trainer._loader()._indices())
    for i, rows in enumerate(gathered):
        out[f"rows/{i}"] = rows
    out["is_master"] = np.asarray(trainer.is_master)
    out["writer_null"] = np.asarray(writer_null)
    out["rank"] = np.asarray(torch.distributed.get_rank())
    return out


def _resume(rank, world, inp, cfg):
    """``fit`` with ``resume`` where only rank 0 sees a ``last`` checkpoint:
    every rank must raise."""
    from feartracker_tpu_torch.train import loop as L

    trainer = L.Trainer(cfg["trainer"] if rank == 0 else cfg["trainer_other"])
    trainer.setup_data()
    trainer.setup_state(0)
    try:
        trainer.fit()
    except RuntimeError as e:
        return {"raised": np.asarray(str(e))}
    return {"raised": np.asarray("")}


SCENARIOS = {"allgather": _allgather, "bn": _bn, "step": _step, "world1": _world1, "loop": _loop,
             "resume": _resume}


def main(argv) -> None:
    scenario, rank, world, port, inp_path, out_path = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from feartracker_tpu_torch.parallel import multihost

    multihost.initialize({"coordinator_address": f"127.0.0.1:{port}", "num_processes": world,
                          "process_id": rank, "backend": "gloo"})
    with np.load(inp_path, allow_pickle=False) as z:
        inp = {k: z[k] for k in z.files}
    cfg = json.loads(str(inp.pop("config")))
    out = SCENARIOS[scenario](rank, world, inp, cfg)
    np.savez(f"{out_path}.{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
