"""The training step: forward in train mode, loss, gradients, the optimizer
update, and the step's metrics, all on the device. The counterpart of
``feartracker_tpu/train/step.py``.

Precision follows ``FEARNet(dtype=bfloat16)`` of the JAX package when
``dtype=torch.bfloat16``: float32 master parameters, convolutions and
matmuls in bfloat16 (``torch.autocast``), BatchNorm statistics in float32
(:class:`~feartracker_tpu_torch.models.blocks.FlaxBatchNorm2d`), and the
head's outputs cast to float32 before the loss.

Data parallelism is one process a card (``make_train_step(mesh=group)``):
each process runs the step on its share of the batch, and the step averages
the gradients, the losses and scalar metrics, and the BatchNorm running
statistics over the process group, in JAX's ``shard_map`` step's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.train.loss import fear_loss
from feartracker_tpu_torch.train.metrics import box_iou_xywh
from feartracker_tpu_torch.train.optim import Optimizer, apply_updates
from feartracker_tpu_torch.utils.constants import (
    TARGET_CLASSIFICATION_KEY,
    TARGET_REGRESSION_LABEL_KEY,
    TARGET_VISIBILITY_KEY,
    TRACKER_TARGET_AUX_IMAGE_KEY,
    TRACKER_TARGET_BBOX_KEY,
    TRACKER_TARGET_SEARCH_IMAGE_KEY,
    TRACKER_TARGET_TEMPLATE_IMAGE_KEY,
)

@dataclass
class TrainState:
    """What a step reads and writes: the model (its parameters are the JAX
    state's ``params``, its BatchNorm running statistics the
    ``batch_stats``), the optimizer's state, and the step count, on the
    host so that seeding a step's draws never waits for the card."""

    model: nn.Module
    opt_state: Dict[str, Any]
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "opt_state": self.opt_state, "step": self.step}

    def load_state_dict(self, d: Dict[str, Any]) -> "TrainState":
        """Copy a saved state into this one's tensors, in place."""
        self.model.load_state_dict(d["model"])
        _copy_into(self.opt_state, d["opt_state"])
        self.step = int(d["step"])
        return self


def _copy_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    if set(dst) != set(src):
        raise KeyError(f"optimizer state keys differ: {sorted(set(dst) ^ set(src))}")
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to train on the host")
    return device


def params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def create_train_state(model: nn.Module, tx: Optimizer, device="cuda") -> TrainState:
    """``model`` moved to ``device`` (float32 master parameters) and a fresh
    optimizer state for it."""
    model = model.to(_device(device), torch.float32)
    return TrainState(model=model, opt_state=tx.init(params_of(model)), step=0)


def _bn_stats(model: nn.Module) -> List[torch.Tensor]:
    return [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]


def _step_metrics(outputs, batch, spec: bc.BoxCoderSpec) -> Dict[str, torch.Tensor]:
    """The decoded box's IoU against the batch's box, over visible targets."""
    dec = bc.decode(
        outputs[TARGET_REGRESSION_LABEL_KEY].float(),
        outputs[TARGET_CLASSIFICATION_KEY].float(),
        spec,
        use_sigmoid=True,
    )
    gt = batch[TRACKER_TARGET_BBOX_KEY].float()
    vis = batch[TARGET_VISIBILITY_KEY].reshape(-1).float()
    ious = box_iou_xywh(dec.bbox, gt)
    denom = torch.clamp(vis.sum(), min=1.0)
    box_iou = torch.sum(ious * vis) / denom
    fail = torch.sum((ious == 0).float() * vis) / denom
    return {"box_iou": box_iou, "failure_rate": fail, "ious": ious, "visibility": vis}


def make_loss_and_grads(
    coeffs: Optional[Dict[str, float]] = None,
    dual_template: bool = False,
    dtype: Optional[torch.dtype] = None,
):
    """``loss_and_grads(model, batch) -> (total, losses, outputs, grads)``:
    the forward pass in train mode (which moves the BatchNorm running
    statistics, as Flax's mutable ``batch_stats`` do), the loss, and the
    gradient of every parameter by name (zeros for a parameter the forward
    pass does not reach, as JAX gives)."""
    mixed = dtype is not None and dtype != torch.float32

    def loss_and_grads(net: nn.Module, batch: Dict[str, Any]):
        dev = batch[TRACKER_TARGET_TEMPLATE_IMAGE_KEY].device
        net.train()
        with torch.autocast(dev.type, dtype=dtype if mixed else torch.bfloat16, enabled=mixed):
            if dual_template:
                out = net.forward_dual((batch[TRACKER_TARGET_TEMPLATE_IMAGE_KEY],
                                        batch[TRACKER_TARGET_SEARCH_IMAGE_KEY],
                                        batch[TRACKER_TARGET_AUX_IMAGE_KEY]))
            else:
                out = net((batch[TRACKER_TARGET_TEMPLATE_IMAGE_KEY], batch[TRACKER_TARGET_SEARCH_IMAGE_KEY]))
        losses = fear_loss(out, batch, coeffs)
        total = losses[TARGET_CLASSIFICATION_KEY] + losses[TARGET_REGRESSION_LABEL_KEY]
        params = params_of(net)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        return total.detach(), {k: v.detach() for k, v in losses.items()}, out, grads

    return loss_and_grads


def make_train_step(
    tx: Optimizer,
    coeffs: Optional[Dict[str, float]] = None,
    spec: bc.BoxCoderSpec = bc.BoxCoderSpec(),
    mesh: Any = None,
    dual_template: bool = False,
    device_augs: Optional[Any] = None,
    aug_seed: int = 0,
    guard_non_finite: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The step ``step(state, batch) -> (state, metrics)``; it updates
    ``state`` in place and returns it.

    ``dual_template`` trains through ``forward_dual`` (the batch carries the
    AUX image). ``device_augs`` (a ``data.device_augs.DeviceAugConfig``)
    takes a STAGED uint8 batch and augments it on the device first, with
    draws seeded from (``aug_seed``, step). ``guard_non_finite`` puts back
    the BatchNorm statistics that a non-finite forward pass moved (the
    optimizer's ``skip_non_finite`` guards the rest). ``dtype=bfloat16``
    trains in mixed precision (see the module docstring). The state
    carries the model.

    ``mesh`` (a ``torch.distributed`` process group, e.g.
    ``parallel.multihost.process_group()``) makes the step data-parallel,
    JAX's ``shard_map`` step for one process a card: the augmentation draws
    fold in the rank (when the group has more than one process); the local
    loss and gradients; the gradients averaged over the group in one flat
    all-reduce; the losses and scalar metrics averaged; the BatchNorm
    running statistics averaged; then the NaN guard on the averaged values;
    then the optimizer. Per-sample outputs (``ious``, ``visibility``,
    ``cls_map``, ``reg_map``) stay the process's own rows. Cross-process
    BatchNorm statistics are the model's (``models.blocks.set_sync_bn``). A
    group of one process gives the no-group step's results bit for bit.
    """
    if mesh is not None and not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"mesh must be a torch.distributed process group, got {type(mesh).__name__}")
    loss_and_grads = make_loss_and_grads(coeffs, dual_template, dtype)
    rank = None
    if mesh is not None and dist.get_world_size(mesh) > 1:
        rank = dist.get_rank(mesh)

    def step_fn(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        net = state.model
        if device_augs is not None:
            from feartracker_tpu_torch.data.device_augs import aug_generator, augment_batch

            dev = batch[TRACKER_TARGET_TEMPLATE_IMAGE_KEY].device
            batch = augment_batch(batch, aug_generator(aug_seed, state.step, dev, rank), device_augs)
        stats = _bn_stats(net)
        saved = [s.clone() for s in stats] if guard_non_finite else None
        total, losses, out, grads = loss_and_grads(net, batch)
        with torch.no_grad():
            metrics = _step_metrics(out, batch, spec)
            scalars = {
                "loss": total,
                "cls_loss": losses[TARGET_CLASSIFICATION_KEY],
                "reg_loss": losses[TARGET_REGRESSION_LABEL_KEY],
                "box_iou": metrics["box_iou"],
                "failure_rate": metrics["failure_rate"],
            }
            if mesh is not None:
                grads = dict(zip(grads, _group_mean(list(grads.values()), mesh)))
                scalars = dict(zip(scalars, _group_mean(list(scalars.values()), mesh)))
                for s, mean in zip(stats, _group_mean(stats, mesh)):
                    s.copy_(mean)
            if guard_non_finite:
                ok = torch.isfinite(torch.stack(torch._foreach_norm(stats, float("inf")))).all()
                ok = ok & torch.isfinite(scalars["loss"])
                for s, old in zip(stats, saved):
                    s.copy_(torch.where(ok, s, old))
            params = params_of(net)
            updates, state.opt_state = tx.update(grads, state.opt_state, {k: p.detach() for k, p in params.items()})
            apply_updates(params, updates)
        state.step += 1
        return state, {
            **scalars,
            "ious": metrics["ious"],
            "visibility": metrics["visibility"],
            # raw maps for the best/worst-batch mosaics (B·16·16·5)
            "cls_map": out[TARGET_CLASSIFICATION_KEY].detach().float(),
            "reg_map": out[TARGET_REGRESSION_LABEL_KEY].detach().float(),
        }

    return step_fn


def _group_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean of each tensor over ``group``, in one all-reduce of one flat
    buffer (of the widest dtype); returned in order, each in its own dtype."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [v.view(t.shape).to(t.dtype) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_multistep(step, k: int):
    """``k`` optimizer steps over batches stacked on a leading (k, ...)
    axis: ``multi(state, batches) -> (state, metrics)`` with every metric
    stacked over that axis. A loop of eager steps; the same k steps as one
    CUDA graph is later work (ROADMAP.md)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")

    def multi(state: TrainState, batches: Dict[str, Any]):
        per_step = []
        for i in range(k):
            state, m = step(state, {key: v[i] for key, v in batches.items()})
            per_step.append(m)
        return state, {key: torch.stack([m[key] for m in per_step]) for key in per_step[0]}

    return multi


def stack_batches(batches):
    """A list of k batch dicts → one dict with leading (k, ...) arrays (array
    keys only: callers filter strings out first). numpy stays numpy,
    tensors stay tensors."""
    first = batches[0]
    return {
        key: torch.stack([b[key] for b in batches]) if isinstance(first[key], torch.Tensor)
        else np.stack([b[key] for b in batches])
        for key in first
    }
