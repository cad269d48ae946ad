"""Train the dual-template interpolation gate on structural-appearance data:
the counterpart of ``tools/train_template_gate.py``.

Every recovered FEAR-XS checkpoint zero-fills ``template_gate`` (the CoreML
exports predate the reference's unreleased Dynamic Template Update module,
ref README.md:96, blocks.py:174-181), so ``update_mode='gated'`` runs at the
untrained sigmoid(0) = 0.5 blend. This tool learns the gate end to end on the
synthetic structural suite (swap / occlusion / pose, ``make_synthetic_dataset``)
with every other weight frozen at the recovered values: the result is
"FEAR-XS + trained gate", the archive ``dual_template_ablation
--gate_npz`` compares against the untrained blend.

Objective: the dual-template training forward (``FEARNet.forward_dual``: the
classification branch correlates against (1-g)·static + g·aux, with
g = sigmoid(template_gate) taken in float32 before the cast) with the FEAR
loss, BatchNorm in inference mode (the gate serves the inference graph).
Only ``template_gate`` has a gradient; Adam moves it. Mixed bfloat16 on the
card, float32 on the CPU, as the JAX tool picks by backend. With
``--device_augs`` (needed where cv2 is absent, the card's host) the loader
stops at uint8 crops and ``data/device_augs.py`` augments them on the device.

The archive (``--out``, default ``<work>/fear_xs_gate.npz``) holds every
weight of ``--weights`` with the trained gate, plus a ``.json`` record.

    python -m feartracker_tpu_torch.tools.train_template_gate --work /tmp/gate --device_augs
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Iterable

import numpy as np
import torch

from feartracker_tpu_torch.convert.load import load_fear_net, load_variables
from feartracker_tpu_torch.data.dataset import get_training_datasets
from feartracker_tpu_torch.data.device_augs import (STAGED_SEARCH_BBOX_KEY, STAGED_SEARCH_KEY, DeviceAugConfig,
                                                    aug_generator, augment_batch)
from feartracker_tpu_torch.data.loader import BatchLoader
from feartracker_tpu_torch.evaluate.harness import device_line, tool_device
from feartracker_tpu_torch.models.fear_net import build_family_model
from feartracker_tpu_torch.tools.export_weights import save_npz
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate
from feartracker_tpu_torch.train.loss import fear_loss
from feartracker_tpu_torch.train.optim import apply_updates, build_optimizer
from feartracker_tpu_torch.utils import constants as C

SIZES = {
    "search_image_size": 256, "template_image_size": 128,
    "search_context": 2, "template_bbox_offset": 0.2,
    "search_image_shift": 32, "search_image_scale": 0.2,
    "context_range": 1,
}
TRACKER = {
    "score_size": 16, "total_stride": 16, "instance_size": 256,
    "template_size": 128, "template_bbox_offset": 0.2, "search_context": 2,
}
DEVICE_KEYS = (
    C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY, C.TRACKER_TARGET_SEARCH_IMAGE_KEY,
    C.TRACKER_TARGET_AUX_IMAGE_KEY, C.TARGET_CLASSIFICATION_KEY,
    C.TARGET_REGRESSION_LABEL_KEY, C.TARGET_REGRESSION_WEIGHT_KEY,
)
# a staged batch's keys (device_augs): the augmentation makes the rest
STAGED_KEYS = (STAGED_SEARCH_KEY, STAGED_SEARCH_BBOX_KEY, C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY,
               C.TRACKER_TARGET_AUX_IMAGE_KEY, C.TARGET_VISIBILITY_KEY)
AUG = DeviceAugConfig(search_size=SIZES["search_image_size"], scale=SIZES["search_image_scale"],
                      shift=SIZES["search_image_shift"], grid_size=16, total_stride=16)


def build_dataset(roots, num_samples, seed, device_augs=False):
    config = {
        "tracker": TRACKER,
        "train": {"datasets": [
            {
                "name": f"synthetic_{os.path.basename(root)}",
                "root": root,
                "dynamic_template": True,
                **({"device_augs": True} if device_augs else {}),
                "sizes": dict(SIZES),
                "regression_weight_label_size": 16,
                "sampling": {
                    "type": "track", "data_path": f"{root}/train.csv",
                    "negative_ratio": 0, "frame_offset": 8,
                    "num_samples": num_samples, "clip_range": True,
                },
            }
            for root in roots
        ]},
    }
    return get_training_datasets(config, seed=seed)


def frozen_model(weights: str, device) -> torch.nn.Module:
    """FEAR-XS from ``weights`` on ``device`` in eval mode (inference
    BatchNorm), every parameter frozen but ``template_gate``."""
    model = build_family_model("fear_xs")
    load_fear_net(model, load_variables(weights))
    model.to(device).eval()
    for name, p in model.named_parameters():
        p.requires_grad_(name == "template_gate")
    return model


def make_gate_step(model: torch.nn.Module, lr: float, mixed=None):
    """``step(batch) -> (total, losses, grad)``: one Adam step of
    ``model.template_gate`` on a normalized batch already on the model's
    device. ``mixed`` (bfloat16 autocast) defaults to the JAX tool's rule:
    on the card, not on the CPU."""
    gate = model.template_gate
    tx = build_optimizer({"name": "adam", "lr": lr})
    opt_state = tx.init({"template_gate": gate.detach()})
    mixed = gate.device.type != "cpu" if mixed is None else mixed

    def step(batch: Dict[str, torch.Tensor]):
        nonlocal opt_state
        with torch.autocast(gate.device.type, dtype=torch.bfloat16, enabled=mixed):
            out = model.forward_dual((batch[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY],
                                      batch[C.TRACKER_TARGET_SEARCH_IMAGE_KEY],
                                      batch[C.TRACKER_TARGET_AUX_IMAGE_KEY]))
        losses = fear_loss(out, batch)
        total = losses[C.TARGET_CLASSIFICATION_KEY] + losses[C.TARGET_REGRESSION_LABEL_KEY]
        (grad,) = torch.autograd.grad(total, [gate])
        updates, opt_state = tx.update({"template_gate": grad}, opt_state, {"template_gate": gate.detach()})
        apply_updates({"template_gate": gate.data}, updates)
        return total.detach(), {k: v.detach() for k, v in losses.items()}, grad

    return step


def device_batches(loader: Iterable, device, device_augs: bool, seed: int, start: int = 0):
    """The loader's batches on ``device`` with the step's keys; a staged
    batch is augmented there with the draws of (``seed``, step)."""
    for i, batch in enumerate(loader, start):
        keys = STAGED_KEYS if device_augs else DEVICE_KEYS
        out = {k: torch.as_tensor(np.asarray(batch[k])).to(device) for k in keys}
        if device_augs:
            out = augment_batch(out, aug_generator(seed, i, device), AUG)
        yield out


def run(scenarios=("swap", "occlusion", "pose"), tracks=12, frames=32, epochs=12, samples_per_scenario=256,
        batch=32, lr=0.05, seed=0, data_seed=101, weights="fear_xs", out=None, work=None, device="cuda",
        device_augs=False, num_workers=2) -> list:
    """Train the gate; one JSON line an epoch and a final record. Writes
    ``out`` and its ``.json`` record. → the epoch rows and the final record."""
    device = torch.device(device)
    work = work or tempfile.mkdtemp(prefix="gate_train_")
    out = out or os.path.join(work, "fear_xs_gate.npz")
    roots = []
    for scenario in scenarios:
        root = os.path.join(work, scenario)
        if not os.path.exists(os.path.join(root, "train.csv")):
            print(f"[gate] generating {scenario} training set -> {root}", flush=True)
            generate(root, tracks=tracks, frames=frames, val_sequences=0, seed=data_seed, scenario=scenario)
        roots.append(root)
    dataset = build_dataset(roots, samples_per_scenario, seed, device_augs)
    loader = BatchLoader(dataset, batch, shuffle=True, num_workers=num_workers, seed=seed)

    model = frozen_model(weights, device)
    step = make_gate_step(model, lr)
    gate = model.template_gate.detach()  # a view: the steps update it in place
    t0 = time.time()
    it = 0
    history = []
    for epoch in range(epochs):
        loader.epoch = epoch
        dataset.resample()
        for b in device_batches(loader, device, device_augs, seed, it):
            total, losses, grad = step(b)
            it += 1
            if it % 8 == 0:
                print(f"[gate] ep {epoch} it {it}: loss {float(total):.4f} "
                      f"cls {float(losses[C.TARGET_CLASSIFICATION_KEY]):.4f} gate logit {float(gate[0]):+.4f} "
                      f"sigmoid {float(torch.sigmoid(gate)[0]):.4f} grad {float(grad[0]):+.2e}", flush=True)
        history.append({"epoch": epoch, "loss": round(float(total), 4), "gate_logit": round(float(gate[0]), 4),
                        "gate_sigmoid": round(float(torch.sigmoid(gate)[0]), 4)})
        print(json.dumps(history[-1]), flush=True)

    final = {"gate_logit": float(gate[0]), "gate_sigmoid": float(torch.sigmoid(gate)[0]), "steps": it,
             "wall_s": round(time.time() - t0, 1), "scenarios": ",".join(scenarios), "weights": weights,
             "history": history}
    print(json.dumps({k: v for k, v in final.items() if k != "history"}), flush=True)
    variables = load_variables(weights)
    variables["params/template_gate"] = gate.cpu().numpy().astype(np.float32)
    save_npz(variables, out)
    with open(os.path.splitext(out)[0] + ".json", "w") as fh:
        json.dump(final, fh, indent=1)
    print(f"[gate] wrote {out} (+ .json training record)", flush=True)
    return history + [{k: v for k, v in final.items() if k != "history"}]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", default="swap,occlusion,pose")
    ap.add_argument("--tracks", type=int, default=12)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--samples_per_scenario", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_seed", type=int, default=101,
                    help="generator seed for the TRAINING scenarios (keep disjoint from the ablation's eval seeds)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--weights", default="fear_xs")
    ap.add_argument("--work", default=None, help="dataset dir (default: temporary)")
    ap.add_argument("--out", default=None, help="default: <work>/fear_xs_gate.npz")
    ap.add_argument("--device_augs", action="store_true",
                    help="staged loader + augmentation on the device (needed where cv2 is absent)")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.scenarios.split(","), args.tracks, args.frames, args.epochs, args.samples_per_scenario, args.batch,
        args.lr, args.seed, args.data_seed, args.weights, args.out, args.work, device, args.device_augs)


if __name__ == "__main__":
    main()
