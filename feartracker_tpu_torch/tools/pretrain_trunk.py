"""Classification pretraining for any FBNet trunk: the counterpart of
``tools/pretrain_trunk.py``.

The reference warm-starts from mobile_cv's ImageNet-pretrained FBNet-C
(ref: model_training/model/blocks.py:22-25, config/model/fear.yaml:5). This
tool pretrains trunk + global average pool + linear head on an ImageFolder
layout (``root/<class>/*.{jpg,JPEG,png,npy}``: ImageNet, or
``make_class_dataset``'s stand-in) and exports the ``params/encoder/...`` and
``batch_stats/encoder/...`` arrays under the JAX package's names, layouts
and dtypes, which ``model.pretrained_weights`` consumes through the partial
transfer (``convert/load.py:transfer_variables``): the trunk transfers, the
tracking head trains from scratch.

The classifier is the port's ``FBNetTrunk`` named ``encoder`` in train mode
(Flax's BatchNorm, ``models/blocks.py:FlaxBatchNorm2d``), a spatial mean and
``nn.Linear`` as ``cls_head``, in float32 as in JAX; softmax cross-entropy,
Adam (``train/optim.py``); one ``RandomState(seed)`` permutation an epoch, the
last partial batch dropped. Images are listed by the JAX tool's suffixes
(plus ``.npy``) and decoded by ``data/dataset.py:read_img`` as
``cv2.imread`` decodes them, by signature (an ImageNet ``.JPEG`` that holds a
PNG or a CMYK JPEG reads), with no cv2; they are resized to ``image_size``
with the cv2-exact bilinear resize where their size differs.

    python -m feartracker_tpu_torch.tools.pretrain_trunk --data /data/imagenet/train --trunk fear_tiny \\
        --epochs 2 --out /tmp/tiny_trunk.npz
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from feartracker_tpu_torch.convert.load import flatten_variables, load_fear_net, variables_of
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.evaluate.harness import device_line, tool_device
from feartracker_tpu_torch.models.fbnet import TRUNKS, FBNetTrunk
from feartracker_tpu_torch.ops.resize import resize_linear_u8
from feartracker_tpu_torch.train.optim import apply_updates, build_optimizer
from feartracker_tpu_torch.train.step import params_of

IMAGE_SUFFIXES = ("*.jpg", "*.JPEG", "*.png", "*.npy")


def list_image_folder(root: str):
    """(paths, labels, class_names) for an ImageFolder layout."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for i, c in enumerate(classes):
        for p in sorted(sum((glob.glob(os.path.join(root, c, s)) for s in IMAGE_SUFFIXES), [])):
            paths.append(p)
            labels.append(i)
    if not paths:
        raise FileNotFoundError(f"no images under {root}/<class>/*.jpg")
    return paths, np.asarray(labels, np.int32), classes


class TrunkClassifier(nn.Module):
    """``encoder`` (an ``FBNetTrunk``) → spatial mean → ``cls_head``; NHWC
    in. The module name ``encoder`` makes the exported keys FEARNet's."""

    def __init__(self, trunk_name: str, num_classes: int):
        super().__init__()
        self.encoder = FBNetTrunk(TRUNKS[trunk_name])
        self.cls_head = nn.Linear(self.encoder.out_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cls_head(self.encoder(x).mean(dim=(1, 2)))


def load_classifier(model: TrunkClassifier, variables: Dict[str, Any]) -> TrunkClassifier:
    """Fill ``model`` from a JAX classifier's variables (flat '/'-joined or
    nested ``{"params", "batch_stats"}``): the trunk as FEARNet's, the Dense
    head's (in, out) kernel transposed to ``nn.Linear``'s (out, in)."""
    flat = variables if all("/" in k for k in variables) else flatten_variables(variables)
    flat = {k: np.asarray(v).T if k == "params/cls_head/kernel" else v for k, v in flat.items()}
    return load_fear_net(model, flat)


def trunk_variables(model: TrunkClassifier) -> Dict[str, np.ndarray]:
    """The ``params/encoder/...`` and ``batch_stats/encoder/...`` arrays,
    float32, with the JAX package's names and layouts."""
    return {k: v for k, v in variables_of(model).items() if "encoder" in k.split("/")}


def load_image(path: str, size: int) -> np.ndarray:
    """An RGB image as float32 in [0, 1] at ``size``²: decoded by
    ``read_img``, resized as ``cv2.resize(INTER_LINEAR)`` where it differs."""
    img = read_img(path)
    if img.shape[:2] != (size, size):
        img = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(img)), (size, size)).numpy()
    return img.astype(np.float32) / 255.0


def run(data_root: str, trunk: str, out: str, epochs: int = 2, batch_size: int = 32, image_size: int = 128,
        lr: float = 1e-3, seed: int = 0, log_every: int = 20, device="cuda",
        init_variables: Optional[Dict[str, Any]] = None) -> dict:
    """Pretrain and export; each epoch's last batch loss and accuracy (JAX
    keeps those) printed as a JSON line. ``init_variables`` replaces the
    seeded initialisation (a JAX classifier's, through
    :func:`load_classifier`). → ``{"history", "classes", "arrays", "steps"}``."""
    device = torch.device(device)
    paths, labels, classes = list_image_folder(data_root)
    print(json.dumps({"pretrain": data_root, "images": len(paths), "classes": len(classes), "trunk": trunk}),
          flush=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TrunkClassifier(trunk, len(classes))
    if init_variables is not None:
        load_classifier(model, init_variables)
    model.to(device).train()
    params = params_of(model)
    tx = build_optimizer({"name": "adam", "lr": lr})
    opt_state = tx.init(params)

    drng = np.random.RandomState(seed)
    n = len(paths)
    history = []
    it = 0
    loss = acc = None
    for epoch in range(epochs):
        order = drng.permutation(n)
        for b0 in range(0, n - batch_size + 1, batch_size):
            idx = order[b0:b0 + batch_size]
            images = torch.from_numpy(np.stack([load_image(paths[i], image_size) for i in idx])).to(device)
            y = torch.from_numpy(labels[idx].astype(np.int64)).to(device)
            logits = model(images)
            loss = F.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss, list(params.values()))
            updates, opt_state = tx.update(dict(zip(params, grads)), opt_state, params)
            apply_updates(params, updates)
            loss, acc = loss.detach(), (logits.detach().argmax(-1) == y).float().mean()
            it += 1
            if it % log_every == 0:
                print(f"[pretrain] epoch {epoch} it {it}: loss {float(loss):.4f} acc {float(acc):.3f}", flush=True)
        if loss is None:
            raise ValueError(f"{n} images make no batch of {batch_size}")
        history.append({"epoch": epoch, "loss": float(loss), "acc": float(acc)})
        print(json.dumps(history[-1]), flush=True)

    flat = trunk_variables(model)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, **flat)
    print(json.dumps({"exported": out, "arrays": len(flat), "steps": it}), flush=True)
    return {"history": history, "classes": classes, "arrays": len(flat), "steps": it}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True, help="ImageFolder root: <root>/<class>/*.{jpg,png,npy}")
    ap.add_argument("--trunk", default="fear_xs")
    ap.add_argument("--out", required=True, help="output .npz (trunk prefix only)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--image_size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.data, args.trunk, args.out, epochs=args.epochs, batch_size=args.batch_size,
          image_size=args.image_size, lr=args.lr, seed=args.seed, device=device)


if __name__ == "__main__":
    main()
