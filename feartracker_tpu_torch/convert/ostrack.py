"""OSTrack checkpoints → the port's :class:`~feartracker_tpu_torch.models.ostrack.OSTrack`.

OSTrack's trainer saves ``{"net": state_dict, "epoch": …, "settings": …}``
(``lib/train/trainers/base_trainer.py``); its tensors are named as the
modules of ``lib/models/ostrack`` name them (``backbone.pos_embed_z``,
``backbone.blocks.<i>.attn.qkv.weight``, ``box_head.conv1_ctr.0.weight``,
``box_head.conv1_ctr.1.running_var``, …). The port's model carries the same
names, so a checkpoint loads key for key. ``backbone.cls_token`` and
``backbone.pos_embed`` (the pretrained ViT's, from which ``pos_embed_z`` and
``pos_embed_x`` were made) are read by no step, and BatchNorm's
``num_batches_tracked`` by no inference: they are ignored. Any other key
missing or left over, or a shape that differs, raises.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from feartracker_tpu_torch.models.ostrack import OSTrack

IGNORED = ("backbone.cls_token", "backbone.pos_embed")


def _ignored(key: str) -> bool:
    return key in IGNORED or key.endswith("num_batches_tracked")


def read_ostrack_checkpoint(path: str, trust_pickle: bool = False) -> Dict[str, Any]:
    """A ``.npz`` of the flat tensors, or a ``torch.save`` file (OSTrack's
    ``.pth.tar``, or a bare state dict) → the flat dict. A pickle is read
    ``weights_only`` unless ``trust_pickle``: OSTrack's own checkpoints hold
    its settings objects beside ``net``, which only a trusted read unpickles."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    try:
        obj = torch.load(path, map_location="cpu", weights_only=not trust_pickle)
    except Exception as e:  # torch raises UnpicklingError for any object it refuses
        raise ValueError(f"{path}: not a plain state dict ({e}); pass trust_pickle=True for a checkpoint "
                         "you trust") from e
    return obj["net"] if isinstance(obj, dict) and "net" in obj else obj


@torch.no_grad()
def load_ostrack(model: OSTrack, flat: Dict[str, Any]) -> OSTrack:
    """Fill ``model`` from the flat dict keyed as OSTrack's checkpoints are
    (numpy arrays or tensors), in place; returns it."""
    state = model.state_dict()
    want = {k for k in state if not _ignored(k)}
    got = {k for k in flat if not _ignored(k)}
    if want != got:
        raise ValueError(f"OSTrack checkpoint: missing {sorted(want - got)[:8]}, unexpected {sorted(got - want)[:8]}")
    for k in sorted(want):
        src = torch.as_tensor(np.asarray(flat[k]) if not isinstance(flat[k], torch.Tensor) else flat[k])
        if tuple(src.shape) != tuple(state[k].shape):
            raise ValueError(f"OSTrack checkpoint: {k} is {tuple(src.shape)}, the model's {tuple(state[k].shape)}")
        state[k].copy_(src)
    return model
