"""Weights for both sides of a run, read once from the configuration's
checkpoint (a flat npz keyed as the released checkpoints are) and handed to
the program and to the reference as the same arrays."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from portbench.harness import ROOT


def read_npz(relpath: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(ROOT, relpath)) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def reference_weights(flat: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The checkpoint as float32 tensors on ``device``, in one copy."""
    keys = sorted(flat)
    sizes = [flat[k].size for k in keys]
    buf = torch.from_numpy(np.concatenate([flat[k].ravel() for k in keys])).to(device)
    return {k: v.view(flat[k].shape) for k, v in zip(keys, torch.split(buf, sizes))}


def program_model(cfg: Dict, flat: Dict[str, np.ndarray]):
    """The program's ``FEARNet`` at the configuration's trunk table, filled
    from the checkpoint through the program's own loader."""
    from feartracker_tpu_torch.convert.load import load_fear_net
    from feartracker_tpu_torch.models.fbnet import IRBlockSpec
    from feartracker_tpu_torch.models.fear_net import FEARNet

    net = FEARNet(tuple(IRBlockSpec(*b) for b in cfg["trunk"]), cfg["adjust_channels"], cfg["towernum"],
                  cfg["template_size"])
    return load_fear_net(net, flat)
