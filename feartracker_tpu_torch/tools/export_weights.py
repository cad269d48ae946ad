"""Export FEARNet variables to a self-contained ``.npz`` archive. The
counterpart of ``tools/export_weights.py``.

``--weights_path`` takes every source ``convert/load.py:load_variables``
reads (an ``.npz`` or a bare zoo name, a reference Lightning ``.ckpt``, a
CoreML ``.mlmodel``; by default ``$FEAR_WEIGHTS`` or the packaged
``fear_xs.npz``; an Orbax checkpoint of the JAX trainer, read in Python
and numpy), and also a training checkpoint of the port
(``train/checkpoint.py``: a step or ``last/`` directory, or its
``state.pt``), whose model is mapped as ``convert/load.py:variables_of``
maps a model. Any other directory raises ``load_variables``'s
``FileNotFoundError``, which lists the Orbax paths it tried. The archive
holds JAX's flat keys (``params/...``, ``batch_stats/...``), as JAX's
``save_npz`` writes them, and loads in both packages.

    python -m feartracker_tpu_torch.tools.export_weights --weights_path runs/exp/checkpoints/last --out exp.npz
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from feartracker_tpu_torch.convert.load import default_weights_path, load_variables, variables_of_state_dict
from feartracker_tpu_torch.train.checkpoint import STATE_FILE


def read_variables(path: str, channels: int = 256, towernum: int = 2) -> Dict[str, np.ndarray]:
    """The flat variables dict of ``path``: a port training checkpoint's
    model, else whatever :func:`load_variables` reads."""
    state_file = os.path.join(path, STATE_FILE) if os.path.isdir(path) else path
    if os.path.basename(state_file) == STATE_FILE and os.path.isfile(state_file):
        state = torch.load(state_file, map_location="cpu", weights_only=True)
        return variables_of_state_dict(state["model"])
    return load_variables(path, channels=channels, towernum=towernum)


def save_npz(variables: Dict[str, np.ndarray], out_path: str) -> None:
    """The flat dict as a compressed archive, one array per '/'-joined key."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez_compressed(out_path, **{k: np.asarray(v) for k, v in variables.items()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights_path", default=default_weights_path())
    ap.add_argument("--out", required=True)
    ap.add_argument("--adjust_channels", type=int, default=256)
    ap.add_argument("--towernum", type=int, default=2)
    args = ap.parse_args(argv)

    save_npz(read_variables(args.weights_path, args.adjust_channels, args.towernum), args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 2**20:.1f} MB)")


if __name__ == "__main__":
    main()
