"""Seeded weights for a configuration with no trained checkpoint in the
repository: its ``weights`` file states the draw (``kind: seeded``), and
every run draws the same tensors from its ``--seed`` on its device, once,
for the program and the reference alike."""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Sequence

import torch

from portbench import clips
from portbench.harness import ROOT


def read_spec(relpath: str) -> Dict:
    with open(os.path.join(ROOT, relpath)) as fh:
        spec = json.load(fh)
    if spec.get("kind") != "seeded":
        raise ValueError(f"{relpath}: not a seeded draw")
    return spec


def draw(spec: Dict, shapes: Dict[str, Sequence[int]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 tensors of ``shapes`` on ``device``, drawn in the sorted order
    of their names from one generator seeded with ``seed``: for each name,
    the first rule whose pattern it matches gives the mean and the std (or
    ``gain``: std = gain / sqrt(fan_in))."""
    g = clips.generator(seed, device)
    out = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        rule = next((r for r in spec["rules"] if re.search(r[0], name)), None)
        if rule is None:
            raise KeyError(f"no rule draws {name}")
        _, mean, kind, value = rule
        std = value if kind == "std" else value / math.sqrt(math.prod(shape[1:]) if len(shape) > 1 else 1)
        out[name] = mean + std * torch.randn(shape, generator=g, device=device)
    return out
