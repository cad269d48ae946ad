"""Top-k training checkpoints, the counterpart of
``feartracker_tpu/train/checkpoint.py`` without Orbax (the card host has
none): each checkpoint is a ``torch.save`` of the train state's dicts of
tensors (model parameters and BatchNorm statistics, the optimizer's state,
the step), read back with ``weights_only=True``.

Layout, as the JAX manager's: ``<dir>/<step>/`` for a ranked checkpoint
(``state.pt`` and ``metrics.json``), ``<dir>/last/`` for the last one
(``state.pt`` and the caller's ``meta.json``). Ranking follows Orbax's
``best_fn`` with ``max_to_keep``: the ``max_to_keep`` best monitored values
stay; between equal values the later step ranks higher.

Reading the JAX trainer's Orbax directories is not ported: convert one to
an ``.npz`` with ``tools/export_weights.py`` and load it with
``convert/load.py``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _atomic_json(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        metric_mode: str = "max",
        save_last: bool = True,
    ):
        if metric_mode not in ("max", "min"):
            raise ValueError(f"metric_mode must be 'max' or 'min', got {metric_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.metric_mode = metric_mode
        self.save_last = save_last
        self._last_dir = os.path.join(self.directory, "last")
        self._ranked: List[Tuple[int, float]] = self._scan()

    def _scan(self) -> List[Tuple[int, float]]:
        """(step, monitor) of the ranked checkpoints already on disk."""
        found = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name, METRICS_FILE)
            if name.isdigit() and os.path.exists(path):
                with open(path) as fh:
                    found.append((int(name), float(json.load(fh)["monitor"])))
        return sorted(found)

    def _sorted(self) -> List[Tuple[int, float]]:
        """Ranked checkpoints, worst first; between equal values the later
        step ranks higher."""
        sign = 1.0 if self.metric_mode == "max" else -1.0
        return sorted(self._ranked, key=lambda sm: (sign * sm[1], sm[0]))

    def has_last(self) -> bool:
        return os.path.exists(os.path.join(self._last_dir, STATE_FILE))

    def save(self, step: int, state, monitor: Optional[float], extra: Optional[Dict[str, Any]] = None) -> None:
        """Save 'last' always (when ``save_last``); rank the step among the
        top-k only when a monitored value comes with it. ``extra`` is a small
        JSON-able dict (epoch, loader counters) kept beside the last state."""
        d = state.state_dict()
        if monitor is not None:
            step_dir = os.path.join(self.directory, str(int(step)))
            os.makedirs(step_dir, exist_ok=True)
            _atomic_save(d, os.path.join(step_dir, STATE_FILE))
            _atomic_json({"monitor": float(monitor)}, os.path.join(step_dir, METRICS_FILE))
            self._ranked = [sm for sm in self._ranked if sm[0] != int(step)] + [(int(step), float(monitor))]
            ranked = self._sorted()
            for old_step, _ in ranked[: max(0, len(ranked) - self.max_to_keep)]:
                shutil.rmtree(os.path.join(self.directory, str(old_step)), ignore_errors=True)
            self._ranked = sorted(ranked[max(0, len(ranked) - self.max_to_keep):])
        if self.save_last:
            os.makedirs(self._last_dir, exist_ok=True)
            _atomic_save(d, os.path.join(self._last_dir, STATE_FILE))
            if extra is not None:
                _atomic_json(extra, os.path.join(self._last_dir, "meta.json"))

    def load_meta(self) -> Optional[Dict[str, Any]]:
        """The ``extra`` dict of the last checkpoint; None when absent or
        unreadable."""
        path = os.path.join(self._last_dir, "meta.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                return json.load(fh)
        except (json.JSONDecodeError, ValueError, OSError):
            return None

    def steps(self) -> List[int]:
        """The ranked checkpoints' steps, ascending."""
        return [s for s, _ in self._ranked]

    def best_step(self) -> Optional[int]:
        ranked = self._sorted()
        return ranked[-1][0] if ranked else None

    @staticmethod
    def _load(path: str, state_like):
        d = torch.load(path, map_location="cpu", weights_only=True)
        return state_like.load_state_dict(d)

    def restore(self, state_like, step: Optional[int] = None):
        """Load the ``step`` checkpoint (the best one by default) into
        ``state_like``'s tensors and return it."""
        step = self.best_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no ranked checkpoint in {self.directory}")
        return self._load(os.path.join(self.directory, str(int(step)), STATE_FILE), state_like)

    def restore_last(self, state_like):
        return self._load(os.path.join(self._last_dir, STATE_FILE), state_like)
