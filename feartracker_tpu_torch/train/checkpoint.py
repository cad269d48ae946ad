"""Top-k training checkpoints, the counterpart of
``feartracker_tpu/train/checkpoint.py``: each checkpoint the port writes
is a ``torch.save`` of the train state's dicts of tensors (model parameters
and BatchNorm statistics, the optimizer's state, the step), read back with
``weights_only=True``.

Layout, as the JAX manager's: ``<dir>/<step>/`` for a ranked checkpoint
(``state.pt`` and ``metrics.json``), ``<dir>/last/`` for the last one
(``state.pt`` and the caller's ``meta.json``). Ranking follows Orbax's
``best_fn`` with ``max_to_keep``: the ``max_to_keep`` best monitored values
stay; between equal values the later step ranks higher.

The JAX trainer's own checkpoints in the same directory are read too, so a
run of the JAX package resumes on the card: where a ``state.pt`` is absent,
:meth:`CheckpointManager.restore_last` reads the Orbax save in
``last/state/`` and :meth:`CheckpointManager.restore` the one in
``<step>/default/`` (``convert/orbax.py``, Python and numpy alone), mapped
onto the port's state by ``convert/load.py`` (the weights as
``load_fear_net`` maps them, the optax state by
``optimizer_state_from_jax``, which needs the manager's ``optimizer``).
The JAX run's ranked steps (``<step>/metrics/metrics``) rank beside the
port's. Where both a ``state.pt`` and an Orbax save are present, the
``state.pt`` wins.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
ORBAX_METRICS = os.path.join("metrics", "metrics")  # the JAX manager's ranked steps


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
        optimizer=None,
    ):
        """``optimizer`` (the port's ``Optimizer``) is needed only to
        restore a JAX Orbax state: it says where each part of the optax
        chain sits."""
        if metric_mode not in ("max", "min"):
            raise ValueError(f"metric_mode must be 'max' or 'min', got {metric_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.metric_mode = metric_mode
        self.save_last = save_last
        self.optimizer = optimizer
        self._last_dir = os.path.join(self.directory, "last")
        self._ranked: List[Tuple[int, float]] = self._scan()

    def _scan(self) -> List[Tuple[int, float]]:
        """(step, monitor) of the ranked checkpoints already on disk."""
        found = []
        for name in os.listdir(self.directory):
            for metrics in (METRICS_FILE, ORBAX_METRICS):
                path = os.path.join(self.directory, name, metrics)
                if name.isdigit() and os.path.exists(path):
                    with open(path) as fh:
                        found.append((int(name), float(json.load(fh)["monitor"])))
                    break
        return sorted(found)

    def _sorted(self) -> List[Tuple[int, float]]:
        """Ranked checkpoints, worst first; between equal values the later
        step ranks higher."""
        sign = 1.0 if self.metric_mode == "max" else -1.0
        return sorted(self._ranked, key=lambda sm: (sign * sm[1], sm[0]))

    def has_last(self) -> bool:
        return (os.path.exists(os.path.join(self._last_dir, STATE_FILE))
                or os.path.exists(os.path.join(self._last_dir, "state", "_METADATA")))

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

    def _load(self, directory: str, orbax_item: str, state_like):
        path = os.path.join(directory, STATE_FILE)
        if os.path.exists(path):
            return state_like.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        orbax_dir = os.path.join(directory, orbax_item)
        if not os.path.exists(os.path.join(orbax_dir, "_METADATA")):
            raise FileNotFoundError(f"no checkpoint in {directory}: neither {STATE_FILE} nor an Orbax "
                                    f"{orbax_item}/")
        return self._load_orbax(orbax_dir, state_like)

    def _load_orbax(self, path: str, state_like):
        """A JAX ``TrainState`` saved by Orbax → ``state_like``, in place."""
        from feartracker_tpu_torch.convert.load import load_fear_net, optimizer_state_from_jax
        from feartracker_tpu_torch.convert.orbax import read_orbax_tree

        if self.optimizer is None:
            raise ValueError(f"restoring the JAX Orbax state {path} needs the optimizer: "
                             "CheckpointManager(..., optimizer=build_optimizer(config))")
        tree = read_orbax_tree(path)
        opt_state = optimizer_state_from_jax(tree["opt_state"], self.optimizer)
        load_fear_net(state_like.model, {"params": tree["params"], "batch_stats": tree["batch_stats"]})
        return state_like.load_state_dict({"model": state_like.model.state_dict(), "opt_state": opt_state,
                                           "step": int(tree["step"])})

    def restore(self, state_like, step: Optional[int] = None):
        """Load the ``step`` checkpoint (the best one by default) into
        ``state_like``'s tensors and return it."""
        step = self.best_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no ranked checkpoint in {self.directory}")
        return self._load(os.path.join(self.directory, str(int(step))), "default", state_like)

    def restore_last(self, state_like):
        return self._load(self._last_dir, "state", state_like)
