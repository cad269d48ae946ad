"""Optimizer and learning-rate schedule, the counterpart of
``feartracker_tpu/train/optim.py``: the optax chain that the JAX package
builds, computed with the same formulas in the same order, so that the same
gradients give the same updates (``torch.optim.Adam`` divides in another
order, and ``clip_grad_norm_`` adds 1e-6 to the norm):

    apply_if_finite(                      # skip_non_finite > 0
      chain(clip_by_global_norm(c),       # gradient_clip_val > 0
            inject_hyperparams(rule)(lr), # adam | adamw | sgd (nesterov)
            scale_by_schedule(linear 0 → 1 over warmup_steps)))

* the rule's update is ``(−lr)·u``; the warmup multiplier's count starts
  at 0, so the first update is zero, as in optax;
* ``apply_if_finite``: a step whose gradients hold a NaN or an Inf leaves
  the parameters (a zero update) *and* every other part of the state
  untouched, unless ``skip_non_finite`` such steps came in a row.

The state is a dict of tensors on the parameters' device, with the
moments keyed by parameter name: ``lr`` (the injected learning rate, which
:class:`PlateauScheduler` moves between epochs without a new step function),
``count``/``mu``/``nu`` (adam, adamw), ``trace`` (sgd), ``warmup_count``,
and ``notfinite_count``/``last_finite``/``total_notfinite``. Every update is
computed on the device: no step waits for the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
_INT32_MAX = 2**31 - 1


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < _INT32_MAX, count + 1, count)


class Optimizer:
    """A functional optimizer: ``init(params)`` → state,
    ``update(grads, state, params)`` → (updates, new state). ``params`` and
    ``grads`` are dicts of tensors keyed by parameter name."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = dict(config or {})
        self.name = config.get("name", "adam")
        if self.name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.name!r}")
        self.lr = float(config.get("lr", 1e-4))
        self.warmup = int(config.get("warmup_steps", 0))
        self.clip = float(config.get("gradient_clip_val", 0.0))
        self.skip = int(config.get("skip_non_finite", 0))
        self.b1, self.b2 = 0.9, 0.999
        self.eps = float(config.get("eps", 1e-8)) if self.name == "adamw" else 1e-8
        self.weight_decay = float(config.get("weight_decay", 0.0))
        self.momentum = float(config.get("momentum", 0.0))
        self.nesterov = bool(config.get("nesterov", False))

    # -- state ----------------------------------------------------------------

    def init(self, params: Tensors) -> Dict[str, Any]:
        dev = next(iter(params.values())).device
        i32 = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        state: Dict[str, Any] = {"lr": torch.tensor(self.lr, dtype=torch.float32, device=dev)}
        if self.name == "sgd":
            state["trace"] = zeros()
        else:
            state.update(count=i32(), mu=zeros(), nu=zeros())
        if self.warmup > 0:
            state["warmup_count"] = i32()
        if self.skip > 0:
            state.update(notfinite_count=i32(), total_notfinite=i32(),
                         last_finite=torch.ones((), dtype=torch.bool, device=dev))
        return state

    # -- the chain --------------------------------------------------------------

    def _clip(self, g: List[torch.Tensor]) -> List[torch.Tensor]:
        """``clip_by_global_norm``: (g / ‖g‖)·c where ‖g‖ ≥ c."""
        norms = torch._foreach_norm(g, 2)
        g_norm = torch.sqrt(torch.stack(torch._foreach_mul(norms, norms)).sum())
        trigger = g_norm < self.clip
        clipped = torch._foreach_mul(torch._foreach_div(g, g_norm), self.clip)
        return [torch.where(trigger, a, b) for a, b in zip(g, clipped)]

    def _adam(self, g, state, p) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        keys = list(state["mu"])
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul([state["mu"][k] for k in keys], self.b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
                                torch._foreach_mul([state["nu"][k] for k in keys], self.b2))
        count = _safe_increment(state["count"])
        c = count.float()
        bc1 = 1 - torch.pow(self.b1, c)
        bc2 = 1 - torch.pow(self.b2, c)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        if self.name == "adamw":
            u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        new = dict(state, count=count, mu=dict(zip(keys, mu)), nu=dict(zip(keys, nu)))
        return u, new

    def _sgd(self, g, state) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        keys = list(state["trace"])
        trace = torch._foreach_add(g, torch._foreach_mul([state["trace"][k] for k in keys], self.momentum))
        u = torch._foreach_add(g, torch._foreach_mul(trace, self.momentum)) if self.nesterov else trace
        return u, dict(state, trace=dict(zip(keys, trace)))

    def _warmup(self, u, state) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        """``scale_by_schedule(linear_schedule(0, 1, warmup))``."""
        count = state["warmup_count"]
        frac = 1 - torch.clamp(count, 0, self.warmup).float() / self.warmup
        step_size = (0.0 - 1.0) * frac + 1.0
        return torch._foreach_mul(u, step_size), dict(state, warmup_count=_safe_increment(count))

    def _inner(self, g, state, p):
        if self.clip > 0:
            g = self._clip(g)
        if self.name == "sgd":
            u, new = self._sgd(g, state)
        else:
            u, new = self._adam(g, state, p)
        u = torch._foreach_mul(u, -state["lr"])
        if self.warmup > 0:
            u, new = self._warmup(u, new)
        return u, new

    def update(self, grads: Tensors, state: Dict[str, Any], params: Tensors) -> Tuple[Tensors, Dict[str, Any]]:
        keys = list(grads)
        g = [grads[k] for k in keys]
        p = [params[k] for k in keys]
        if self.skip <= 0:
            u, new = self._inner(g, state, p)
            return dict(zip(keys, u)), new
        isfinite = torch.isfinite(torch.stack(torch._foreach_norm(g, float("inf")))).all()
        notfinite_count = torch.where(isfinite, torch.zeros_like(state["notfinite_count"]),
                                      _safe_increment(state["notfinite_count"]))
        ok = isfinite | (notfinite_count > self.skip)
        u, inner = self._inner(g, state, p)
        u = [torch.where(ok, a, torch.zeros_like(a)) for a in u]
        new = _select(ok, inner, state)
        new.update(
            notfinite_count=notfinite_count,
            last_finite=isfinite,
            total_notfinite=torch.where(isfinite, state["total_notfinite"],
                                        _safe_increment(state["total_notfinite"])),
        )
        return dict(zip(keys, u)), new


def _select(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """``torch.where(ok, new, old)`` over a state's tensors."""
    if isinstance(new, dict):
        return {k: _select(ok, new[k], old[k]) for k in new}
    return torch.where(ok, new, old)


def build_optimizer(config: Optional[Dict[str, Any]] = None) -> Optimizer:
    """The optimizer of a config's ``optimizer`` section: ``name`` (adam,
    adamw, sgd), ``lr`` (1e-4), ``warmup_steps``, ``gradient_clip_val``,
    ``skip_non_finite``, and the rule's own keys (``eps``,
    ``weight_decay``, ``momentum``, ``nesterov``)."""
    return Optimizer(config)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``params += updates``, in place, in one foreach launch."""
    keys = list(updates)
    torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])


def get_learning_rate(opt_state: Dict[str, Any]) -> float:
    """The injected learning rate (a read from the device)."""
    return float(opt_state["lr"])


def set_learning_rate(opt_state: Dict[str, Any], lr: float) -> Dict[str, Any]:
    opt_state["lr"].fill_(lr)
    return opt_state


class PlateauScheduler:
    """ReduceLROnPlateau: factor .5, patience 5, min_lr 1e-6, mode "max" or
    "min"."""

    def __init__(self, mode: str = "max", factor: float = 0.5, patience: int = 5, min_lr: float = 1e-6):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, metric: float, current_lr: float) -> float:
        """Feed an epoch-level metric; returns the (possibly reduced) lr."""
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best)
            or (self.mode == "min" and metric < self.best)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
            return current_lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(self.min_lr, current_lr * self.factor)
        return current_lr
