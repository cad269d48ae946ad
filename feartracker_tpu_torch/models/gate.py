"""Feature-conditioned dual-template update gate ("gate v2"), the
counterpart of ``feartracker_tpu/models/gate.py``.

A tiny MLP over the per-frame observables the runtime already computes sets
each stream's EMA rate for the dynamic template:

    rate = sigmoid(MLP(obs)) * update_rate_max.

Observable vector (order is the on-disk contract, see OBS_FEATURES):
  0 confidence       — decoded peak score (0..1)
  1 apce             — log1p(APCE)/4 (peak sharpness, normalized)
  2 sim_static       — cosine(candidate feats, static template feats)
  3 sim_dyn          — cosine(candidate feats, current dynamic template)
  4 log_size_ratio   — 0.5·log(area_t/area_{t-1}), clipped to ±1
  5 center_shift     — |center_t − center_{t-1}| / sqrt(area_{t-1}), clip 2

Parameters are a dict ``{"w1", "b1", "w2", "b2"}`` of numpy arrays (as
saved) or tensors; the runtime moves them to its device once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

OBS_FEATURES = (
    "confidence",
    "apce",
    "sim_static",
    "sim_dyn",
    "log_size_ratio",
    "center_shift",
)
N_OBS = len(OBS_FEATURES)
DEFAULT_HIDDEN = 8
GATE_KEYS = ("w1", "b1", "w2", "b2")


def init_gate_params(rng: np.random.RandomState, hidden: int = DEFAULT_HIDDEN) -> Dict[str, np.ndarray]:
    """Small-init MLP params, numpy (the same draws as the JAX package)."""
    return {
        "w1": (rng.randn(N_OBS, hidden) * 0.3).astype(np.float32),
        "b1": np.zeros((hidden,), np.float32),
        "w2": (rng.randn(hidden, 1) * 0.3).astype(np.float32),
        "b2": np.zeros((1,), np.float32),
    }


def gate_params_to(params, device) -> Dict[str, torch.Tensor]:
    """The four gate arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(params[k], dtype=torch.float32, device=device) for k in GATE_KEYS}


def gate_logit(params, obs: torch.Tensor) -> torch.Tensor:
    """(S, N_OBS) observables → (S,) pre-sigmoid update logit."""
    p = gate_params_to(params, obs.device)  # a no-op for tensors already there
    h = torch.tanh(obs @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"])[..., 0]


def gate_rate(params, obs: torch.Tensor) -> torch.Tensor:
    """(S, N_OBS) → (S,) update probability in [0, 1] (the caller scales by
    its max EMA rate)."""
    return torch.sigmoid(gate_logit(params, obs))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine similarity of flattened feature maps: (S, ...) → (S,)."""
    af = a.reshape(a.shape[0], -1).float()
    bf = b.reshape(b.shape[0], -1).float()
    num = (af * bf).sum(-1)
    den = torch.linalg.vector_norm(af, dim=-1) * torch.linalg.vector_norm(bf, dim=-1) + 1e-8
    return num / den


def gate_observables(
    confidence: torch.Tensor,
    apce: torch.Tensor,
    cand_feats: torch.Tensor,
    template_feats: torch.Tensor,
    dyn_feats: torch.Tensor,
    bbox: torch.Tensor,
    prev_bbox: torch.Tensor,
) -> torch.Tensor:
    """Assemble the (S, N_OBS) float32 observable matrix (see the module
    docstring for the feature contract)."""
    area = torch.clamp(bbox[:, 2] * bbox[:, 3], min=1.0)
    prev_area = torch.clamp(prev_bbox[:, 2] * prev_bbox[:, 3], min=1.0)
    log_ratio = torch.clamp(0.5 * torch.log(area / prev_area), -1.0, 1.0)
    center = bbox[:, :2] + bbox[:, 2:] * 0.5
    prev_center = prev_bbox[:, :2] + prev_bbox[:, 2:] * 0.5
    shift = torch.clamp(
        torch.linalg.vector_norm(center - prev_center, dim=-1) / torch.sqrt(prev_area), 0.0, 2.0
    )
    return torch.stack(
        [
            confidence.float(),
            torch.log1p(apce.float()) / 4.0,
            _cosine(cand_feats, template_feats),
            _cosine(cand_feats, dyn_feats),
            log_ratio.float(),
            shift.float(),
        ],
        dim=-1,
    )


def save_gate(params, path: str) -> None:
    np.savez(path, **{k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float32)
                      for k, v in params.items()})


def load_gate(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        params = {k: z[k] for k in GATE_KEYS}
    if params["w1"].shape[0] != N_OBS:
        raise ValueError(
            f"gate file {path} expects {params['w1'].shape[0]} observables, "
            f"runtime provides {N_OBS}"
        )
    return params
