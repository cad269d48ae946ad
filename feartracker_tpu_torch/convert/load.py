"""Weights bridge: every weight source a user holds → the flat variables
dict → a port ``FEARNet``.

:func:`load_variables` reads each source into one flat numpy dict, the JAX
package's variables with '/'-joined keys, and :func:`load_fear_net` fills a
``FEARNet`` from it, so every format crosses one bridge:

* a ``.npz`` archive of the JAX package (``tools/export_weights.py``) or a
  bare model-zoo name;
* ``.ckpt``: a reference PyTorch-Lightning checkpoint
  (:mod:`feartracker_tpu_torch.convert.lightning`);
* anything else: the reference's CoreML ``.mlmodel`` export
  (:mod:`feartracker_tpu_torch.convert.fear_weights`);
* a directory: a training checkpoint of the JAX trainer (Orbax), read in
  Python and numpy by :mod:`feartracker_tpu_torch.convert.orbax`.

The archives are flat ``{"params/<flax path>/<leaf>": array,
"batch_stats/<flax path>/<leaf>": array}`` files, read with numpy alone. The
port's modules carry the Flax names, so each key maps mechanically:

* ``params/.../kernel`` (HWIO) → ``....weight`` (OIHW): a depthwise
  ``(k,k,1,C)`` becomes ``(C,1,k,k)``, a 1×1 ``(1,1,Cin,Cout)`` becomes
  ``(Cout,Cin,1,1)``;
* ``params/.../bn/scale`` → ``....bn.weight``; every other ``bias`` stays
  ``bias``;
* ``batch_stats/.../mean|var`` → ``running_mean|running_var``;
* the scalar params ``adjust``, ``bias`` (1,1,1,4), ``cls_scale`` and
  ``template_gate`` keep their names and shapes.

An optax state of the JAX ``build_optimizer`` chain crosses the same map
onto the port optimizer's state (:func:`optimizer_state_from_jax`): the
moments (``mu``/``nu`` or ``trace``, trees shaped as ``params``) by
parameter name, the counts and the injected learning rate as they are, so
that training goes on from a JAX state.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGED_FEAR_XS = os.path.join(REPO_ROOT, "feartracker_tpu", "weights", "fear_xs.npz")
# names the reference's CoreML export (``Tracker.mlmodel``) where a user has
# it; the default weights come from inside the checkout otherwise
WEIGHTS_ENV = "FEAR_WEIGHTS"

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def resolve_weights(path: str) -> str:
    """A bare model-zoo name ("fear_xs", "fear_xs_gate") → its packaged
    archive; any other path is returned as it is."""
    zoo = os.path.join(os.path.dirname(PACKAGED_FEAR_XS), f"{path}.npz")
    if os.sep not in path and os.path.exists(zoo):
        return zoo
    return path


def variables_from_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat ``{"params/...": ndarray, "batch_stats/...": ndarray}`` dict
    of an archive path or a bare zoo name (:func:`resolve_weights`)."""
    with np.load(resolve_weights(path)) as z:
        return {k: z[k] for k in z.files}


def default_weights_path() -> str:
    """The default ``--weights_path`` of the CLI, the demo and the export:
    the path in ``$FEAR_WEIGHTS`` when the user sets it (the reference's
    ``Tracker.mlmodel``, or any format :func:`load_variables` reads), else
    the packaged ``fear_xs.npz`` (the same weights, recovered from it)."""
    return os.environ.get(WEIGHTS_ENV) or PACKAGED_FEAR_XS


def flatten_variables(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested ``{"params": {...}, "batch_stats": {...}}`` → the flat dict
    with '/'-joined keys."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(flatten_variables(v, f"{prefix}{k}/"))
    return out


def variables_of(model: nn.Module) -> Dict[str, np.ndarray]:
    """A port model's weights as the flat variables dict, the inverse of
    :func:`load_fear_net`: Flax names, HWIO kernels, float32 numpy on the
    host. ``load_fear_net(m, variables_of(model))`` copies ``model`` into
    ``m`` exactly."""
    return variables_of_state_dict(model.state_dict())


def variables_of_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """:func:`variables_of` of a port model's ``state_dict`` (a training
    checkpoint's ``model``), without the model: a BatchNorm is the module
    that holds running statistics, as every one of the port's does."""
    bn = {name.rsplit(".", 1)[0] for name in state if name.endswith(".running_mean")}
    out: Dict[str, np.ndarray] = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().float().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf[len("running_"):]
        else:
            collection = "params"
            if leaf == "weight":
                leaf = "scale" if ".".join(path) in bn else "kernel"
                if arr.ndim == 4:
                    arr = arr.transpose(2, 3, 1, 0)  # OIHW → HWIO
        out["/".join([collection] + path + [leaf])] = arr
    return out


def transfer_variables(loaded: Dict[str, Any], target: Dict[str, Any]
                       ) -> "tuple[Dict[str, np.ndarray], Dict[str, list]]":
    """Non-strict weight transfer, as the JAX package's: copy every leaf
    whose path and shape match the target (cast to the target leaf's
    dtype), keep the target's own value elsewhere.

    ``loaded`` and ``target`` are variables dicts, flat (:func:`variables_of`,
    :func:`variables_from_npz`) or nested. Returns ``(merged, report)``:
    ``merged`` is flat and holds the target's keys in the target's order;
    ``report`` lists '/'-joined keys under ``transferred``,
    ``skipped_shape`` (path match, shape mismatch: kept), ``missing`` (in
    the target only: kept) and ``unused`` (in the source only: dropped,
    sorted)."""
    flat_t = target if all("/" in k for k in target) else flatten_variables(target)
    flat_l = loaded if all("/" in k for k in loaded) else flatten_variables(loaded)
    report: Dict[str, list] = {"transferred": [], "skipped_shape": [], "missing": [], "unused": []}
    merged: Dict[str, np.ndarray] = {}
    for k, v in flat_t.items():
        if k in flat_l:
            if tuple(np.shape(flat_l[k])) == tuple(np.shape(v)):
                # a float16/float64 source must not smuggle another precision in
                merged[k] = np.asarray(flat_l[k], np.asarray(v).dtype)
                report["transferred"].append(k)
            else:
                merged[k] = v
                report["skipped_shape"].append(k)
        else:
            merged[k] = v
            report["missing"].append(k)
    report["unused"] = sorted(k for k in flat_l if k not in flat_t)
    return merged, report


def load_variables(path: str, channels: int = 256, towernum: int = 2,
                   trust_pickle: bool = False) -> Dict[str, np.ndarray]:
    """The flat variables dict of any weight source (see the module
    docstring), dispatched as the JAX package's ``load_variables``:
    a bare zoo name or ``.npz``, a directory (an Orbax checkpoint of the
    JAX trainer: its state dir, ``checkpoints`` root, experiment dir or
    managed step dir, as ``convert/orbax.py:load_orbax_variables`` resolves
    them), a ``.ckpt``, else a CoreML ``.mlmodel``. ``channels`` /
    ``towernum`` shape the ``.ckpt`` and ``.mlmodel`` importers;
    ``trust_pickle`` lets a ``.ckpt`` that holds more than tensors and plain
    values be unpickled in full (see ``lightning.load_lightning_state_dict``)."""
    path = resolve_weights(path)
    if os.path.isdir(path):
        from feartracker_tpu_torch.convert.orbax import load_orbax_variables

        return flatten_variables(load_orbax_variables(path))
    if path.endswith(".ckpt"):
        from feartracker_tpu_torch.convert.lightning import load_from_lightning

        return load_from_lightning(path, channels=channels, towernum=towernum, trust_pickle=trust_pickle)
    if path.endswith(".npz"):
        return variables_from_npz(path)
    from feartracker_tpu_torch.convert.fear_weights import load_fear_xs

    return load_fear_xs(path, channels=channels, towernum=towernum)


def torch_key(flax_key: str) -> str:
    """'params/encoder/stem/conv/kernel' → 'encoder.stem.conv.weight'."""
    collection, *path, leaf = flax_key.split("/")
    return ".".join(path + [_LEAF.get((collection, leaf), leaf)])


def _torch_array(key: str, arr: Any) -> np.ndarray:
    """A Flax leaf as the port's tensor layout (HWIO kernels → OIHW)."""
    arr = np.asarray(arr, np.float32)
    if key.endswith("/kernel") and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    return arr


def _moments(tree: Any) -> Dict[str, torch.Tensor]:
    """A tree shaped as ``params`` (nested or flat) → float32 tensors keyed
    by the port's parameter names, in the port's layout."""
    flat = tree if all("/" in k for k in tree) else flatten_variables(tree)
    return {torch_key("params/" + k): torch.tensor(_torch_array(k, v)) for k, v in flat.items()}


def _scalar(value: Any, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(value).item(), dtype=dtype)


def _hyperparams_state(tree: Any) -> Any:
    """The injected-hyperparameters state anywhere in a restored optax
    state, found as ``feartracker_tpu/train/optim.py:_hyperparams_state``
    finds it (the chain's wrappers move it)."""
    if isinstance(tree, dict):
        if "hyperparams" in tree:
            return tree
        children = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    else:
        return None
    for child in children:
        found = _hyperparams_state(child)
        if found is not None:
            return found
    return None


def optimizer_state_from_jax(opt_tree: Any, optimizer) -> Dict[str, Any]:
    """The port optimizer's state (``train/optim.py``: ``lr``,
    ``count``/``mu``/``nu`` or ``trace``, ``warmup_count``,
    ``notfinite_count``/``last_finite``/``total_notfinite``) from the optax
    state of the JAX ``build_optimizer`` chain with the same config, as an
    Orbax restore returns it (namedtuples as dicts, tuples as lists) or as
    numpy trees of the same shape.

    ``optimizer`` is the port's ``Optimizer``; its rule, warmup, clip and
    skip say where each part of the chain sits:
    ``apply_if_finite(chain(clip, chain(inject_hyperparams(rule),
    scale_by_schedule)))``, each wrapper present only when configured.
    Raises ``ValueError`` when the tree is not that chain's state. The
    tensors are on the CPU; ``TrainState.load_state_dict`` copies them onto
    the state's device."""
    def need(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(f"optax state is not the {optimizer.name} chain of this config "
                             f"(warmup {optimizer.warmup}, clip {optimizer.clip}, skip {optimizer.skip}): {what}")

    out: Dict[str, Any] = {}
    node = opt_tree
    if optimizer.skip > 0:
        need(isinstance(node, dict) and {"notfinite_count", "last_finite", "total_notfinite", "inner_state"}
             <= set(node), "no apply_if_finite state")
        out.update(notfinite_count=_scalar(node["notfinite_count"], torch.int32),
                   last_finite=_scalar(node["last_finite"], torch.bool),
                   total_notfinite=_scalar(node["total_notfinite"], torch.int32))
        node = node["inner_state"]
    if optimizer.clip > 0:
        need(isinstance(node, (list, tuple)) and len(node) == 2 and node[0] is None,
             "no clip_by_global_norm state")
        node = node[1]
    if optimizer.warmup > 0:
        need(isinstance(node, (list, tuple)) and len(node) == 2 and isinstance(node[1], dict)
             and "count" in node[1], "no warmup schedule state")
        out["warmup_count"] = _scalar(node[1]["count"], torch.int32)
        node = node[0]
    inject = _hyperparams_state(opt_tree)
    need(inject is not None and inject is node, "the injected hyperparameters sit elsewhere")
    out["lr"] = _scalar(inject["hyperparams"]["learning_rate"], torch.float32)
    rule = inject["inner_state"][0]
    if optimizer.name == "sgd":
        need(isinstance(rule, dict) and "trace" in rule, "no momentum trace")
        out["trace"] = _moments(rule["trace"])
    else:
        need(isinstance(rule, dict) and {"count", "mu", "nu"} <= set(rule), "no Adam moments")
        out.update(count=_scalar(rule["count"], torch.int32), mu=_moments(rule["mu"]), nu=_moments(rule["nu"]))
    return out


def load_adam_state(opt_state: Dict[str, Any], mu: Any, nu: Any, count: Any) -> Dict[str, Any]:
    """Fill the port optimizer's Adam state (``build_optimizer({"name":
    "adam"})``'s ``mu``, ``nu``, ``count``) in place from an optax
    ``ScaleByAdamState``'s ``mu`` and ``nu`` (trees shaped as ``params``,
    nested or flat) and ``count``, through :func:`optimizer_state_from_jax`.
    Raises ``KeyError`` unless the moments cover the state's parameters
    exactly."""
    from feartracker_tpu_torch.train.optim import build_optimizer

    tree = {"hyperparams": {"learning_rate": opt_state["lr"].item()},
            "inner_state": [{"count": np.asarray(count), "mu": mu, "nu": nu}, None]}
    got = optimizer_state_from_jax(tree, build_optimizer({"name": "adam"}))
    for name in ("mu", "nu"):
        dst = opt_state[name]
        if set(got[name]) != set(dst):
            raise KeyError(f"{name} does not match the optimizer state: {sorted(set(got[name]) ^ set(dst))}")
        for k, v in got[name].items():
            dst[k].copy_(v)
    opt_state["count"].fill_(int(got["count"]))
    return opt_state


def load_fear_net(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Fill ``model`` from the JAX package's variables as numpy arrays, flat
    (:func:`variables_from_npz`) or nested ``{"params", "batch_stats"}``.

    Raises ``KeyError`` on any key of the model left unfilled or any array
    left over, and ``ValueError`` on a shape mismatch.
    """
    flat = variables if all("/" in k for k in variables) else flatten_variables(variables)
    state = model.state_dict()
    wanted = {k for k in state if not k.endswith("num_batches_tracked")}
    loaded: Dict[str, torch.Tensor] = {}
    leftover = []
    for key, arr in flat.items():
        name = torch_key(key)
        if name not in wanted:
            leftover.append(key)
            continue
        arr = _torch_array(key, arr)
        if tuple(arr.shape) != tuple(state[name].shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(state[name].shape)} of {name}")
        loaded[name] = torch.tensor(arr)  # a copy: the source may be read-only
    missing = sorted(wanted - set(loaded))
    if missing or leftover:
        raise KeyError(f"weights do not match the model: missing {missing}, leftover {sorted(leftover)}")
    state.update(loaded)
    model.load_state_dict(state)
    return model
