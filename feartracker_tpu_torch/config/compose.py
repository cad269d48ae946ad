"""Layered YAML config composition, the counterpart of
``feartracker_tpu/config/compose.py`` with the same behaviour: defaults
lists, ``# @package _global_`` group files, ``${a.b}`` interpolation and
command-line ``group=option`` / ``key.path=value`` overrides (the Hydra
subset the reference uses). Files and override values are read with
:mod:`feartracker_tpu_torch.config.yaml_lite`, which types every scalar as
PyYAML's ``safe_load`` does; the card host has no PyYAML. Config groups
live in ``feartracker_tpu_torch/config/conf/``.

Usage:
    cfg = load_config(config_name="fear_tracker",
                      overrides=["backend=cpu", "batch_size.train=64"])
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Sequence

from feartracker_tpu_torch.config import yaml_lite

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "conf")
_GLOBAL_PACKAGE_RE = re.compile(r"^#\s*@package\s+_global_\s*$", re.MULTILINE)
_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _read_yaml(path: str):
    with open(path, "r") as fh:
        text = fh.read()
    data = yaml_lite.load(text) or {}
    is_global = bool(_GLOBAL_PACKAGE_RE.search(text))
    return data, is_global


def _deep_merge(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _get_path(cfg: Dict[str, Any], dotted: str):
    cur: Any = cfg
    for part in dotted.split("."):
        if isinstance(cur, list) and part.isdigit() and int(part) < len(cur):
            cur = cur[int(part)]
        elif isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            raise KeyError(f"interpolation/override path not found: {dotted!r}")
    return cur


def _set_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    """Set a dotted path; numeric segments index into lists (Hydra-style
    ``train.datasets.0.root=...``)."""
    parts = dotted.split(".")
    cur: Any = cfg

    def list_index(seg: str, lst: list):
        if not seg.isdigit() or int(seg) >= len(lst):
            raise KeyError(
                f"override path not found: {dotted!r} (segment {seg!r} must be a "
                f"list index < {len(lst)})"
            )
        return int(seg)

    for p in parts[:-1]:
        if isinstance(cur, list):
            cur = cur[list_index(p, cur)]
        else:
            cur = cur.setdefault(p, {})
    last = parts[-1]
    if isinstance(cur, list):
        cur[list_index(last, cur)] = value
    else:
        cur[last] = value


def _parse_value(text: str) -> Any:
    return yaml_lite.load(text)


def _resolve(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ${a.b} interpolations against the root (iterated to a fixed
    point so chained interpolations work)."""

    def resolve_node(node: Any, depth: int = 0) -> Any:
        if isinstance(node, dict):
            return {k: resolve_node(v, depth) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve_node(v, depth) for v in node]
        if isinstance(node, str):
            m = _INTERP_RE.fullmatch(node)
            if m:  # whole-string interpolation keeps the referenced type
                val = _get_path(cfg, m.group(1))
                if isinstance(val, str) and _INTERP_RE.search(val) and depth < 10:
                    return resolve_node(val, depth + 1)
                return copy.deepcopy(val)
            return _INTERP_RE.sub(lambda mm: str(_get_path(cfg, mm.group(1))), node)
        return node

    prev = None
    out = cfg
    for _ in range(10):
        out = resolve_node(out)
        if out == prev:
            break
        prev = out
        cfg = out
    return out


def load_config(
    config_name: str = "fear_tracker",
    overrides: Optional[Sequence[str]] = None,
    config_dir: str = DEFAULT_CONFIG_DIR,
    resolve: bool = True,
) -> Dict[str, Any]:
    overrides = list(overrides or [])

    # split overrides into group selections (backend=gpu) vs value overrides
    # (train_stage.batch_size=64): a group selection names an existing
    # conf/<group>/ directory.
    group_sel: Dict[str, str] = {}
    value_overrides: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, val = ov.split("=", 1)
        if "." not in key and os.path.isdir(os.path.join(config_dir, key)):
            group_sel[key] = val
        else:
            value_overrides.append((key, _parse_value(val)))

    primary, _ = _read_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = primary.pop("defaults", [])

    cfg: Dict[str, Any] = {}
    for entry in defaults:
        if isinstance(entry, str):  # "- group" shorthand not used, but accept
            group, option = entry, None
        else:
            (group, option), = entry.items()
        option = group_sel.pop(group, option)
        if option in (None, "null"):
            continue
        path = os.path.join(config_dir, group, f"{option}.yaml")
        data, is_global = _read_yaml(path)
        cfg = _deep_merge(cfg, data if is_global else {group: data})

    for group, option in group_sel.items():  # selections not in defaults list
        data, is_global = _read_yaml(os.path.join(config_dir, group, f"{option}.yaml"))
        cfg = _deep_merge(cfg, data if is_global else {group: data})

    cfg = _deep_merge(cfg, primary)
    for key, val in value_overrides:
        _set_path(cfg, key, val)
    return _resolve(cfg) if resolve else cfg


def save_config(cfg: Dict[str, Any], path: str) -> None:
    """Snapshot the resolved experiment config
    (ref: utils/hydra.py:46-57 ``prepare_experiment``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(yaml_lite.dump(cfg))
