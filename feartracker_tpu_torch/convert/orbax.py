"""The JAX trainer's Orbax checkpoints, read without orbax, tensorstore or
zstandard: the counterpart of ``StandardCheckpointer().restore(path)`` and
of ``feartracker_tpu/train/checkpoint.py:load_orbax_variables``.

A ``StandardCheckpointer`` save is a directory holding ``_METADATA`` (JSON:
``use_ocdbt``, ``use_zarr3`` and ``tree_metadata``, one entry per leaf with
its key path and value type) and an OCDBT database
(:mod:`feartracker_tpu_torch.convert.ocdbt`) of zarr v2 arrays: for the leaf
``('params', 'a', 'kernel')`` the keys ``params.a.kernel/.zarray`` (JSON:
shape, chunks, dtype, compressor, order) and ``params.a.kernel/0.0.0`` (a
chunk; ``step/0`` for a 0-d array), each chunk a zstd frame
(:mod:`feartracker_tpu_torch.convert.zstd`).

:func:`read_orbax_tree` rebuilds the tree as ``restore`` does without a
target: namedtuples come back as dicts of their fields (keys sorted, as
every dict) and tuples as lists;
``None`` leaves stay ``None``; empty containers stay empty (``{}``, ``[]``,
``()``); arrays come back as numpy arrays of the saved dtype and bits.

Refused, naming the feature: a save without OCDBT, zarr v3, a compressor
other than zstd, zarr filters, Fortran order, a dtype numpy lacks, a leaf
type other than an array, ``None`` or an empty container. Such a checkpoint
converts on a host with JAX and orbax: ``python tools/export_weights.py
--weights_path <dir> --out <file>.npz``.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from feartracker_tpu_torch.convert import zstd
from feartracker_tpu_torch.convert.ocdbt import CONVERT_HINT, OcdbtError, read_store

_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}


class _Seq(dict):
    """A sequence node while the tree is built: index → child."""


def _array(store: Dict[bytes, bytes], name: str) -> np.ndarray:
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in store:
        raise OcdbtError(f"array {name}: no {meta_key.decode()} in the store")
    z = json.loads(store[meta_key])
    if z.get("zarr_format") != 2:
        raise OcdbtError(f"array {name}: zarr format {z.get('zarr_format')} {CONVERT_HINT}")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OcdbtError(f"array {name}: compressor {comp.get('id')!r} {CONVERT_HINT}")
    if z.get("filters"):
        raise OcdbtError(f"array {name}: zarr filters {z['filters']} {CONVERT_HINT}")
    if z.get("order", "C") != "C":
        raise OcdbtError(f"array {name}: order {z['order']!r} {CONVERT_HINT}")
    try:
        dtype = np.dtype(z["dtype"])
    except TypeError as e:
        raise OcdbtError(f"array {name}: dtype {z['dtype']!r} {CONVERT_HINT}") from e
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    sep = z.get("dimension_separator", ".")
    fill = z.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if key not in store:
            continue  # a chunk never written holds the fill value
        raw = store[key]
        if comp is not None:
            try:
                raw = zstd.decompress(raw)
            except zstd.ZstdError as e:
                raise OcdbtError(f"chunk {key.decode()}: {e}") from e
        if len(raw) != dtype.itemsize * int(np.prod(chunks, dtype=np.int64)):
            raise OcdbtError(f"chunk {key.decode()}: {len(raw)} bytes for chunks {list(chunks)} of {dtype}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _finish(node: Any) -> Any:
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise OcdbtError(f"sequence with indices {sorted(node)}")
        return [_finish(node[i]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _finish(node[k]) for k in sorted(node)}
    return node


def read_checkpoint(path: str) -> Tuple[Any, int]:
    """:func:`read_orbax_tree` and the bytes of the files it read."""
    with open(os.path.join(path, "_METADATA")) as fh:
        meta = json.load(fh)
    if not meta.get("use_ocdbt", False):
        raise OcdbtError(f"{path}: saved without OCDBT (use_ocdbt false) {CONVERT_HINT}")
    if meta.get("use_zarr3", False):
        raise OcdbtError(f"{path}: saved as zarr v3 (use_zarr3 true) {CONVERT_HINT}")
    store, nbytes = read_store(path)
    root: Any = None
    for entry in meta["tree_metadata"].values():
        keys: List[Dict[str, Any]] = entry["key_metadata"]
        kind = entry["value_metadata"]["value_type"]
        if kind == "np.ndarray":
            leaf = _array(store, ".".join(str(k["key"]) for k in keys))
        elif kind in _EMPTY:
            leaf = _EMPTY[kind]()
        else:
            raise OcdbtError(f"{path}: leaf of type {kind!r} at {[k['key'] for k in keys]} {CONVERT_HINT}")
        containers = [_Seq if k["key_type"] == 1 else dict for k in keys]
        if root is None:
            root = containers[0]()
        node = root
        for depth, k in enumerate(keys):
            want = containers[depth]
            if type(node) is not want:
                raise OcdbtError(f"{path}: key {k['key']!r} is both a sequence index and a dict key")
            key = int(k["key"]) if want is _Seq else k["key"]
            if depth + 1 == len(keys):
                node[key] = leaf
            else:
                node = node.setdefault(key, containers[depth + 1]())
    return _finish(root if root is not None else {}), nbytes


def read_orbax_tree(path: str) -> Any:
    """The tree of the ``StandardCheckpointer`` save at ``path``, as
    ``StandardCheckpointer().restore(path)`` returns it (see the module
    docstring)."""
    return read_checkpoint(path)[0]


def find_orbax_state(path: str) -> str:
    """The save :func:`load_orbax_variables` reads for ``path``: the first
    of the state dir itself, ``<path>/state``, a managed step's
    ``<path>/default``, a checkpoints root's ``last/state`` and an
    experiment's ``checkpoints/last/state`` that holds ``_METADATA``, in
    JAX's order; raises ``FileNotFoundError`` listing what was tried."""
    candidates = [
        path,
        os.path.join(path, "state"),
        os.path.join(path, "default"),
        os.path.join(path, "last", "state"),
        os.path.join(path, "checkpoints", "last", "state"),
    ]
    for cand in candidates:
        if os.path.isdir(cand) and os.path.exists(os.path.join(cand, "_METADATA")):
            return cand
    raise FileNotFoundError(f"no Orbax state found; tried: {', '.join(candidates)}")


def load_orbax_variables(path: str) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of a training checkpoint of the JAX
    ``CheckpointManager``, nested as saved: the state dir, a checkpoints
    root, an experiment dir or a managed step dir (:func:`find_orbax_state`).
    Raises ``ValueError`` when the state lacks either collection."""
    cand = find_orbax_state(path)
    restored = read_orbax_tree(cand)
    missing = {"params", "batch_stats"} - set(restored)
    if missing:
        raise ValueError(f"checkpoint at {cand} lacks {sorted(missing)}")
    return {"params": restored["params"], "batch_stats": restored["batch_stats"]}
