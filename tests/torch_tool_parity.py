"""Shared by ``tests/test_torch_{ablations,probes,vot_tools}.py``: the JAX
tools and the port's tools on one JPEG root written by the JAX generator,
both in float32 on the CPU.

The JAX tools build their trackers through
``feartracker_tpu.evaluate.harness.build_scan_tracker``, which they import
inside ``main``; :func:`jax_float32` wraps it to pass ``dtype=float32``.
:func:`run_jax_tool` runs a JAX tool's ``main`` with ``argv`` and returns
the JSON lines it printed."""

import json
import os
import sys

import jax.numpy as jnp
import pytest
import torch

import feartracker_tpu.evaluate.harness as jax_harness
import tools.make_synthetic_dataset as jax_gen

SEED = 7
SEQUENCES = 2
FRAMES = 12
AO_TOL = 0.01


def jpeg_roots(root, scenarios, suffix="", frames=FRAMES, **kw):
    """``<root>/<scenario>_s7<suffix>`` for each scenario, as the tools name
    their roots, written by the JAX generator (JPEG frames); ``kw`` go to
    it (``size``, ``obj_scale``)."""
    for scenario in scenarios:
        jax_gen.generate(os.path.join(root, f"{scenario}_s{SEED}{suffix}"), tracks=1, frames=frames,
                         val_sequences=SEQUENCES, seed=SEED, scenario=scenario,
                         appearance_drift=1.0 if scenario == "drift" else 0.0, **kw)
    return str(root)


def jax_float32(monkeypatch):
    real = jax_harness.build_scan_tracker

    def build(*args, **kw):
        kw["dtype"] = jnp.float32
        return real(*args, **kw)

    monkeypatch.setattr(jax_harness, "build_scan_tracker", build)


def run_jax_tool(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    capsys.readouterr()
    module.main()
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def records(capsys):
    """The JSON lines a port tool's ``run`` printed."""
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def assert_rows_close(got, want, keys, close=("ao",), equal=(), tol=AO_TOL):
    """Rows matched by ``keys``: the same set; ``close`` fields within
    ``tol``, ``equal`` fields and every other shared field equal."""
    index = {tuple(r.get(k) for k in keys): r for r in want}
    assert sorted(index, key=str) == sorted((tuple(r.get(k) for k in keys) for r in got), key=str)
    for r in got:
        w = index[tuple(r.get(k) for k in keys)]
        assert set(r) == set(w), (r, w)
        for f in r:
            if f in close and r[f] is not None and w[f] is not None:
                assert abs(r[f] - w[f]) <= tol, (f, r, w)
            elif f not in close:
                assert r[f] == w[f], (f, r, w)


def assert_summaries_close(got, want, field, tol=AO_TOL):
    """Summary lines in the same order with the same labels, ``field``
    (a mean of deltas) within ``tol``. ``positive_seeds`` and the decision
    are not compared: they follow a delta's sign, which a delta within the
    tolerance of 0 may flip."""
    label = ("summary", "scenario", "n_seeds")
    assert [tuple(r.get(k) for k in label) for r in got] == [tuple(w.get(k) for k in label) for w in want]
    for r, w in zip(got, want):
        assert abs(r[field] - w[field]) <= tol, (r, w)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run has six workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
