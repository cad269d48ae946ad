"""Shared fixtures of the benchmark's own tests: small cells on the CPU,
through the port's CPU path, and the ``card`` marker for tests that need a
CUDA card (they decide inside the test and skip without one)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each cell's traffic cut to two streams, the counts of calls and steps cut
# to what a CPU test holds; frames, objects, motion and clip length as
# committed
SMALL = {
    "track_chunks": dict(streams=2, warmup_calls=1, check_calls=2, trace_calls=1),
    "pool_pipelined": dict(capacity=2, warmup_steps=3, check_stretches=1, trace_steps=2),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def small_cells(monkeypatch):
    """``harness.cell`` returning each cell with its traffic cut to SMALL."""
    from portbench import harness

    orig = harness.cell

    def small(name, root=harness.ROOT):
        wl, cfg, mix = orig(name, root)
        return wl, cfg, dict(mix, **SMALL[mix["driver"]])

    monkeypatch.setattr(harness, "cell", small)
    return small
