"""Every traffic driver at a small size on the CPU, through the port's CPU
path, against the plain reference: the honest program passes; each fault the
cell can have, planted in the timed path, makes ``correct`` false; the
control (the reference in float8 in the program's place) reads above the
program."""

import time

import pytest
import torch

from portbench import harness, run
from portbench.reference import fear

CELLS = {"track": "fear_xs.track.s128", "pool": "fear_xs.pool.c128"}


def execute(name, seconds=0.5, trace=False):
    return run.execute(name, 3, seconds, trace, torch.device("cpu"), time.time())


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_program_passes(small_cells, kind):
    out, checks = execute(CELLS[kind])
    assert out["correct"], checks


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_float32_program_matches_the_reference(small_cells, kind):
    wl, cfg, mix = harness.cell(CELLS[kind])
    r = harness.driver(mix["driver"]).Run(dict(cfg, dtype="float32"), mix, 5, "cpu")
    r.window(0.3)
    r.free_program()
    got = r.judge()
    tight = {"conf_gap": 1e-5, "box_px": 0.0, "template_rel": 1e-5, "dyn_update_rel": 1e-5, "failure_flags": 0.0,
             "state_gap": 0.0}
    for k, v in got.items():
        assert v <= tight[k], (k, v)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_control_reads_above_the_program(small_cells, kind):
    wl, cfg, mix = harness.cell(CELLS[kind])
    r = harness.driver(mix["driver"]).Run(cfg, mix, 5, "cpu")
    r.window(0.3)
    r.free_program()
    mine, control = r.judge(), r.judge(control=fear.Precision("fp8"))
    assert any(control[k] > mine[k] for k in mine), (mine, control)


def _answer_altered(monkeypatch):
    """K1's twin returns every stream's frame box one score cell off: moved by
    the grid's stride, 16 pixels of the 256² search crop, on each axis."""
    from feartracker_tpu_torch.ops.cuda import decode

    plain = decode.decode_step_plain

    def altered(cls_logits, regression_map, cfg, state_bbox, windows, frame_hw):
        d = plain(cls_logits, regression_map, cfg, state_bbox, windows, frame_hw)
        cell = 16.0 * windows[:, 2:] / 256.0
        return d._replace(bbox=d.bbox + torch.cat([cell, torch.zeros_like(cell)], dim=-1))

    monkeypatch.setattr(decode, "decode_step_plain", altered)


def _state_unchanged(monkeypatch):
    """The step reports its outputs and hands back the state it was given."""
    from feartracker_tpu_torch.tracker.runtime import ScanTracker

    step = ScanTracker.step

    def unchanged(self, state, frames, step_index=None):
        return state, step(self, state, frames, step_index)[1]

    monkeypatch.setattr(ScanTracker, "step", unchanged)


FAULTS = [("track", _answer_altered), ("track", _state_unchanged), ("pool", _answer_altered),
          ("pool", _state_unchanged)]


@pytest.mark.parametrize("kind,fault", FAULTS, ids=[f"{k}-{f.__name__.strip('_')}" for k, f in FAULTS])
def test_a_planted_fault_is_not_correct(small_cells, monkeypatch, kind, fault):
    fault(monkeypatch)
    out, checks = execute(CELLS[kind])
    assert not out["correct"], checks
    if fault is _state_unchanged:
        # on the committed traffic the carried state is what gives it away
        assert checks["state_gap"]["value"] > 10 * max(checks["state_gap"]["limit"], 1.0), checks


@pytest.mark.card
def test_track_cell_on_the_card(small_cells):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out, checks = run.execute(CELLS["track"], 3, 1.0, True, torch.device("cuda", 0), time.time())
    assert out["correct"], checks
    assert out["device"]["busy_s"] > 0
