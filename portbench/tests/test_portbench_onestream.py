"""The two cells of the one-stream tracker and of the sequential tracker
(``drivers/track_onestream.py``, ``drivers/update_single.py``) at a small
size on the CPU, through the port's CPU path, against their plain
references: the honest program passes; the program in float32 reads tight;
the control (the reference in float8 in the program's place) reads above
the program; each fault the cell can have, planted in the timed path, makes
``correct`` false. Then the new readers, the counts, and on the card OSTrack's
marked graphs."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import harness, run
from portbench.reference import fear

CELLS = {"onestream": "ostrack_b256_ce.track_os.s128", "update": "fear_xs.update.s1"}
# OSTrack at a narrow width (the published geometry and depth), its traffic
# cut to two streams and short chunks; the sequential cell's counts cut
SMALL = {
    "track_onestream": (dict(embed_dim=64, num_heads=2, head_channels=32),
                        dict(streams=2, chunk=8, ring_chunks=2, warmup_calls=1, check_calls=2, trace_calls=1)),
    "update_single": ({}, dict(ring_frames=8, warmup_updates=2, check_steps=4, check_stretches=1, trace_updates=2)),
}


@pytest.fixture
def small(monkeypatch):
    """``harness.cell`` returning the two cells cut to SMALL."""
    orig = harness.cell

    def cut(name, root=harness.ROOT):
        wl, cfg, mix = orig(name, root)
        c, m = SMALL[mix["driver"]]
        return wl, dict(cfg, **c), dict(mix, **m)

    monkeypatch.setattr(harness, "cell", cut)
    return cut


def execute(name, seconds=0.5, trace=False):
    return run.execute(name, 3, seconds, trace, torch.device("cpu"), time.time())


def _run(kind, seed=5, **cfg_kw):
    wl, cfg, mix = harness.cell(CELLS[kind])
    r = harness.driver(mix["driver"]).Run(dict(cfg, **cfg_kw), mix, seed, "cpu")
    r.window(0.3)
    r.free_program()
    return r


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_program_passes(small, kind):
    out, checks = execute(CELLS[kind])
    assert out["correct"], checks


def test_float32_program_matches_the_reference(small):
    """OSTrack in float32 (the update cell is float32 already): its kept sets
    are the reference's top-k, its confidences and boxes the reference's
    within float32's rounding of the geometry."""
    tight = {"ce_gap": 0.0, "conf_gap": 1e-5, "box_px": 1e-3, "state_gap": 0.0}
    for kind, kw in (("onestream", dict(dtype="float32")), ("update", {})):
        for k, v in _run(kind, **kw).judge().items():
            assert v <= tight[k], (kind, k, v)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_control_reads_above_the_program(small, kind):
    r = _run(kind)
    mine, control = r.judge(), r.judge(control=fear.Precision("fp8"))
    assert any(control[k] > mine[k] for k in mine), (mine, control)


def _kept_wrong(monkeypatch):
    """CE keeps the first tokens by position, not the top of the centre's
    attention."""
    from feartracker_tpu_torch.models import ostrack

    def first(q, k, ctr, lens_z):
        n = k.shape[2] - lens_z
        return -torch.arange(n, dtype=torch.float32, device=q.device).expand(q.shape[0], -1)

    monkeypatch.setattr(ostrack, "centre_row", first)


def _box_one_cell_off(monkeypatch):
    """The decoded box moved by one score cell (1/16 of the search window) on
    each axis, the chosen cell's offset and size kept."""
    from feartracker_tpu_torch.tracker import runtime

    plain = runtime.centre_decode

    def moved(score, size, offset, window):
        pred, conf = plain(score, size, offset, window)
        n = score.shape[-1]
        return pred + torch.tensor([1.0 / n, 1.0 / n, 0.0, 0.0], device=pred.device), conf

    monkeypatch.setattr(runtime, "centre_decode", moved)


def _state_unchanged(monkeypatch):
    """The step reports its outputs and hands back the state it was given."""
    from feartracker_tpu_torch.tracker.runtime import ScanTracker

    step = ScanTracker.step

    def unchanged(self, state, frames, step_index=None):
        return state, step(self, state, frames, step_index)[1]

    monkeypatch.setattr(ScanTracker, "step", unchanged)


def _update_box_one_cell_off(monkeypatch):
    """The sequential tracker's frame box moved by one score cell (16 pixels
    of the 256² search crop) on each axis."""
    from feartracker_tpu_torch.tracker import tracker

    plain = tracker.rescale_crop_bbox

    def moved(bbox, window, instance_size, *a):
        box = plain(bbox, window, instance_size, *a)
        dx, dy = round(16 * window[2] / instance_size), round(16 * window[3] / instance_size)
        return [box[0] + dx, box[1] + dy] + box[2:]

    monkeypatch.setattr(tracker, "rescale_crop_bbox", moved)


def _update_state_unchanged(monkeypatch):
    """``update`` reports its box and keeps the box it was given."""
    from feartracker_tpu_torch.tracker.tracker import FEARTracker

    update = FEARTracker.update

    def unchanged(self, image):
        before = self.bbox
        out = update(self, image)
        self.bbox = before
        return out

    monkeypatch.setattr(FEARTracker, "update", unchanged)


FAULTS = [("onestream", _kept_wrong, "ce_gap"), ("onestream", _box_one_cell_off, "box_px"),
          ("onestream", _state_unchanged, "state_gap"), ("update", _update_box_one_cell_off, "box_px"),
          ("update", _update_state_unchanged, "state_gap")]


@pytest.mark.parametrize("kind,fault,number", FAULTS,
                         ids=[f"{k}-{f.__name__.strip('_')}" for k, f, _ in FAULTS])
def test_a_planted_fault_is_not_correct(small, monkeypatch, kind, fault, number):
    fault(monkeypatch)
    out, checks = execute(CELLS[kind])
    assert not out["correct"], checks
    assert checks[number]["value"] > checks[number]["limit"], checks


def test_result_line_of_each_cell(small):
    for kind in sorted(CELLS):
        out, checks = execute(CELLS[kind], trace=True)
        wanted = {m["name"] for m in harness.cell_metrics(harness.benchmark(), CELLS[kind], True)}
        assert set(out["metrics"]) <= wanted
        assert out["device"]["memory_peak_bytes"] == 0 and out["breakdown"]["device_ops"] is not None
        json.dumps(out)
    out, _ = execute(CELLS["update"])
    assert set(out["metrics"]) == {"step_ms_p95", "setup_s"}


# -- readers and counts ---------------------------------------------------------------

NEW_READERS = ["mfu_pct.track_os", "vit_ms.track_os", "ce_ms.track_os", "attn_roofline_pct.track_os",
               "idle_pct.update"]


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers(name):
    mod = harness.reader(name)
    assert mod.read({"window": {}, "counts": {}}) is None
    program = {"steps": 4, "segments": {"fear.vit": [0.004, 0.002], "fear.ce": [0.0004, 0.0004]},
               "span_device_s": {}, "host_s": {}, "counters": {}}
    rec = {"window": {"frames": 2048, "seconds": 0.5}, "counts": {"products_per_frame": 45e9},
           "trace": {"busy_s": 0.9, "window_s": 1.0, "steps": 4, "attention_flops": 989e9,
                     "kernels": [("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7", 0.003),
                                 ("void pytorch_flash::flash_fwd_kernel<X>", 0.001), ("nvjet_tst_192x192", 0.5)],
                     "program": program}}
    want = {"mfu_pct.track_os": 100 * 45e9 * 2048 / 0.5 / 989e12, "vit_ms.track_os": 1.5, "ce_ms.track_os": 0.2,
            "attn_roofline_pct.track_os": 25.0, "idle_pct.update": 10.0}
    assert mod.read(rec) == pytest.approx(want[name])
    # a parent without the program's tracing: the slice has no "program"
    if name in ("vit_ms.track_os", "ce_ms.track_os"):
        assert mod.read(dict(rec, trace=dict(rec["trace"], program=None))) is None


def test_onestream_counts():
    from portbench.counts import onestream

    cfg = harness.cell(CELLS["onestream"])[1]
    C = cfg["embed_dim"]
    tokens = [320] * 4 + [244] * 3 + [190] * 3 + [153] * 2
    assert onestream.attention_flops(cfg) == sum(4 * n * n * C for n in tokens)
    # the linear maps at CE's token counts (a CE block's MLP after its elimination), the
    # patch embedding, the head's convs and the crop's taps
    mlp_tokens = [320] * 3 + [244] * 3 + [190] * 3 + [153] * 3
    linear = sum(2 * n * C * C * 4 for n in tokens) + sum(2 * n * C * C * 8 for n in mlp_tokens)
    head = 2 * 256 * 9 * 3 * (768 * 256 + 256 * 128 + 128 * 64 + 64 * 32) + 2 * 256 * 32 * 5
    patch = 2 * 256 * C * 768
    assert onestream.frame_products(cfg) == pytest.approx(linear + head + patch + sum(4 * n * n * C for n in tokens)
                                                          + 8 * 256 * 256 * 3, rel=1e-3)
    assert 44e9 < onestream.frame_products(cfg) < 46e9


# -- the card ---------------------------------------------------------------------------


@pytest.mark.card
def test_marked_onestream_replay_equals_unmarked(tmp_path):
    """OSTrack's unit captured with tracing on replays to the unmarked unit's
    outputs and state bit for bit, and each frame holds its twelve marks in
    the step's order, ``fear.vit`` (6) and ``fear.ce`` (7) among them; the
    replay counts its kept tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from feartracker_tpu_torch.tracker.runtime import ScanTracker
    from feartracker_tpu_torch.utils import tracing
    from portbench import clips, seeded
    from portbench.drivers.track_onestream import program_model
    from portbench.program_trace import reduce_program_trace
    from portbench.reference import ostrack as ref

    cfg = harness.cell(CELLS["onestream"])[1]
    S, T, K, dev = 8, 8, 4, torch.device("cuda", 0)
    flat = seeded.draw(seeded.read_spec(cfg["weights"]), ref.shapes(ref.Sizes.of(cfg)), 3, dev)
    tracker = ScanTracker(program_model(cfg, flat, dev), dtype=torch.bfloat16, device=dev, scan_unroll=K)
    c = clips.make_clips(S, T + 1, (256, 480), 3, dev, 8, (40, 120))
    state0 = tracker.init(c.frames[0], c.boxes[0])
    runs = []
    try:
        for on in (False, True):
            (tracing.enable if on else tracing.disable)()
            tracker.track(state0, c.frames[1:])
            torch.cuda.synchronize()
            tracing.reset()
            path = str(tmp_path / f"trace_{on}.json")
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("portbench.slice"):
                    state, out = tracker.track(state0, c.frames[1:])
                    torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            runs.append((state, out, reduce_program_trace(path, tracing.LAYERS), tracing.counters(), path))
    finally:
        tracing.disable()
    (s0, o0, r0, _, _), (s1, o1, r1, c1, p1) = runs
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k
    assert r0["marks"] == 0 and r1["marks"] == 12 * T
    assert {k: len(v) for k, v in r1["segments"].items()} == {
        "fear.crop": T, "fear.vit": 4 * T, "fear.ce": 4 * T, "fear.head": T, "fear.decode": T, "fear.state": T}
    events = json.load(open(p1))["traceEvents"]
    marks = [int(e["name"].split("<")[1].split(">")[0]) for e in sorted(events, key=lambda e: e.get("ts", 0))
             if e.get("cat") == "kernel" and "fear_mark<" in e.get("name", "")]
    assert marks[:12] == [0, 6, 7, 6, 7, 6, 7, 6, 7, 2, 3, 5]
    assert c1["ce.kept_tokens"] == T * S * 395 and c1.get("graph.captures", 0) == 0
    assert r1["unattributed_s"] == pytest.approx(0.0, abs=1e-9)
    assert np.isfinite(o1["bbox"].cpu().numpy()).all()
