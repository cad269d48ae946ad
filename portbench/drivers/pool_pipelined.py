"""The live serving path: ``StreamPool`` over a dual-template ``ScanTracker``,
one host frame a slot a step, in a closed loop with ``depth`` steps in
flight.

The mix's parameters (``traffic/<mix>.json``): ``capacity`` (slots, all
added at set-up), ``ring_frames`` (each slot's clip, kept on the host as
pageable numpy arrays of all slots, replayed in a loop), ``frame_hw``,
``max_step``, ``object_side``, the tracker's serving settings (``update_interval``,
``update_rate``, ``recover_context``, ``gate``: the feature gate's npz),
``depth``, ``warmup_steps``, ``check_steps`` (the length of a judged
stretch), ``check_stretches`` (stretches judged besides the window's last)
and ``trace_steps``.

A step's latency runs from handing its frames to ``step_async`` to the
return of its ``PendingStep.result()``.
"""

from __future__ import annotations

import collections
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import clips, weights
from portbench.drivers.track_chunks import DTYPES, geometry
from portbench.reference import fear
from portbench.reference import tracker as ref

SPAN_STEP = "portbench.step_async"
SPAN_RESULT = "portbench.result"


class Run:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from feartracker_tpu_torch.tracker.runtime import ScanTracker
        from feartracker_tpu_torch.tracker.serving import StreamPool

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.S, self.P = mix["capacity"], mix["ring_frames"]
        self.flat = weights.read_npz(cfg["weights"])
        self.gate = weights.read_npz(mix["gate"])
        self.tracker = ScanTracker(weights.program_model(cfg, self.flat), dtype=DTYPES[cfg["dtype"]],
                                   device=self.device, dynamic_template=True, update_mode="feature",
                                   gate_params=dict(self.gate), update_interval=mix["update_interval"],
                                   update_rate=mix["update_rate"], recover_context=mix["recover_context"])
        c = clips.make_clips(self.S, self.P, tuple(mix["frame_hw"]), seed, self.device, mix["max_step"],
                             tuple(mix["object_side"]))
        self.host = [np.ascontiguousarray(c.frames[k].cpu().numpy()) for k in range(self.P)]
        self.box0 = c.boxes[-1].cpu().numpy()
        del c
        if self.device.type == "cuda":
            # the clips were made on the card for the host: the peak the run
            # reports is the program's, from here on
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.pool = StreamPool(self.tracker, self.S, tuple(mix["frame_hw"]))
        for s in range(self.S):
            self.pool.add(self.host[-1][s], self.box0[s])
        self.template_feats = self.pool.state.template_feats.clone()
        self.steps: List[Dict] = []
        # judged stretches: (first step, the dynamic template before it, the
        # dynamic template after each of its steps), kept by reference: the
        # pool's state is written out of place, so nothing is copied
        self.stretches: List[tuple] = []
        self.last_stretch = None
        self._run(mix["warmup_steps"], None)
        self._sync()
        self.first_window_step = len(self.steps)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, n: Optional[int], seconds: Optional[float], snapshots: bool = False) -> Dict:
        """Steps in a closed loop, ``depth`` in flight, for ``n`` steps or
        until ``seconds`` have passed; the last dispatched are drained."""
        depth, L = self.mix["depth"], self.mix["check_steps"]
        rng = random.Random(self.seed)
        keep, completed, start, dyns = self.mix["check_stretches"], 0, None, []
        pending = collections.deque()
        lat, disp = [], []

        def drain():
            ts, p, idx = pending.popleft()
            with torch.profiler.record_function(SPAN_RESULT):
                self.steps[idx]["result"] = p.result()
            lat.append(time.perf_counter() - ts)

        t0 = time.perf_counter()
        i = 0
        while True:
            idx = len(self.steps)
            if snapshots and (idx - self.first_window_step) % L == 0:
                if start is not None:
                    # reservoir sampling of the completed stretches, from the seed
                    stretch = (start[0], start[1], dyns)
                    if completed < keep:
                        self.stretches.append(stretch)
                    elif (j := rng.randint(0, completed)) < keep:
                        self.stretches[j] = stretch
                    self.last_stretch = stretch
                    completed += 1
                start, dyns = (idx, self.pool.state.dyn_feats), []
            ts = time.perf_counter()
            with torch.profiler.record_function(SPAN_STEP):
                p = self.pool.step_async(self.host[idx % self.P])
            disp.append(time.perf_counter() - ts)
            st = self.pool.state
            self.steps.append({"k": idx % self.P, "state": (st.bbox, st.confidence)})
            if snapshots:
                dyns.append(st.dyn_feats)
            pending.append((ts, p, idx))
            if len(pending) >= depth:
                drain()
            i += 1
            # a window holds at least one whole judged stretch
            if (n is not None and i >= n) or (seconds is not None and time.perf_counter() - t0 >= seconds
                                              and (not snapshots or i > L)):
                break
        while pending:
            drain()
        return {"seconds": time.perf_counter() - t0, "steps": i, "attempted": i, "latencies_s": lat,
                "dispatch_s": disp}

    def window(self, seconds: float) -> Dict:
        self._sync()
        return self._run(None, seconds, snapshots=True)

    def trace_slice(self, path: str) -> Dict:
        from portbench.harness import profiled_slice

        def body():
            self._run(self.mix["trace_steps"], None)
            self._sync()

        rec = profiled_slice(path, body)
        rec["steps"] = self.mix["trace_steps"]
        return rec

    def counts(self) -> Dict:
        return {}

    def free_program(self) -> None:
        self.tracker = self.pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def state_gap(self) -> float:
        """The carried box and confidence after every step of the window
        against the reference's rule for them: the box and confidence the
        step reported, from which the next step's window and context follow.
        A tracker that hands on the state it was given reads the object's
        motion since the slot was added."""
        steps = self.steps[self.first_window_step:]
        dev = lambda k: torch.as_tensor(np.stack([s["result"][k] for s in steps]), device=self.device)  # noqa: E731
        box = torch.stack([s["state"][0] for s in steps]) - dev("bbox")
        conf = torch.stack([s["state"][1] for s in steps]) - dev("confidence")
        return float(torch.maximum(box.abs().amax(), conf.abs().amax()))

    def judge(self, control: Optional[fear.Precision] = None) -> Dict[str, float]:
        """The template each slot was added with, against the reference's;
        the carried state after every step of the window (:meth:`state_gap`);
        then the judged stretches along the program's trajectory, each step
        from the program's state before it (its box, confidence and dynamic
        template): boxes and confidences each step, each failure flag
        against the reported confidence (exact), and at
        each refresh (every ``update_interval`` steps) the update the program
        made to its dynamic template against the reference's feature-gated
        update from the same template (``dyn_update_rel``: the Frobenius norm
        of their difference over all slots, over the norm of the reference's
        update; a template left as it was reads 1). ``control`` puts the
        reference at that precision in the program's place (its own boxes,
        confidences and templates) on the same trajectory; its carried state
        is its own last box, by construction."""
        cfg, mix, geo = self.cfg, self.mix, geometry(self.cfg)
        prec = control or fear.F32
        W = weights.reference_weights(self.flat, self.device)
        G = {k: torch.as_tensor(v, device=self.device) for k, v in self.gate.items()}
        dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        worst = {"template_rel": 0.0, "conf_gap": 0.0, "box_px": 0.0, "failure_flags": 0.0, "dyn_update_rel": 0.0,
                 "state_gap": self.state_gap() if control is None else 0.0}

        def rel(a, b):
            return float((a.float() - b.float()).abs().max() / b.float().abs().max())

        with torch.no_grad(), fear.full_float32():
            tmpl = ref.template(W, cfg["trunk"], dev(self.host[-1]), dev(self.box0), geo)
            mine = tmpl if control is None else ref.template(W, cfg["trunk"], dev(self.host[-1]), dev(self.box0),
                                                             geo, prec)
            worst["template_rel"] = rel(mine.feats if control is not None else self.template_feats, tmpl.feats)
            judged = self.stretches + ([self.last_stretch] if self.last_stretch not in self.stretches else [])
            for first, dyn0, dyns in judged:
                # the dynamic template before each step: the program's own, or the control's
                before_p, cdyn = dyn0, dyn0.float()
                for idx, after_p in zip(range(first, first + mix["check_steps"]), dyns):
                    k, res = self.steps[idx]["k"], self.steps[idx]["result"]
                    before = self.steps[idx - 1]["result"] if idx > 0 else None
                    prev = dev(before["bbox"]) if before else tmpl.box
                    prev_conf = dev(before["confidence"]) if before else torch.ones(self.S, device=self.device)
                    ctx = torch.where(prev_conf < geo.confidence_threshold, mix["recover_context"],
                                      geo.search_context)
                    frames = dev(self.host[k])
                    dyn = before_p.float() if control is None else cdyn
                    j = ref.step(W, cfg["trunk"], cfg["towernum"], tmpl, frames, prev, ctx, geo, dyn)
                    if control is None:
                        box, conf, fail = dev(res["bbox"]), dev(res["confidence"]), dev(res["failure"])
                        c = None
                    else:
                        c = ref.step(W, cfg["trunk"], cfg["towernum"], mine, frames, prev, ctx, geo, cdyn, prec)
                        box, conf, fail = c.top_box, c.top, c.top < geo.confidence_threshold
                    g = ref.gaps(j, box, conf, geo.instance_size)
                    worst["conf_gap"] = max(worst["conf_gap"], float(g["conf_gap"].max()))
                    worst["box_px"] = max(worst["box_px"], float(g["box_px"].max()))
                    # the flag follows from the reported confidence, which conf_gap
                    # holds to the reference's
                    wrong = fail != (conf < geo.confidence_threshold)
                    worst["failure_flags"] = max(worst["failure_flags"], float(wrong.sum()))
                    if idx % mix["update_interval"] == 0:
                        ref_after = self._refresh(W, G, tmpl, tmpl, j, frames, box, prev, dyn, geo, fear.F32)
                        if c is None:
                            after = after_p.float()
                        else:
                            after = cdyn = self._refresh(W, G, mine, mine, c, frames, box, prev, cdyn, geo, prec)
                        gap = ((after - dyn) - (ref_after - dyn)).norm() / (ref_after - dyn).norm()
                        worst["dyn_update_rel"] = max(worst["dyn_update_rel"], float(gap))
                    before_p = after_p
        return worst

    def _refresh(self, W, G, tmpl, static, j, frames, box, prev, dyn, geo, prec):
        cand = ref.encode(W, self.cfg["trunk"], frames, box, tmpl.mean_color, geo, prec)
        r = ref.gate_rate(G, j, cand, static.feats, dyn, box, prev) * self.mix["update_rate"]
        r = r[:, None, None, None]
        return (1.0 - r) * dyn + r * cand
