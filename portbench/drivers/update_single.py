"""One live stream through the sequential tracker: ``FEARTracker.initialize``
on one host frame, then ``update`` one host frame at a time in a closed
loop, the reference's API.

The mix's parameters (``traffic/<mix>.json``): ``dtype`` (the tracker's),
``ring_frames`` (the clip, kept on the host as one pageable numpy array and
replayed in a loop), ``frame_hw``, ``max_step``, ``object_side``,
``warmup_updates``, ``check_steps`` (the length of a judged stretch),
``check_stretches`` (stretches judged besides the window's last) and
``trace_updates``.

An update's latency runs from handing its frame to ``update`` to having
its box on the host, which ``update`` returns.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import clips, weights
from portbench.drivers.track_chunks import DTYPES, geometry
from portbench.reference import fear
from portbench.reference import sequential as seq
from portbench.reference import tracker as ref

SPAN = "portbench.update"


class Run:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from feartracker_tpu_torch.tracker.tracker import FEARTracker

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.P = mix["ring_frames"]
        self.flat = weights.read_npz(cfg["weights"])
        self.tracker = FEARTracker(weights.program_model(cfg, self.flat), dtype=DTYPES[mix["dtype"]],
                                   device=self.device)
        c = clips.make_clips(1, self.P, tuple(mix["frame_hw"]), seed, self.device, mix["max_step"],
                             tuple(mix["object_side"]))
        self.host = np.ascontiguousarray(c.frames[:, 0].cpu().numpy())  # (P, H, W, 3)
        self.box0 = c.boxes[-1, 0].cpu().numpy().astype(np.float64)
        del c
        if self.device.type == "cuda":
            # the clip was made on the card for the host: the peak the run
            # reports is the program's, from here on
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.tracker.initialize(self.host[-1], self.box0)
        self.updates: List[Dict] = []  # every update: its frame, its box and confidence, the state after it
        for _ in range(mix["warmup_updates"]):
            self._update()
        self.first_window_update = len(self.updates)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _update(self) -> float:
        k = len(self.updates) % self.P
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN):
            out = self.tracker.update(self.host[k])
        latency = time.perf_counter() - t0
        self.updates.append({"k": k, "bbox": np.array(out["bbox"], np.float64), "confidence": float(out["confidence"]),
                             "state": (np.array(self.tracker.bbox, np.float64), float(self.tracker.last_confidence))})
        return latency

    def window(self, seconds: float) -> Dict:
        self._sync()
        lat = []
        t0 = time.perf_counter()
        while True:
            lat.append(self._update())
            # a window holds at least one whole judged stretch
            if time.perf_counter() - t0 >= seconds and len(lat) > self.mix["check_steps"]:
                break
        return {"seconds": time.perf_counter() - t0, "steps": len(lat), "attempted": len(lat), "latencies_s": lat}

    def trace_slice(self, path: str) -> Dict:
        from portbench.harness import profiled_slice

        def body():
            for _ in range(self.mix["trace_updates"]):
                self._update()
            self._sync()

        rec = profiled_slice(path, body)
        rec["steps"] = self.mix["trace_updates"]
        return rec

    def counts(self) -> Dict:
        return {}

    def free_program(self) -> None:
        self.tracker = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def state_gap(self) -> float:
        """The box and confidence the tracker carries after every update of
        the window against the reference's rule for them: the box and
        confidence the update returned, round which the next update crops. A
        tracker that hands on the state it was given reads the object's
        motion."""
        ups = self.updates[self.first_window_update:]
        box = max(float(np.abs(u["state"][0] - u["bbox"]).max()) for u in ups)
        return max(box, max(abs(u["state"][1] - u["confidence"]) for u in ups))

    def judged(self) -> List[int]:
        """The window's last ``check_steps`` updates and ``check_stretches``
        stretches of as many before them, drawn from the seed."""
        L, first, n = self.mix["check_steps"], self.first_window_update, len(self.updates)
        starts = list(range(first, n - 2 * L + 1, L))
        rng = random.Random(self.seed)
        picked = sorted(rng.sample(starts, min(len(starts), self.mix["check_stretches"])))
        return [i for s in picked for i in range(s, s + L)] + list(range(n - L, n))

    def judge(self, control: Optional[fear.Precision] = None) -> Dict[str, float]:
        """The reference over the judged updates, along the program's
        trajectory: each update's frame is cropped round the program's box
        after the update before, and the program's box and confidence are
        judged against the reference's score map; and the state carried after
        every update of the window (:meth:`state_gap`). ``control`` puts the
        reference at that precision in the program's place on the same
        trajectory; its carried state is its own box, by construction."""
        cfg, geo = self.cfg, geometry(self.cfg)
        W = weights.reference_weights(self.flat, self.device)
        color = np.mean(self.host[-1], axis=(0, 1))
        worst = {"conf_gap": 0.0, "box_px": 0.0, "state_gap": self.state_gap() if control is None else 0.0}
        with torch.no_grad(), fear.full_float32():
            tmpl = seq.template(W, cfg["trunk"], self.host[-1], self.box0, geo, self.device)
            ctmpl = None if control is None else seq.template(W, cfg["trunk"], self.host[-1], self.box0, geo,
                                                              self.device, control)
            for i in self.judged():
                prev = self.updates[i - 1]["bbox"] if i > 0 else seq.init_box(self.host[-1], self.box0)
                u = self.updates[i]
                image = self.host[u["k"]]
                j = seq.step(W, cfg["trunk"], cfg["towernum"], tmpl, image, prev, color, geo, self.device)
                if control is None:
                    box = torch.as_tensor(u["bbox"], dtype=torch.float32, device=self.device)[None]
                    conf = torch.tensor([u["confidence"]], device=self.device)
                else:
                    c = seq.step(W, cfg["trunk"], cfg["towernum"], ctmpl, image, prev, color, geo, self.device,
                                 control)
                    box, conf = c.top_box, c.top
                g = ref.gaps(j, box.float(), conf.float(), geo.instance_size)
                for k, v in g.items():
                    worst[k] = max(worst[k], float(v.max()))
        return worst
