"""Batched offline tracking: ``ScanTracker.track`` over chunks of T frames
for S streams, each stream its own seeded clip, the frames on the device.

The mix's parameters (``traffic/<mix>.json``): ``streams``, ``chunk`` (T),
``ring_chunks`` (the clip is ``ring_chunks``·T frames long, on the device,
replayed in a loop), ``frame_hw``, ``max_step`` (pixels a frame),
``object_side`` (the range of the object's sides), ``scan_unroll``,
``depth`` (calls in flight), ``warmup_calls``, ``check_calls`` (how many of
the window's calls the reference judges frame by frame, the last one among
them; the state carried out of every call is judged) and ``trace_calls``
(calls in the traced slice).
"""

from __future__ import annotations

import collections
import random
import time
from typing import Dict, List, Optional

import torch

from portbench import clips, weights
from portbench.counts import products
from portbench.reference import fear
from portbench.reference import tracker as ref

SPAN = "portbench.track_call"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def geometry(cfg: Dict) -> ref.Geometry:
    return ref.Geometry(cfg["template_size"], cfg["instance_size"], cfg["score_size"], cfg["total_stride"],
                        cfg["template_offset"], cfg["search_context"], cfg["confidence_threshold"])


class Run:
    """Set-up on construction: the model, the tracker, the clips, the
    first frame's templates and one call per captured graph."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from feartracker_tpu_torch.tracker.runtime import ScanTracker

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.S, self.T = mix["streams"], mix["chunk"]
        self.flat = weights.read_npz(cfg["weights"])
        self.tracker = ScanTracker(weights.program_model(cfg, self.flat), dtype=DTYPES[cfg["dtype"]],
                                   device=self.device, scan_unroll=mix["scan_unroll"])
        R = mix["ring_chunks"]
        c = clips.make_clips(self.S, R * self.T, tuple(mix["frame_hw"]), seed, self.device, mix["max_step"],
                             tuple(mix["object_side"]))
        self.ring = c.frames.view((R, self.T) + tuple(c.frames.shape[1:]))
        # the loop's last frame precedes its first: initialise there
        self.frame0, self.box0 = c.frames[-1], c.boxes[-1]
        del c
        if self.device.type == "cuda":
            # the generator's temporaries are gone; the ring stays, as the
            # frames a deployment holds on the card
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.state = self.tracker.init(self.frame0, self.box0)
        self.calls: List[Dict] = []  # every call: its chunk, boxes and confidences
        for _ in range(mix["warmup_calls"]):
            self._call()
        self._sync()
        self.first_window_call = len(self.calls)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self):
        i = len(self.calls)
        chunk = i % self.ring.shape[0]
        with torch.profiler.record_function(SPAN):
            self.state, out = self.tracker.track(self.state, self.ring[chunk])
        # the state the call hands on, kept by reference (the tracker's
        # returned state never aliases a graph's memory)
        self.calls.append({"chunk": chunk, "bbox": out["bbox"], "confidence": out["confidence"],
                           "state": (self.state.bbox, self.state.confidence)})

    def window(self, seconds: float) -> Dict:
        depth = self.mix["depth"]
        inflight = collections.deque()
        self._sync()
        t0 = time.perf_counter()
        n = 0
        while True:
            self._call()
            n += 1
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                inflight.append(ev)
                if len(inflight) > depth:
                    inflight.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "calls": n, "steps": n * self.T, "frames": n * self.T * self.S,
                "attempted": n * self.T * self.S}

    def trace_slice(self, path: str) -> Dict:
        from portbench.harness import profiled_slice

        def body():
            for _ in range(self.mix["trace_calls"]):
                self._call()
            self._sync()

        rec = profiled_slice(path, body)
        rec["steps"] = self.mix["trace_calls"] * self.T
        rec["k2_least_s"] = products.k2_least_s(self.cfg, self.S, self.cfg["instance_size"]) * rec["steps"]
        return rec

    def counts(self) -> Dict:
        W = {k: torch.empty(v.shape, device="meta") for k, v in self.flat.items()}
        return {"products_per_frame": products.frame_products(self.cfg, W)}

    def free_program(self) -> None:
        self.tracker = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def checked_calls(self) -> List[int]:
        """The window's last call and ``check_calls`` − 1 others drawn from the seed."""
        window = list(range(self.first_window_call, len(self.calls)))
        rng = random.Random(self.seed)
        others = rng.sample(window[:-1], min(len(window) - 1, self.mix["check_calls"] - 1))
        return sorted(others) + window[-1:]

    def state_gap(self) -> float:
        """The carried state against the reference's rule for it: after every
        call of the window the state's box and confidence are the box and
        confidence that the call reported for its last frame, which the next
        call's first window is cropped round. A tracker that hands on the
        state it was given reads the object's motion over the call."""
        calls = self.calls[self.first_window_call:]
        box = torch.stack([c["state"][0] for c in calls]) - torch.stack([c["bbox"][-1] for c in calls])
        conf = torch.stack([c["state"][1] for c in calls]) - torch.stack([c["confidence"][-1] for c in calls])
        return float(torch.maximum(box.abs().amax(), conf.abs().amax()))

    def judge(self, control: Optional[fear.Precision] = None) -> Dict[str, float]:
        """The reference over the checked calls, along the program's
        trajectory: each frame is cropped round the program's box of the
        frame before, and the program's box and confidence are judged
        against the reference's score map; and the state carried after every
        call of the window (:meth:`state_gap`). ``control`` puts the
        reference at that precision in the program's place, on the same
        trajectory; its carried state is its own last box, by construction."""
        cfg, geo = self.cfg, geometry(self.cfg)
        W = weights.reference_weights(self.flat, self.device)
        worst = {"conf_gap": 0.0, "box_px": 0.0, "state_gap": self.state_gap() if control is None else 0.0}
        with torch.no_grad(), fear.full_float32():
            tmpl = ref.template(W, cfg["trunk"], self.frame0, self.box0, geo)
            ctmpl = None if control is None else ref.template(W, cfg["trunk"], self.frame0, self.box0, geo, control)
            for i in self.checked_calls():
                prev = self.calls[i - 1]["bbox"][-1] if i > 0 else tmpl.box
                call = self.calls[i]
                for t in range(self.T):
                    frames = self.ring[call["chunk"], t]
                    j = ref.step(W, cfg["trunk"], cfg["towernum"], tmpl, frames, prev, geo.search_context, geo)
                    if control is None:
                        box, conf = call["bbox"][t], call["confidence"][t]
                    else:
                        c = ref.step(W, cfg["trunk"], cfg["towernum"], ctmpl, frames, prev, geo.search_context, geo,
                                     prec=control)
                        box, conf = c.top_box, c.top
                    g = ref.gaps(j, box.float(), conf.float(), geo.instance_size)
                    for k, v in g.items():
                        worst[k] = max(worst[k], float(v.max()))
                    prev = call["bbox"][t]
        return worst
