"""Batched offline tracking with a one-stream transformer tracker (OSTrack-256
CE): ``ScanTracker.track`` over chunks of T frames for S streams, each
stream its own seeded clip, the frames on the device.

The mix's parameters, the window and the check of the carried state are
``track_chunks``'s (``streams``, ``chunk``, ``ring_chunks``, ``frame_hw``,
``max_step``, ``object_side``, ``scan_unroll``, ``depth``,
``warmup_calls``, ``check_calls``, ``trace_calls``). The weights are drawn
from ``--seed`` by the rules of the configuration's ``weights`` file
(``portbench/seeded.py``), once, for the program and the reference.

The traced slice is ``track_chunks``'s, and the program's own traced slice
(``program_trace.trace_program``: the ``fear.vit`` and ``fear.ce`` layer
marks inside the graphs, the ``ce.kept_tokens`` counter) rides along under
``"program"``; ``metrics/*.track_os.py`` read both.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench import clips, seeded
from portbench.counts import onestream
from portbench.drivers import track_chunks
from portbench.drivers.track_chunks import DTYPES, SPAN
from portbench.reference import fear
from portbench.reference import ostrack as ref


def program_model(cfg: Dict, flat: Dict[str, torch.Tensor], device):
    """The program's OSTrack at the configuration's sizes, filled through the
    program's own loader."""
    from feartracker_tpu_torch.convert.ostrack import load_ostrack
    from feartracker_tpu_torch.models.ostrack import OSTrack, OSTrackConfig

    c = OSTrackConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in OSTrackConfig._fields})
    with torch.device(device):
        model = OSTrack(c)
    return load_ostrack(model, flat)


class Run(track_chunks.Run):
    """Set-up on construction: the weights, the model, the tracker, the
    clips, the first frame's templates and one call per captured graph.
    The window, the checked calls and the carried state's check are
    ``track_chunks``'s."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        # a program without OSTrack fails here, before any work
        from feartracker_tpu_torch.convert import ostrack  # noqa: F401
        from feartracker_tpu_torch.tracker.runtime import ScanTracker

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.S, self.T = mix["streams"], mix["chunk"]
        self.sizes = ref.Sizes.of(cfg)
        self.flat = seeded.draw(seeded.read_spec(cfg["weights"]), ref.shapes(self.sizes), seed, self.device)
        self.tracker = ScanTracker(program_model(cfg, self.flat, self.device), dtype=DTYPES[cfg["dtype"]],
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
        self.calls: List[Dict] = []  # every call: its chunk, boxes, confidences, kept tokens and state
        for _ in range(mix["warmup_calls"]):
            self._call()
        self._sync()
        self.first_window_call = len(self.calls)

    def _call(self):
        i = len(self.calls)
        chunk = i % self.ring.shape[0]
        with torch.profiler.record_function(SPAN):
            self.state, out = self.tracker.track(self.state, self.ring[chunk])
        self.calls.append({"chunk": chunk, "bbox": out["bbox"], "confidence": out["confidence"],
                           "ce_kept": out["ce_kept"], "state": (self.state.bbox, self.state.confidence)})

    def trace_slice(self, path: str) -> Dict:
        from portbench import program_trace
        from portbench.harness import profiled_slice

        def body():
            for _ in range(self.mix["trace_calls"]):
                self._call()
            self._sync()

        rec = profiled_slice(path, body)
        rec["steps"] = self.mix["trace_calls"] * self.T
        rec["attention_flops"] = onestream.attention_flops(self.cfg) * self.S * rec["steps"]
        rec["program"] = program_trace.trace_program(self, path)
        return rec

    def counts(self) -> Dict:
        return {"products_per_frame": onestream.frame_products(self.cfg)}

    # -- the check ---------------------------------------------------------

    def _split(self, kept: torch.Tensor) -> List[torch.Tensor]:
        """A frame's ``ce_kept`` (S, k1 + k2 + k3) → each CE layer's; a row
        of another length is one wrong set, which ``ref.forward`` refuses."""
        sizes = self.sizes.kept
        if kept.shape[-1] != sum(sizes):
            return [kept[:, :0] for _ in sizes]
        return list(torch.split(kept.long(), sizes, dim=1))

    def judge(self, control: Optional[fear.Precision] = None) -> Dict[str, float]:
        """The reference over the checked calls, along the program's
        trajectory and with the program's kept tokens: each frame is cropped
        round the program's box of the frame before; at each CE layer the
        program's kept set is judged against the reference's own scores
        (``ce_gap``) and then kept, so that every later layer judges the
        program from its own state; the program's box and confidence are
        judged against the reference's Hann-windowed response. And the state
        carried after every call of the window (:meth:`state_gap`).
        ``control`` puts the reference at that precision in the program's
        place (its own kept sets, box and confidence) on the same
        trajectory; its carried state is its own last box, by construction."""
        sz = self.sizes
        worst = {"ce_gap": 0.0, "conf_gap": 0.0, "box_px": 0.0,
                 "state_gap": self.state_gap() if control is None else 0.0}
        with torch.no_grad(), fear.full_float32():
            tmpl = ref.template(self.flat, sz, self.frame0, self.box0)
            ctmpl = None if control is None else ref.template(self.flat, sz, self.frame0, self.box0, control)
            for i in self.checked_calls():
                prev = self.calls[i - 1]["bbox"][-1] if i > 0 else self.box0
                call = self.calls[i]
                for t in range(self.T):
                    frames = self.ring[call["chunk"], t]
                    if control is None:
                        j = ref.step(self.flat, sz, tmpl, frames, prev, self._split(call["ce_kept"][t]))
                        box, conf = call["bbox"][t], call["confidence"][t]
                    else:
                        c = ref.step(self.flat, sz, ctmpl, frames, prev, prec=control)
                        j = ref.step(self.flat, sz, tmpl, frames, prev, c.kept)
                        box, conf = c.top_box, c.top_conf
                    g = ref.gaps(j, box, conf, sz.search_size)
                    worst["ce_gap"] = max(worst["ce_gap"], float(j.ce_gap.max()))
                    for k, v in g.items():
                        worst[k] = max(worst[k], float(v.max()))
                    prev = call["bbox"][t]
        return worst
