"""Batched multi-stream dataset evaluation on :class:`ScanTracker`, the
counterpart of ``feartracker_tpu/evaluate/batched_eval.py``.

Sequences are letterboxed to one canonical frame size, grouped S at a time
and tracked together. Host threads decode frames; the letterbox resize (the
integer-exact cv2 twin, :mod:`feartracker_tpu_torch.ops.resize`) runs on the
tracker's device; predictions are mapped back to original coordinates
before scoring. The tracker sees the letterboxed (possibly reduced)
resolution, while scoring happens at the original one.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from feartracker_tpu_torch.core.geometry_np import overlap_xywh_np
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.evaluate.got10k_eval import precision_stats, summarize
from feartracker_tpu_torch.ops.resize import resize_linear_u8
from feartracker_tpu_torch.tracker.runtime import ScanTracker


def letterbox(frame: Union[np.ndarray, torch.Tensor], hw: Tuple[int, int], device=None
              ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Scale-preserving resize into an (H, W) canvas (top-left anchored) on
    ``device`` (default: the frame tensor's, or the CPU for numpy).
    Returns (canvas (H, W, 3) uint8 tensor, scale, placed (h, w))."""
    if isinstance(frame, np.ndarray):
        frame = torch.from_numpy(np.ascontiguousarray(frame))
    if device is not None:
        frame = frame.to(device)
    H, W = hw
    h, w = frame.shape[:2]
    scale = min(H / h, W / w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    canvas = torch.zeros((H, W, 3), dtype=frame.dtype, device=frame.device)
    canvas[:nh, :nw] = resize_linear_u8(frame, (nw, nh))
    return canvas, scale, (nh, nw)


def batched_evaluate(
    tracker: ScanTracker,
    dataset,
    streams: int = 16,
    frame_hw: Tuple[int, int] = (360, 640),
    chunk: int = 16,
    max_frames: Optional[int] = None,
    max_sequences: Optional[int] = None,
    decode_workers: int = 4,
    verbose: bool = False,
    sequence_stride: Tuple[int, int] = (0, 1),
) -> Dict[str, Any]:
    """Evaluate ``dataset`` (a SequenceDataset) S sequences at a time.
    ``max_sequences`` caps the run; ``sequence_stride=(rank, world)`` keeps
    every world-th scorable sequence starting at rank (applied after the
    cap, so every rank agrees on the capped set)."""
    # sequences need an init frame + one scored frame (GOT-10k test
    # groundtruth carries only the init row)
    scorable = [
        i for i in range(len(dataset))
        if min(len(dataset[i][0]), len(dataset[i][1])) >= 2
    ]
    skipped = len(dataset) - len(scorable)
    if skipped and verbose:
        print(f"  skipping {skipped} sequences with <2 annotated frames")
    if max_sequences is not None:
        scorable = scorable[: max(int(max_sequences), 0)]
    rank, world = sequence_stride
    if world > 1:
        scorable = scorable[rank::world]
    if not scorable:
        return summarize([], [], [])

    dev = tracker.device
    # a sharded tracker needs the streams to divide over its devices: a
    # short group is padded by repeating its last sequence; the padded
    # streams are tracked but never scored
    divisor = len(getattr(tracker, "devices", ())) or 1
    seq_overlaps: List[np.ndarray] = []
    seq_names: List[str] = []
    seq_precision: List[Dict[str, np.ndarray]] = []

    with ThreadPoolExecutor(decode_workers) as pool:
        for g0 in range(0, len(scorable), streams):
            idxs = scorable[g0 : g0 + streams]
            S = len(idxs)  # scored streams; the rest is padding
            idxs = idxs + [idxs[-1]] * ((-S) % divisor)
            ST = len(idxs)  # tracked streams
            seqs = [dataset[i] for i in idxs]  # (files, anno, name)
            lengths = [min(len(f), len(a), max_frames or 10**9) for f, a, _ in seqs]
            max_len = max(lengths)

            def decode(i_and_t):
                i, t = i_and_t
                return read_img(seqs[i][0][min(t, lengths[i] - 1)])  # freeze after the end

            # init; pad colour = mean of the real image region, not the
            # letterbox bars
            first = [letterbox(read_img(seqs[i][0][0]), frame_hw, dev) for i in range(ST)]
            frames0 = torch.stack([c for c, _, _ in first])
            scales = np.array([s for _, s, _ in first])
            mean_colors = torch.stack([
                c[:nh, :nw].double().mean(dim=(0, 1)) for c, _, (nh, nw) in first
            ]).float()
            bb0 = np.stack([np.asarray(seqs[i][1][0], np.float64) * scales[i] for i in range(ST)])
            state = tracker.init(frames0, bb0.astype(np.float32), mean_color=mean_colors)

            preds = [[np.asarray(seqs[i][1][0], np.float64)] for i in range(S)]
            t = 1
            while t < max_len:
                n = min(chunk, max_len - t)
                raw = list(pool.map(decode, [(i, t + k) for k in range(n) for i in range(ST)]))
                frames = torch.stack([letterbox(f, frame_hw, dev)[0] for f in raw])
                state, out = tracker.track(state, frames.reshape(n, ST, *frame_hw, 3), start_step=t - 1)
                bboxes = out["bbox"].cpu().numpy()  # (n, S, 4)
                for k in range(n):
                    for i in range(S):
                        if t + k < lengths[i]:
                            preds[i].append(bboxes[k, i].astype(np.float64) / scales[i])
                t += n

            for i in range(S):
                anno = np.asarray(seqs[i][1][: lengths[i]], np.float64)
                p = np.stack(preds[i])
                ov = overlap_xywh_np(p[1:], anno[1:])
                seq_overlaps.append(ov)
                seq_precision.append(precision_stats(p[1:], anno[1:]))
                seq_names.append(dataset.sequence_name(idxs[i]))
                if verbose:
                    print(f"  {seq_names[-1]}: AO={ov.mean():.3f} ({len(ov)} frames)")

    return summarize(seq_overlaps, seq_names, seq_precision)
