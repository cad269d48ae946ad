"""VOT-style supervised tracking evaluation: accuracy / robustness / EAO; the
counterpart of ``feartracker_tpu/evaluate/vot_eval.py`` (numpy on the host).

The reference leaned on the got10k toolkit's experiment classes for anything
beyond in-training validation (ref: model_training/dataset/__init__.py:17-45
pulls the toolkit's VOT wrapper; the toolkit's ExperimentVOT implements the
supervised protocol). This module is the native replacement, following the
VOT challenge methodology (Kristan et al.):

* **supervised run** — the tracker is initialized on the groundtruth box;
  when the predicted box stops overlapping the groundtruth (IoU == 0) a
  *failure* is recorded and the tracker is re-initialized ``skip`` frames
  later (default 5, the VOT constant).
* **accuracy** — mean IoU over valid frames, excluding ``burnin`` frames
  (default 10) after every (re-)initialization so the re-init bonus does not
  inflate the score. Init frames (scored 1.0 by convention for the segment
  curves) and failure frames (the toolkit excludes the failing frame's 0.0)
  are always excluded from accuracy, even with ``burnin=0``.
* **robustness** — total failure count, plus failures per 100 frames and the
  VOT2015 reliability transform ``exp(-M · failures_per_frame)`` (M = 100,
  the expected sequence span).
* **EAO** — expected average overlap: every (re-)init starts a *segment*
  whose per-frame overlap curve is zero-padded after a failure; Phi(i) is the
  mean over segments of the mean overlap of the first i frames; EAO averages
  Phi over a sequence-length interval. The official interval comes from each
  year's dataset-length KDE; absent that, the [15th, 85th] percentile of the
  evaluated dataset's own segment lengths is used (reported in the result so
  the approximation is explicit).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from feartracker_tpu_torch.core.geometry_np import overlap_xywh_np
from feartracker_tpu_torch.data.dataset import read_img


def supervised_run(
    tracker,
    files: List[str],
    anno: np.ndarray,
    skip: int = 5,
    max_frames: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, List[int], List[int]]:
    """Run the VOT supervised protocol over one sequence.

    Returns ``(overlaps, valid, failures, inits)``: per-frame IoU (NaN where
    the tracker was skipping after a failure), a validity mask, the failure
    frame indices, and the (re-)initialization frame indices.
    """
    n = min(len(files), len(anno))
    if max_frames:
        n = min(n, max_frames)
    overlaps = np.full(n, np.nan)
    valid = np.zeros(n, bool)
    failures: List[int] = []
    inits: List[int] = []

    f = 0
    while f < n:
        tracker.initialize(read_img(files[f]), np.asarray(anno[f], np.float64))
        inits.append(f)
        overlaps[f], valid[f] = 1.0, True  # init frame scores 1 by convention
        f += 1
        while f < n:
            pred = np.asarray(tracker.update(read_img(files[f]))["bbox"], np.float64)
            ov = float(overlap_xywh_np(pred[None], np.asarray(anno[f], np.float64)[None])[0])
            overlaps[f], valid[f] = ov, True
            if ov <= 0.0:
                failures.append(f)
                f += skip  # frames in the gap stay invalid
                break
            f += 1
        else:
            break
    return overlaps, valid, failures, inits


def _burnin_mask(n: int, inits: List[int], burnin: int) -> np.ndarray:
    mask = np.ones(n, bool)
    for i in inits:
        mask[i : i + burnin] = False
    return mask


def _segments(overlaps: np.ndarray, valid: np.ndarray, failures: List[int], inits: List[int], n: int) -> List[np.ndarray]:
    """Per-(re)init overlap curves for EAO: each runs from its init frame to
    the sequence end, with zeros after the segment's failure (the VOT
    convention: a failed tracker earns no overlap for the rest)."""
    segs = []
    for k, i in enumerate(inits):
        end = failures[k] if k < len(failures) else n
        curve = np.zeros(n - i)
        span = overlaps[i:end].copy()
        span[~valid[i:end]] = 0.0
        curve[: end - i] = np.nan_to_num(span)
        segs.append(curve)
    return segs


def eao_from_segments(
    segments: List[np.ndarray], interval: Optional[Tuple[int, int]] = None
) -> Dict[str, Any]:
    """Expected-average-overlap curve + its mean over the length interval."""
    if not segments:
        return {"eao": 0.0, "interval": [0, 0], "curve": []}
    lengths = np.array([len(s) for s in segments])
    max_len = int(lengths.max())
    if interval is None:
        lo = int(np.percentile(lengths, 15))
        hi = int(np.percentile(lengths, 85))
        interval = (max(lo, 1), max(hi, max(lo, 1)))
    # Phi(i) = mean over segments (of length >= i) of mean overlap up to i
    phi = np.zeros(max_len)
    for i in range(1, max_len + 1):
        vals = [s[:i].mean() for s in segments if len(s) >= i]
        phi[i - 1] = float(np.mean(vals)) if vals else 0.0
    lo, hi = interval
    hi = min(hi, max_len)
    eao = float(phi[lo - 1 : hi].mean()) if hi >= lo else 0.0
    return {"eao": eao, "interval": [int(lo), int(hi)], "curve": phi.tolist()}


def evaluate_vot(
    tracker,
    dataset,
    skip: int = 5,
    burnin: int = 10,
    max_frames: Optional[int] = None,
    eao_interval: Optional[Tuple[int, int]] = None,
    verbose: bool = False,
) -> Dict[str, Any]:
    """Supervised VOT evaluation over every sequence of ``dataset``
    (any ``SequenceDataset``). Returns accuracy / robustness / EAO."""
    all_ovs: List[float] = []
    total_failures = 0
    total_frames = 0
    per_seq: Dict[str, Dict[str, float]] = {}
    segments: List[np.ndarray] = []
    for s in range(len(dataset)):
        files, anno, _ = dataset[s]
        n = min(len(files), len(anno))
        if max_frames:
            n = min(n, max_frames)
        if n < 2:
            continue
        overlaps, valid, failures, inits = supervised_run(
            tracker, files, anno, skip=skip, max_frames=n
        )
        scored = valid & _burnin_mask(n, inits, burnin)
        # the synthetic init-frame 1.0 and the failure frame's 0.0 never
        # count toward accuracy (VOT toolkit convention), independent of burnin
        scored[np.asarray(inits, int)] = False
        scored[np.asarray(failures, int)] = False
        seq_ovs = overlaps[scored]
        seq_acc = float(seq_ovs.mean()) if len(seq_ovs) else 0.0
        all_ovs.extend(seq_ovs.tolist())
        total_failures += len(failures)
        total_frames += n
        segments.extend(_segments(overlaps, valid, failures, inits, n))
        name = dataset.sequence_name(s)
        per_seq[name] = {"accuracy": seq_acc, "failures": float(len(failures)), "frames": float(n)}
        if verbose:
            print(f"  {name}: acc={seq_acc:.3f} failures={len(failures)} over {n} frames")
    fail_rate = total_failures / max(total_frames, 1)
    eao = eao_from_segments(segments, eao_interval)
    return {
        "accuracy": float(np.mean(all_ovs)) if all_ovs else 0.0,
        "robustness_failures": float(total_failures),
        "failures_per_100f": float(100.0 * fail_rate),
        "reliability_s100": float(np.exp(-100.0 * fail_rate)),
        "eao": eao["eao"],
        "eao_interval": eao["interval"],
        "num_sequences": len(per_seq),
        "total_frames": float(total_frames),
        "per_sequence": per_seq,
    }
