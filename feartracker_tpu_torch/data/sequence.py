"""Evaluation sequence datasets (GOT-10k, LaSOT, NfS, OTB, VOT, TrackingNet),
copied from ``feartracker_tpu/data/sequence.py``.

Each dataset yields ``(frames, annotations, dataset_name)`` per sequence:
``frames`` is a list of image paths, or of decoded RGB uint8 arrays (which
:func:`feartracker_tpu_torch.data.dataset.read_img` passes through), and
``annotations`` an (N, 4) xywh float64 array.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

SequenceItem = Tuple[list, np.ndarray, str]


def _read_gt(path: str) -> np.ndarray:
    """Comma/space/tab separated groundtruth file → (N, K) float array."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip().replace("\t", ",").replace(" ", ",")
            if not line:
                continue
            vals = [v for v in line.split(",") if v != ""]
            rows.append([float(v) for v in vals])
    return np.asarray(rows, dtype=np.float64)


def _poly_to_xywh(poly: np.ndarray) -> np.ndarray:
    """VOT 8-point polygon → axis-aligned xywh."""
    xs, ys = poly[0::2], poly[1::2]
    x1, y1 = xs.min(), ys.min()
    return np.array([x1, y1, xs.max() - x1, ys.max() - y1])


class SequenceDataset:
    """Base: list of (frame paths, xywh annotations, name)."""

    name = "sequence"

    def __init__(self):
        self._sequences: List[Tuple[str, List[str], np.ndarray]] = []

    def __len__(self) -> int:
        return len(self._sequences)

    def __getitem__(self, idx: int) -> SequenceItem:
        _, files, anno = self._sequences[idx]
        return files, anno, self.name

    def sequence_name(self, idx: int) -> str:
        return self._sequences[idx][0]


class GOT10kDataset(SequenceDataset):
    """GOT-10k layout: root/{subset}/GOT-10k_..._{id}/{*.jpg, groundtruth.txt}
    with a list.txt index; a sequence without ``.jpg`` frames takes its
    ``*.npy`` frames (``tools/make_synthetic_dataset.py``'s)."""

    name = "got10k"

    def __init__(self, root_dir: str, subset: str = "val"):
        super().__init__()
        base = os.path.join(root_dir, subset)
        list_file = os.path.join(base, "list.txt")
        if os.path.exists(list_file):
            seq_names = [l.strip() for l in open(list_file) if l.strip()]
        else:
            seq_names = sorted(
                os.path.basename(d) for d in glob.glob(os.path.join(base, "*")) if os.path.isdir(d)
            )
        for seq in seq_names:
            seq_dir = os.path.join(base, seq)
            files = sorted(glob.glob(os.path.join(seq_dir, "*.jpg"))) or sorted(
                glob.glob(os.path.join(seq_dir, "*.npy")))
            gt_path = os.path.join(seq_dir, "groundtruth.txt")
            if not files or not os.path.exists(gt_path):
                continue
            anno = _read_gt(gt_path)
            self._sequences.append((seq, files, anno))


class LaSOTDataset(SequenceDataset):
    """LaSOT layout: root/{class}/{class-N}/img/*.jpg + groundtruth.txt."""

    name = "lasot"

    def __init__(self, root_dir: str, subset: Optional[str] = None):
        super().__init__()
        for gt_path in sorted(glob.glob(os.path.join(root_dir, "*", "*", "groundtruth.txt"))):
            seq_dir = os.path.dirname(gt_path)
            files = sorted(glob.glob(os.path.join(seq_dir, "img", "*.jpg")))
            if not files:
                continue
            self._sequences.append((os.path.basename(seq_dir), files, _read_gt(gt_path)))


class NfSDataset(SequenceDataset):
    """NfS layout: root/{seq}/30/{seq}/*.jpg with a 30/{seq}.txt annotation
    (the 30fps variant the got10k toolkit used)."""

    name = "nfs"

    def __init__(self, root_dir: str, fps: int = 30):
        super().__init__()
        for seq_dir in sorted(glob.glob(os.path.join(root_dir, "*"))):
            if not os.path.isdir(seq_dir):
                continue
            seq = os.path.basename(seq_dir)
            anno_path = os.path.join(seq_dir, str(fps), f"{seq}.txt")
            img_dir = os.path.join(seq_dir, str(fps), seq)
            files = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
            if not files or not os.path.exists(anno_path):
                continue
            raw = _read_gt(anno_path)
            # NfS rows: frame x1 y1 x2 y2 ... → xywh
            if raw.shape[1] >= 5:
                xyxy = raw[:, 1:5]
                anno = np.stack(
                    [xyxy[:, 0], xyxy[:, 1], xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]], 1
                )
            else:
                anno = raw
            self._sequences.append((seq, files, anno))


class VOTDataset(SequenceDataset):
    """VOT layout: root/{seq}/color/*.jpg (or *.jpg) + groundtruth.txt with
    8-point polygons (converted to axis-aligned xywh)."""

    name = "vot"

    def __init__(self, root_dir: str, version: int = 2018):
        super().__init__()
        for gt_path in sorted(glob.glob(os.path.join(root_dir, "*", "groundtruth.txt"))):
            seq_dir = os.path.dirname(gt_path)
            files = sorted(glob.glob(os.path.join(seq_dir, "color", "*.jpg"))) or sorted(
                glob.glob(os.path.join(seq_dir, "*.jpg"))
            )
            if not files:
                continue
            raw = _read_gt(gt_path)
            if raw.shape[1] == 8:
                anno = np.stack([_poly_to_xywh(r) for r in raw])
            else:
                anno = raw[:, :4]
            self._sequences.append((os.path.basename(seq_dir), files, anno))


class TrackingNetDataset(SequenceDataset):
    """TrackingNet layout: root/{TRAIN_0..TRAIN_11, TEST}/ each holding
    ``frames/{seq}/{N}.jpg`` (numerically ordered) + ``anno/{seq}.txt``
    (xywh per line; TEST carries only the init row)."""

    name = "trackingnet"

    def __init__(self, root_dir: str, subset: str = "test"):
        super().__init__()
        if subset.lower() not in ("train", "test"):
            # fail loudly: a GOT-10k-ish subset like "val" would otherwise
            # silently glob the (huge) TRAIN_* chunks
            raise ValueError(
                f"TrackingNet subsets are 'train' or 'test', got {subset!r}"
            )
        if subset.lower() == "test":
            chunks = ["TEST"]
        else:
            chunks = sorted(
                os.path.basename(d)
                for d in glob.glob(os.path.join(root_dir, "TRAIN_*"))
                if os.path.isdir(d)
            )
        for chunk in chunks:
            frames_root = os.path.join(root_dir, chunk, "frames")
            anno_root = os.path.join(root_dir, chunk, "anno")
            for seq_dir in sorted(glob.glob(os.path.join(frames_root, "*"))):
                if not os.path.isdir(seq_dir):
                    continue
                seq = os.path.basename(seq_dir)
                anno_path = os.path.join(anno_root, f"{seq}.txt")
                files = glob.glob(os.path.join(seq_dir, "*.jpg"))
                if not files or not os.path.exists(anno_path):
                    continue
                # frame names are bare integers — numeric sort, not lexical
                files.sort(key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
                self._sequences.append((seq, files, _read_gt(anno_path)[:, :4]))


class OTBDataset(SequenceDataset):
    """OTB-50/100 layout: root/{Seq}/img/####.jpg + groundtruth_rect.txt
    (xywh per line, comma/tab separated). Sequences that ship only numbered
    ``groundtruth_rect.N.txt`` variants (multiple targets in one video —
    Jogging, Skating2, Human4) yield one sequence per variant, named
    ``{Seq}.N`` as the got10k toolkit does."""

    name = "otb"

    def __init__(self, root_dir: str):
        super().__init__()
        for seq_dir in sorted(glob.glob(os.path.join(root_dir, "*"))):
            if not os.path.isdir(seq_dir):
                continue
            files = sorted(glob.glob(os.path.join(seq_dir, "img", "*.jpg")))
            if not files:
                continue
            seq = os.path.basename(seq_dir)
            base = os.path.join(seq_dir, "groundtruth_rect.txt")
            if os.path.exists(base):
                variants = [(seq, base)]
            else:
                variants = [
                    (f"{seq}.{os.path.basename(p).split('.')[-2]}", p)
                    for p in sorted(glob.glob(os.path.join(seq_dir, "groundtruth_rect.*.txt")))
                ]
            for name, gt_path in variants:
                anno = _read_gt(gt_path)[:, :4]
                # Frame/annotation length mismatches follow the got10k toolkit:
                # David is annotated from frame 300 (keep the trailing
                # len(anno) frames); every other surplus-frame sequence
                # (Football1, Freeman3, Freeman4, Diving) is annotated from the
                # START, so keep the LEADING len(anno) frames. Extra annotation
                # rows are truncated to the frame count.
                if len(files) > len(anno):
                    if seq.lower() == "david":
                        sfiles = files[len(files) - len(anno) :]
                    else:
                        sfiles = files[: len(anno)]
                else:
                    sfiles = files
                self._sequences.append((name, sfiles, anno[: len(sfiles)]))


DATASET_REGISTRY = {
    "got10k": GOT10kDataset,
    "lasot": LaSOTDataset,
    "nfs": NfSDataset,
    "otb": OTBDataset,
    "vot": VOTDataset,
    "trackingnet": TrackingNetDataset,
}


def get_sequence_datasets(val_config: Sequence[dict]) -> List[SequenceDataset]:
    """Build val datasets from config (ref: dataset/__init__.py:64-68).
    Datasets whose root doesn't exist are skipped with a notice."""
    out = []
    for cfg in val_config:
        cfg = dict(cfg)
        name = cfg.pop("name")
        root = cfg.pop("root_dir")
        if not os.path.isdir(root):
            print(f"[data] skipping val dataset {name!r}: {root} not found")
            continue
        kwargs = {}
        if name in ("got10k", "trackingnet") and "subset" in cfg:
            kwargs["subset"] = cfg["subset"]
        if name == "vot" and "version" in cfg:
            kwargs["version"] = int(cfg["version"])
        out.append(DATASET_REGISTRY[name](root, **kwargs))
    return out
