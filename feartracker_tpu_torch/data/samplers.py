"""Siamese-pair samplers over CSV-annotated video datasets, the counterpart
of ``feartracker_tpu/data/samplers.py`` without pandas (the card host has
none).

CSV schema: sequence_id, track_id, frame_index, img_path, bbox "x, y, w, h",
frame_shape, dataset, presence, near_corner. The JAX package's samplers
draw through pandas, which draws through the ``np.random.RandomState`` it is
given; the port makes the same ``RandomState`` calls in the same order, so
its epoch lists and pairs equal the JAX package's row for row:

* ``DataFrame.sample(n, random_state=rng, replace=r)`` is
  ``rng.choice(len, n, replace=r)``;
* ``groupby(key).sample(k, replace=True, random_state=rng)`` visits the
  groups in sorted key order and calls ``rng.choice(group_len, k,
  replace=True)`` per group;
* the negative drop is ``rng.choice(negative_row_labels, drop,
  replace=False)``, the search frame ``rng.choice(track_row_labels)``.

Cells are typed per column as ``pandas.read_csv`` infers them (int, float,
bool, else str) so that ``near_corner`` reads as pandas'
``astype(bool)`` reads it.
"""

from __future__ import annotations

import csv
import math
from typing import Any, Dict, List, Optional

import numpy as np

_TRUE = ("True", "TRUE", "true")
_FALSE = ("False", "FALSE", "false")


def _column(values: List[str]) -> List[Any]:
    """One CSV column's cells typed as ``pandas.read_csv`` infers them."""
    try:
        return [int(v) for v in values]
    except ValueError:
        pass
    try:
        return [float(v) if v != "" else math.nan for v in values]
    except ValueError:
        pass
    if values and all(v in _TRUE or v in _FALSE for v in values):
        return [v in _TRUE for v in values]
    return [v if v != "" else math.nan for v in values]


def _truthy(v: Any) -> bool:
    """``pandas.Series.astype(bool)`` of one cell: NaN and non-empty
    strings are true."""
    if isinstance(v, float) and math.isnan(v):
        return True
    return bool(v)


def read_annotations(path: str) -> List[Dict[str, Any]]:
    """The CSV's rows as dicts with typed cells, in file order."""
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        raw = list(reader)
        fields = reader.fieldnames or []
    columns = {f: _column([r[f] for r in raw]) for f in fields}
    return [{f: columns[f][i] for f in fields} for i in range(len(raw))]


class TrackSampler:
    def __init__(
        self,
        data_path: str,
        negative_ratio: float = 0.0,
        frame_offset: int = 70,
        num_samples: int = 100000,
        clip_range: bool = False,
        seed: Optional[int] = None,
    ):
        self.data_path = data_path
        self.negative_ratio = negative_ratio
        self.frame_offset = frame_offset
        self.num_samples = num_samples
        self.clip_range = clip_range
        self.rng = np.random.RandomState(seed)
        self.data: Optional[List[Dict[str, Any]]] = None
        self.template_data: Optional[List[Dict[str, Any]]] = None
        self.epoch_data: Optional[List[Dict[str, Any]]] = None
        self.mapping: Optional[Dict[Any, np.ndarray]] = None
        self.num_tracks = 0

    def __len__(self) -> int:
        return 0 if self.epoch_data is None else len(self.epoch_data)

    def _drop_negatives(self, data: List[Dict[str, Any]], drop_fn) -> List[Dict[str, Any]]:
        """Drop ``drop_fn(n_negative, n)`` negative rows drawn without
        replacement, keeping the rest in file order."""
        if not data:
            return data
        negative = np.asarray([i for i, r in enumerate(data) if r["presence"] == 0], np.int64)
        drop = drop_fn(len(negative), len(data))
        dropped = set(self.rng.choice(negative, drop, replace=False).tolist())
        return [r for i, r in enumerate(data) if i not in dropped]

    def _read_data(self) -> List[Dict[str, Any]]:
        def drop(n_neg, n):
            keep = max(0, int(min(n_neg / n, self.negative_ratio) * n))
            return n_neg - keep

        return self._drop_negatives(read_annotations(self.data_path), drop)

    def _eligible(self) -> List[int]:
        """Row labels of the template pool: present and not near a corner."""
        return [i for i, r in enumerate(self.data)
                if r["presence"] == 1 and not _truthy(r["near_corner"])]

    def _map_tracks(self) -> None:
        groups: Dict[Any, List[int]] = {}
        for i, r in enumerate(self.data):
            groups.setdefault(r["track_id"], []).append(i)
        self.mapping = {k: np.asarray(v, np.int64) for k, v in groups.items()}

    def parse_samples(self) -> None:
        self.data = self._read_data()
        self.template_data = [self.data[i] for i in self._eligible()]
        self.num_tracks = len({r["track_id"] for r in self.template_data})
        self._map_tracks()
        self.resample()

    def resample(self) -> None:
        """Track-balanced per-epoch template draw."""
        rows = self.template_data
        n = min(self.num_samples, max(len(rows), 1))
        if self.num_tracks == len(rows):
            pick = self.rng.choice(len(rows), size=n, replace=len(rows) < n)
            self.epoch_data = [rows[i] for i in pick]
            return
        per_track = int(math.ceil(n / max(self.num_tracks, 1)))
        groups: Dict[Any, List[int]] = {}
        for i, r in enumerate(rows):
            groups.setdefault(r["track_id"], []).append(i)
        drawn = []
        for key in sorted(groups):
            grp = np.asarray(groups[key], np.intp)
            drawn.append(grp[self.rng.choice(len(grp), size=per_track, replace=True)])
        pool = np.concatenate(drawn)
        pick = pool[self.rng.choice(len(pool), size=n, replace=False)]
        self.epoch_data = [rows[i] for i in pick]

    def _pair_for_template(self, template_item, rng: np.random.RandomState) -> Dict[str, Any]:
        """Draw the search frame for a template row: within ±frame_offset of
        it when ``clip_range``, else uniformly from the track."""
        track_indices = self.mapping[template_item["track_id"]]
        if self.clip_range:
            lo = template_item["frame_index"] - self.frame_offset
            hi = template_item["frame_index"] + self.frame_offset
            in_range = [i for i in track_indices if lo < self.data[i]["frame_index"] < hi]
            search_item = self.data[in_range[rng.choice(len(in_range), size=1, replace=False)[0]]]
        else:
            search_item = self.data[rng.choice(track_indices)]
        return dict(template=template_item, search=search_item)

    def extract_sample(self, idx: int, rng: Optional[np.random.RandomState] = None) -> Dict[str, Any]:
        rng = self.rng if rng is None else rng  # callers pass a per-item rng for thread safety
        return self._pair_for_template(self.epoch_data[idx], rng)


class FrameSampler(TrackSampler):
    """Every eligible frame is a template once per epoch, in file order.

    The negative drop count is ``int((neg_ratio - negative_ratio) * len)``;
    ``resample()`` is a no-op; ``num_samples=None`` means every eligible
    frame, and ``__len__`` clips to their number.
    """

    def __init__(self, *args, num_samples: Optional[int] = None, **kwargs):
        super().__init__(*args, num_samples=num_samples, **kwargs)
        self.indices: Optional[List[int]] = None

    def __len__(self) -> int:
        if self.indices is None:
            return 0
        return min(self.num_samples, len(self.indices))

    def _read_data(self) -> List[Dict[str, Any]]:
        def drop(n_neg, n):
            return min(max(0, int((n_neg / n - self.negative_ratio) * n)), n_neg)

        return self._drop_negatives(read_annotations(self.data_path), drop)

    def parse_samples(self) -> None:
        self.data = self._read_data()
        self._map_tracks()
        self.indices = self._eligible()
        if self.num_samples is None:
            self.num_samples = len(self.indices)

    def resample(self) -> None:
        """No-op: every epoch enumerates the same eligible-frame list."""

    def extract_sample(self, idx: int, rng: Optional[np.random.RandomState] = None) -> Dict[str, Any]:
        rng = self.rng if rng is None else rng
        return self._pair_for_template(self.data[self.indices[idx]], rng)


SAMPLER_TYPES = {"track": TrackSampler, "frame": FrameSampler}
