"""Frame reading, and the Siamese training dataset: CSV annotations →
(template, search) crop pairs with encoded label maps. The counterpart of
``feartracker_tpu/data/dataset.py``.

Items are numpy, NHWC, and equal the JAX package's bit for bit: the same
per-item ``np.random.RandomState``, the same samplers' draws
(:mod:`feartracker_tpu_torch.data.samplers`), the same crops
(:func:`feartracker_tpu_torch.data.crops.get_extended_crop`, whose bytes
equal cv2's) and augmentations.

Two modes:

* normal: host geometry, the augmentations of
  :mod:`feartracker_tpu_torch.data.augmentations` (cv2's pixels, through
  :mod:`feartracker_tpu_torch.utils.cv_host`), normalization and labels;
* staged (``device_augs: true``): host work stops at the doubled-context
  search crop and the template crop, uint8; the train step does the rest on
  the device (:mod:`feartracker_tpu_torch.data.device_augs`).

Neither mode needs cv2; frames are decoded by :func:`read_img`.
"""

from __future__ import annotations

import ast
import collections
import os
import threading
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from feartracker_tpu_torch.core.geometry_np import center_to_bbox, ensure_bbox_boundaries, handle_empty_bbox
from feartracker_tpu_torch.core.grids import make_grid_np
from feartracker_tpu_torch.data.augmentations import (
    BBoxCropWithOffsets,
    photometric_augmentations,
    tracking_augmentations,
)
from feartracker_tpu_torch.data.crops import get_extended_crop
from feartracker_tpu_torch.data.device_augs import STAGED_SEARCH_BBOX_KEY, STAGED_SEARCH_KEY
from feartracker_tpu_torch.data.imread import imread
from feartracker_tpu_torch.data.labels import get_regression_weight_label
from feartracker_tpu_torch.data.samplers import SAMPLER_TYPES
from feartracker_tpu_torch.utils import constants as C
from feartracker_tpu_torch.utils.image import normalize_imagenet_np as _normalize


def read_img(frame: Union[str, np.ndarray]) -> np.ndarray:
    """An RGB uint8 (H, W, 3) frame. A decoded ``np.ndarray`` passes through
    unchanged, so a dataset may hold frames in memory; a ``.npy`` path is
    loaded with numpy (cv2 reads no ``.npy``); any other path is decoded by
    :func:`feartracker_tpu_torch.data.imread.imread`, which picks JPEG, PNG,
    BMP, PNM, PAM, PFM, Sun raster, TIFF, GIF, WebP, JPEG 2000 or Radiance
    HDR from the file's signature and gives ``cv2.imread``'s pixels on every
    host (AVIF is named and refused). A file it cannot read raises
    ``IOError`` naming the reason, where JAX's ``read_img`` raises it for
    ``cv2.imread``'s None."""
    if isinstance(frame, np.ndarray):
        return frame
    if os.path.splitext(frame)[1].lower() == ".npy":
        return np.load(frame)
    try:
        return imread(frame)
    except (OSError, ValueError) as e:
        raise IOError(f"cannot read image {frame}: {e}") from e


class ImageCache:
    """Thread-safe decoded-frame LRU keyed by path. Hits return a copy, so
    that an augmentation never writes into the cached frame."""

    def __init__(self, max_items: int = 16384):
        self.max_items = int(max_items)
        self._d: "collections.OrderedDict[str, np.ndarray]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def read(self, path: str) -> np.ndarray:
        with self._lock:
            img = self._d.get(path)
            if img is not None:
                self._d.move_to_end(path)
                return img.copy()
        img = read_img(path)
        with self._lock:
            self._d[path] = img
            if len(self._d) > self.max_items:
                self._d.popitem(last=False)
        return img.copy()


def encode_maps_np(bbox: np.ndarray, score_size: int, stride: int, instance_size: int):
    """Host twin of ``core.box_coder.encode`` for one box (numpy)."""
    gx, gy = make_grid_np(score_size, stride, instance_size)
    left = gx - bbox[0]
    top = gy - bbox[1]
    right = bbox[0] + bbox[2] - gx
    bottom = bbox[1] + bbox[3] - gy
    reg = np.stack((left, top, right, bottom), axis=-1).astype(np.float32)
    cls = (reg.min(axis=-1, keepdims=True) > 0).astype(np.float32)
    return reg, cls


def _crop(image: np.ndarray, bbox, crop_size: int, offset: float):
    """The port's context crop on the CPU, as numpy."""
    crop, bbox2, context = get_extended_crop(image, bbox, crop_size=crop_size, offset=offset)
    return crop.numpy(), bbox2, context


def _bbox(item, image: np.ndarray) -> np.ndarray:
    return ensure_bbox_boundaries(np.asarray(ast.literal_eval(str(item["bbox"]))), image.shape[:2])


class SiameseTrackingDataset:
    """One CSV-annotated dataset."""

    def __init__(self, config: Dict[str, Any], tracker_config: Dict[str, Any], seed: Optional[int] = None):
        self.config = config
        self.tracker_config = tracker_config
        sizes = dict(config["sizes"])
        self.sizes = sizes
        sampling = dict(config["sampling"])
        sampler_cls = SAMPLER_TYPES[sampling.pop("type", "track")]
        self.item_sampler = sampler_cls(**sampling, seed=seed)
        self.item_sampler.parse_samples()
        # the search context doubles, randomized inside a range
        self.search_context = sizes["search_context"] * 2
        self.context_range = sizes.get("context_range", 0.5)
        self.grid_size = config.get("regression_weight_label_size", tracker_config.get("score_size", 16))
        self.root = config.get("root", "")
        self.name = config.get("name", os.path.basename(str(self.root)) or "dataset")
        self.photometric = photometric_augmentations()
        self.paired_color = tracking_augmentations()
        # an auxiliary later-frame template crop for dual-template training
        self.dynamic_template = bool(config.get("dynamic_template", False))
        # staged mode: the train step does the random crop, augmentations,
        # normalization and labels on the device
        self.device_augs = bool(config.get("device_augs", False))
        # per-item RNGs from (seed, epoch, idx): one shared RandomState would
        # interleave draws across the loader's threads
        self.base_seed = 0 if seed is None else int(seed)
        self.epoch = 0
        cache_cfg = config.get("image_cache", 0)
        self._image_cache: Optional[ImageCache] = (
            ImageCache(16384 if cache_cfg is True else int(cache_cfg)) if cache_cfg else None
        )

    def _read(self, path: str) -> np.ndarray:
        if self._image_cache is not None:
            return self._image_cache.read(path)
        return read_img(path)

    def __len__(self) -> int:
        return len(self.item_sampler)

    def resample(self) -> None:
        self.epoch += 1
        self.item_sampler.resample()

    def _item_rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.base_seed * 1000003 + self.epoch * 10007 + idx) % (2**31 - 1)
        )

    # -- crop transforms ---------------------------------------------------

    def _search_offset(self, rng: np.random.RandomState) -> float:
        min_context = self.search_context - self.context_range / 2
        return float(rng.rand()) * self.context_range + min_context

    def _search_transform(self, image: np.ndarray, bbox: np.ndarray, rng: np.random.RandomState):
        size = self.sizes["search_image_size"]
        crop, bbox2, _ = _crop(image, bbox, size * 2, self._search_offset(rng))
        bbox_crop = center_to_bbox([crop.shape[0] // 2, crop.shape[1] // 2, size, size])
        aug = BBoxCropWithOffsets(
            bbox_crop=bbox_crop,
            scale=self.sizes["search_image_scale"],
            shift=self.sizes["search_image_shift"],
            crop_size=size,
        )
        crop, bbox3 = aug(crop, bbox2, rng)
        bbox3 = handle_empty_bbox(ensure_bbox_boundaries(np.asarray(bbox3), (size, size)))
        return crop, bbox3

    def _template_transform(self, image: np.ndarray, bbox: np.ndarray):
        size = self.sizes["template_image_size"]
        crop, bbox2, _ = _crop(image, bbox, size, self.sizes["template_bbox_offset"])
        bbox2 = handle_empty_bbox(ensure_bbox_boundaries(np.asarray(bbox2), (size, size)))
        return crop, bbox2

    def _sample_aux_template(self, idx, rng, template_item) -> np.ndarray:
        """A nearby-frame template crop for dual-template training; it must
        hold the object: up to 4 draws skip presence==0 rows, then the
        template frame itself."""
        aux_item = None
        for _ in range(4):
            cand = self.item_sampler.extract_sample(idx, rng=rng)["search"]
            if int(cand["presence"]) == 1:
                aux_item = cand
                break
        if aux_item is None:
            aux_item = template_item
        aux_image = self._read(os.path.join(self.root, aux_item["img_path"]))
        aux, _ = self._template_transform(aux_image, _bbox(aux_item, aux_image))
        return aux

    def _meta(self, idx, template_item, search_item, presence) -> Dict[str, Any]:
        return {
            C.TARGET_VISIBILITY_KEY: np.asarray([presence], np.float32),
            C.TRACKER_TARGET_SEARCH_FILENAME_KEY: str(search_item["img_path"]),
            C.TRACKER_TARGET_TEMPLATE_FILENAME_KEY: str(template_item["img_path"]),
            C.DATASET_NAME_KEY: str(search_item.get("dataset", self.name)),
            C.SAMPLE_INDEX_KEY: idx,
        }

    def _staged_item(
        self, idx, rng, template_crop, template_bbox,
        search_image, search_bbox, template_item, search_item, presence,
    ) -> Dict[str, Any]:
        size = self.sizes["search_image_size"]
        staged, staged_bbox, _ = _crop(search_image, search_bbox, size * 2, self._search_offset(rng))
        item = {
            STAGED_SEARCH_KEY: staged.astype(np.uint8),
            STAGED_SEARCH_BBOX_KEY: np.asarray(staged_bbox, np.float32),
            C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: template_crop.astype(np.uint8),
            C.TRACKER_TEMPLATE_BBOX_KEY: template_bbox.astype(np.float32),
            **self._meta(idx, template_item, search_item, presence),
        }
        if self.dynamic_template:
            aux = self._sample_aux_template(idx, rng, template_item)
            item[C.TRACKER_TARGET_AUX_IMAGE_KEY] = aux.astype(np.uint8)
        return item

    # -- item assembly -----------------------------------------------------

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rng = self._item_rng(idx)
        anno = self.item_sampler.extract_sample(idx, rng=rng)
        template_item, search_item = anno["template"], anno["search"]
        template_image = self._read(os.path.join(self.root, template_item["img_path"]))
        search_image = self._read(os.path.join(self.root, search_item["img_path"]))
        template_bbox = _bbox(template_item, template_image)
        search_bbox = _bbox(search_item, search_image)
        presence = int(search_item["presence"])

        template_crop, template_bbox = self._template_transform(template_image, template_bbox)
        if self.device_augs:
            return self._staged_item(
                idx, rng, template_crop, template_bbox,
                search_image, search_bbox, template_item, search_item, presence,
            )
        search_crop, search_bbox = self._search_transform(search_image, search_bbox, rng)
        aux = None
        if self.dynamic_template:
            aux = self._sample_aux_template(idx, rng, template_item)
        # colour augmentations with shared parameters across the group
        if aux is None:
            template_crop, search_crop = self.paired_color(template_crop, search_crop, rng)
        else:
            template_crop, search_crop, aux = self.paired_color(template_crop, search_crop, aux, rng)
            aux = self.photometric(aux, rng)
        # independent photometric augmentations
        template_crop = self.photometric(template_crop, rng)
        search_crop = self.photometric(search_crop, rng)

        size = self.sizes["search_image_size"]
        search_bbox = ensure_bbox_boundaries(np.asarray(search_bbox), (size, size))

        if presence:
            weight = get_regression_weight_label(search_bbox, size, self.grid_size)
            reg, cls = encode_maps_np(
                search_bbox.astype(np.float32),
                self.grid_size,
                self.tracker_config.get("total_stride", 16),
                size,
            )
        else:  # an absent target trains on all-zero maps
            weight = np.zeros((self.grid_size, self.grid_size), np.float32)
            reg = np.zeros((self.grid_size, self.grid_size, 4), np.float32)
            cls = np.zeros((self.grid_size, self.grid_size, 1), np.float32)

        item = {
            C.TARGET_REGRESSION_LABEL_KEY: reg,
            C.TARGET_CLASSIFICATION_KEY: cls,
            C.TARGET_REGRESSION_WEIGHT_KEY: weight,
            C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY: _normalize(template_crop),
            C.TRACKER_TEMPLATE_BBOX_KEY: template_bbox.astype(np.float32),
            C.TRACKER_TARGET_SEARCH_IMAGE_KEY: _normalize(search_crop),
            C.TRACKER_TARGET_BBOX_KEY: search_bbox.astype(np.float32),
            **self._meta(idx, template_item, search_item, presence),
        }
        if aux is not None:
            item[C.TRACKER_TARGET_AUX_IMAGE_KEY] = _normalize(aux)
        return item


class ConcatDataset:
    """Datasets end to end, with ``resample`` passed through to each."""

    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._lengths = [len(d) for d in self.datasets]

    def __len__(self) -> int:
        return sum(self._lengths)

    def __getitem__(self, idx: int):
        for d, n in zip(self.datasets, self._lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)

    def resample(self) -> None:
        for d in self.datasets:
            d.resample()
        self._lengths = [len(d) for d in self.datasets]


def get_training_datasets(config: Dict[str, Any], seed: Optional[int] = None) -> ConcatDataset:
    """The training ``ConcatDataset`` of a composed config: one dataset per
    entry of ``config["train"]["datasets"]``, seeded ``seed + i``."""
    datasets = []
    for i, ds_cfg in enumerate(config["train"]["datasets"]):
        datasets.append(
            SiameseTrackingDataset(ds_cfg, config.get("tracker", {}), seed=None if seed is None else seed + i)
        )
    return ConcatDataset(datasets)
