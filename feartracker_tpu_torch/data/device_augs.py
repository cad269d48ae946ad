"""Training augmentation on the device, batched: the counterpart of
``feartracker_tpu/data/device_augs.py``.

With ``device_augs: true`` the loader stops at cheap host geometry (one
uint8 context crop per image) and the train step does the rest on the card,
over the whole batch at once:

* the ``BBoxCropWithOffsets`` twin: a random scale/shift of the crop
  window, the affine resample (``crop_resize_mm(grid="affine")``) and the
  int-truncating bbox transform;
* paired colour jitter and gray across the (template, search[, aux]) group,
  and independent blur / noise / downscale per crop;
* ImageNet normalization;
* labels: box-coder maps and Manhattan regression weights, zeroed where the
  target is absent.

JAX draws with threefry keys, which torch cannot reproduce. So each
augmentation is split into a *draw* (:func:`draw_params`, a
``torch.Generator`` on the batch's device) and an *apply* with given
parameters (:func:`apply_params`): a test feeds the parameters that JAX drew
into the apply, and holds the draws to their distributions.

Staged batch layout (``SiameseTrackingDataset`` in staged mode):
  STAGED_SEARCH  (B, 2s, 2s, 3) uint8, the doubled-context search crop
  STAGED_SEARCH_BBOX (B, 4) f32, the object box inside it
  template / aux images: final geometry, uint8 (photometric augs still apply)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.ops.crop import crop_resize_mm, normalize_imagenet
from feartracker_tpu_torch.utils import constants as C

STAGED_SEARCH_KEY = "STAGED_SEARCH"
STAGED_SEARCH_BBOX_KEY = "STAGED_SEARCH_BBOX"


class DeviceAugConfig(NamedTuple):
    search_size: int = 256
    scale: float = 0.2  # sizes.search_image_scale
    shift: float = 32.0  # sizes.search_image_shift
    grid_size: int = 16  # regression weight / score map size
    total_stride: int = 16
    # the host pipelines' probabilities
    p_color: float = 0.5
    p_gray: float = 0.05
    p_blur: float = 0.2
    p_noise: float = 0.2
    p_downscale: float = 0.2


def aug_generator(aug_seed: int, step: int, device, rank: Optional[int] = None) -> torch.Generator:
    """The draws of step ``step``: a generator seeded from (``aug_seed``,
    ``step``), as the JAX step folds the step into its key, so that a
    restored state draws what the saved one would have drawn. ``rank`` (a
    data-parallel step over several processes) is folded in too, as JAX
    folds the shard's axis index, so that the processes draw apart."""
    seed = int(aug_seed) * 0x9E3779B97F4A7C15 + int(step)
    if rank is not None:
        seed = seed * 0x9E3779B97F4A7C15 + int(rank) + 1
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


# -- draw -------------------------------------------------------------------


def _uniform(g, shape, lo, hi, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def draw_params(batch: Dict[str, Any], cfg: DeviceAugConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Every random parameter of one :func:`augment_batch` call, drawn on
    the batch's device:

    * ``crop`` (B, 4): scale_x, scale_y ~ U(±scale), shift_x, shift_y ~
      U(±shift);
    * ``gray`` (B,) bool; ``color`` (B,) bool with ``brightness`` (B,) in
      ±0.2·255, ``contrast`` and ``gamma`` (B,) in 1 ± 0.2, ``ch_shift``
      (B, 3) in ±20;
    * ``photometric``: per image (template, search[, aux]) ``blur``,
      ``noise``, ``downscale`` (B,) bool, ``sigma`` (B,) = sqrt(U(10, 35))
      and ``noise_field`` (B, H, W, 3) standard normal.
    """
    staged = batch[STAGED_SEARCH_KEY]
    dev = staged.device
    B = staged.shape[0]
    s = cfg.search_size
    shapes = [batch[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY].shape[1:3], (s, s)]
    if batch.get(C.TRACKER_TARGET_AUX_IMAGE_KEY) is not None:
        shapes.append(batch[C.TRACKER_TARGET_AUX_IMAGE_KEY].shape[1:3])
    u = lambda shape, lo, hi: _uniform(generator, shape, lo, hi, dev)  # noqa: E731
    bern = lambda p: torch.rand(B, generator=generator, device=dev) < p  # noqa: E731
    crop = torch.cat([u((B, 2), -cfg.scale, cfg.scale), u((B, 2), -cfg.shift, cfg.shift)], dim=1)
    params: Dict[str, Any] = {
        "crop": crop,
        "gray": bern(cfg.p_gray),
        "color": bern(cfg.p_color),
        "brightness": u(B, -0.2, 0.2) * 255.0,
        "contrast": 1.0 + u(B, -0.2, 0.2),
        "gamma": 1.0 + u(B, -0.2, 0.2),
        "ch_shift": u((B, 3), -20.0, 20.0),
        "photometric": [],
    }
    for h, w in shapes:
        params["photometric"].append({
            "blur": bern(cfg.p_blur),
            "noise": bern(cfg.p_noise),
            "sigma": torch.sqrt(u(B, 10.0, 35.0)),
            "noise_field": torch.randn((B, h, w, 3), generator=generator, device=dev),
            "downscale": bern(cfg.p_downscale),
        })
    return params


# -- the BBoxCropWithOffsets twin ---------------------------------------------


def modified_crop(draws: torch.Tensor, cfg: DeviceAugConfig, staged_size: int) -> torch.Tensor:
    """(B, 4) scale_x, scale_y, shift_x, shift_y → (B, 4) crop windows: the
    centred s×s window of the (2s)² staged crop, scaled and shifted."""
    s = float(cfg.search_size)
    x = y = float(staged_size) / 2 - s / 2
    scale_x, scale_y, shift_x, shift_y = draws.unbind(-1)
    new_x = torch.clamp(x - scale_x * s / 2 + shift_x, min=0.0)
    new_y = torch.clamp(y - scale_y * s / 2 + shift_y, min=0.0)
    new_w = torch.clamp(new_x + s + scale_x * s, max=float(staged_size)) - new_x
    new_h = torch.clamp(new_y + s + scale_y * s, max=float(staged_size)) - new_y
    return torch.stack([new_x, new_y, new_w, new_h], dim=-1)


def transform_bbox(bbox: torch.Tensor, crop: torch.Tensor, out_size: int) -> torch.Tensor:
    """(B, 4) boxes into crop coordinates, truncated toward 0 as the host
    path's ``int()`` does."""
    cs = float(out_size)
    new_x = (bbox[:, 0] - crop[:, 0]) * cs / crop[:, 2]
    new_y = (bbox[:, 1] - crop[:, 1]) * cs / crop[:, 3]
    new_w = bbox[:, 2] * cs / crop[:, 2]
    new_h = bbox[:, 3] * cs / crop[:, 3]
    new_w = torch.where(new_x < 0, new_w + new_x, new_w)
    new_x = torch.clamp(new_x, min=0.0)
    new_h = torch.where(new_y < 0, new_h + new_y, new_h)
    new_y = torch.clamp(new_y, min=0.0)
    new_w = torch.clamp(new_x + new_w, max=cs) - new_x
    new_h = torch.clamp(new_y + new_h, max=cs) - new_y
    return torch.trunc(torch.stack([new_x, new_y, new_w, new_h], dim=-1))


def handle_empty(bbox: torch.Tensor, size: int, min_bbox: float = 3.0) -> torch.Tensor:
    """``ensure_bbox_boundaries`` then ``handle_empty_bbox`` of the host
    path: clip into the crop, then a minimum side at the clipped place."""
    x1 = torch.clamp(bbox[:, 0], 0, size)
    y1 = torch.clamp(bbox[:, 1], 0, size)
    x2 = torch.clamp(bbox[:, 0] + bbox[:, 2], 0, size)
    y2 = torch.clamp(bbox[:, 1] + bbox[:, 3], 0, size)
    w = torch.clamp(x2 - x1, min=min_bbox)
    h = torch.clamp(y2 - y1, min=min_bbox)
    return torch.stack([x1, y1, w, h], dim=-1)


# -- photometric / colour -----------------------------------------------------


def _per_sample(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, None, None, None]


def to_gray(imgs: List[torch.Tensor], apply: torch.Tensor) -> List[torch.Tensor]:
    """Paired grayscale: one decision per sample for the whole group."""
    out = []
    for img in imgs:
        x = img.float()
        g = (x[..., 0:1] * 0.299 + x[..., 1:2] * 0.587) + x[..., 2:3] * 0.114
        out.append(torch.where(_per_sample(apply), g.expand_as(x), x))
    return out


def color_jitter(imgs: List[torch.Tensor], p: Dict[str, Any]) -> List[torch.Tensor]:
    """Paired contrast / brightness / channel shift / gamma with one set of
    parameters per sample for the whole group."""
    contrast = p["contrast"][:, None, None, None]
    brightness = p["brightness"][:, None, None, None]
    ch_shift = p["ch_shift"][:, None, None, :]
    gamma = p["gamma"][:, None, None, None]
    out = []
    for img in imgs:
        x = img.float()
        y = (x - 127.5) * contrast + 127.5 + brightness + ch_shift
        y = torch.clamp(y, 0.0, 255.0)
        y = 255.0 * (y / 255.0) ** gamma
        out.append(torch.where(_per_sample(p["color"]), y, x))
    return out


def gauss_blur(img: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """3×3 binomial blur, edge-padded: rows first, then columns."""
    x = img.float()
    pad = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    x_v = pad[:, :-2] * 0.25 + pad[:, 1:-1] * 0.5 + pad[:, 2:] * 0.25
    pad = torch.cat([x_v[:, :, :1], x_v, x_v[:, :, -1:]], dim=2)
    x_b = pad[:, :, :-2] * 0.25 + pad[:, :, 1:-1] * 0.5 + pad[:, :, 2:] * 0.25
    return torch.where(_per_sample(apply), x_b, x)


def gauss_noise(img: torch.Tensor, apply: torch.Tensor, sigma: torch.Tensor,
                noise_field: torch.Tensor) -> torch.Tensor:
    """Additive gaussian noise of standard deviation ``sigma``."""
    noisy = torch.clamp(img + sigma[:, None, None, None] * noise_field, 0.0, 255.0)
    return torch.where(_per_sample(apply), noisy, img)


@lru_cache(maxsize=32)
def _resize_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(out, in) weights of ``jax.image.resize(..., "linear")`` along one
    axis: half-pixel centres, a triangle kernel widened by the downscale
    factor (antialiasing), weights renormalized where they leave the
    input."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps, weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).t().contiguous().to(device)


def _resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B, h, w, C), ``jax.image.resize`` "linear"."""
    Rh = _resize_matrix(img.shape[1], h, img.device)
    Rw = _resize_matrix(img.shape[2], w, img.device)
    x = torch.einsum("oh,bhwc->bowc", Rh, img)
    return torch.einsum("pw,bowc->bopc", Rw, x)


def downscale(img: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """Downscale to half size and back."""
    H, W = img.shape[1], img.shape[2]
    back = _resize(_resize(img, H // 2, W // 2), H, W)
    return torch.where(_per_sample(apply), back, img)


def photometric(img: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """The independent per-crop pipeline: blur, noise, downscale."""
    x = gauss_blur(img, p["blur"])
    x = gauss_noise(x, p["noise"], p["sigma"], p["noise_field"])
    return downscale(x, p["downscale"])


# -- the batched entry points -------------------------------------------------


def regression_weight_batch(bboxes: torch.Tensor, image_size: int, map_size: int,
                            r_pos: int = 2, r_neg: int = 0) -> torch.Tensor:
    """Batched twin of ``data.labels.get_regression_weight_label``."""
    cx = bboxes[:, 0] + torch.floor(bboxes[:, 2] / 2)  # the host path's // on ints
    cy = bboxes[:, 1] + torch.floor(bboxes[:, 3] / 2)
    sx = torch.floor(cx / image_size * map_size)[:, None, None]
    sy = torch.floor(cy / image_size * map_size)[:, None, None]
    r = torch.arange(map_size, dtype=torch.float32, device=bboxes.device)
    x = r[None, None, :] - sx
    y = r[None, :, None] - sy
    dist = torch.abs(x) + torch.abs(y)
    return torch.where(dist <= r_pos, 1.0, torch.where(dist < r_neg, 0.5, 0.0))


def apply_params(batch: Dict[str, Any], params: Dict[str, Any], cfg: DeviceAugConfig) -> Dict[str, Any]:
    """Staged uint8 batch + drawn parameters → the normalized, labelled
    training batch."""
    staged = batch[STAGED_SEARCH_KEY]
    staged_bbox = batch[STAGED_SEARCH_BBOX_KEY].float()
    template = batch[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY]
    aux = batch.get(C.TRACKER_TARGET_AUX_IMAGE_KEY)
    B = staged.shape[0]
    s = cfg.search_size

    crop_w = modified_crop(params["crop"], cfg, staged.shape[1])
    pad = torch.zeros(B, 3, dtype=torch.float32, device=staged.device)
    search = crop_resize_mm(staged, crop_w, s, pad, grid="affine")
    sbox = handle_empty(transform_bbox(staged_bbox, crop_w, s), s)

    group = [template, search] + ([aux] if aux is not None else [])
    group = to_gray(group, params["gray"])
    group = color_jitter(group, params)
    group = [photometric(img, p) for img, p in zip(group, params["photometric"])]

    spec = bc.BoxCoderSpec(score_size=cfg.grid_size, total_stride=cfg.total_stride, instance_size=s)
    enc = bc.encode(sbox, spec)
    weight = regression_weight_batch(sbox, s, cfg.grid_size)
    presence = batch[C.TARGET_VISIBILITY_KEY].float().reshape(B, 1, 1, 1)
    out = dict(batch)
    out.pop(STAGED_SEARCH_KEY)
    out.pop(STAGED_SEARCH_BBOX_KEY)
    out[C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY] = normalize_imagenet(group[0])
    out[C.TRACKER_TARGET_SEARCH_IMAGE_KEY] = normalize_imagenet(group[1])
    if aux is not None:
        out[C.TRACKER_TARGET_AUX_IMAGE_KEY] = normalize_imagenet(group[2])
    out[C.TRACKER_TARGET_BBOX_KEY] = sbox
    out[C.TARGET_REGRESSION_LABEL_KEY] = enc.regression_map * presence
    out[C.TARGET_CLASSIFICATION_KEY] = enc.classification_label * presence
    out[C.TARGET_REGRESSION_WEIGHT_KEY] = weight * presence[:, :, :, 0]
    return out


def augment_batch(batch: Dict[str, Any], generator: torch.Generator, cfg: DeviceAugConfig) -> Dict[str, Any]:
    """Staged uint8 batch → the training batch: :func:`draw_params` with
    ``generator``, then :func:`apply_params`."""
    return apply_params(batch, draw_params(batch, cfg, generator), cfg)
