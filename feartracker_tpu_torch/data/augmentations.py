"""Host image augmentations (numpy + cv2), the counterpart of
``feartracker_tpu/data/augmentations.py``: the same transforms, the same
``np.random.RandomState`` draws in the same order, so that an item equals
the JAX package's bit for bit where cv2 exists.

* ``photometric_augmentations()``: blur / noise / weather / downscale,
  applied independently to template and search crops;
* ``tracking_augmentations()``: gray/sepia and the colour-jitter family,
  applied with SHARED parameters to the (template, search[, aux]) group.

Every transform separates ``sample_params(rng)`` from ``apply(img,
params)`` so that a group of images can share one draw. All take uint8 RGB
HWC images. cv2 is imported at the first apply, not with this module: a
dataset builds both pipelines at construction, on hosts without cv2 too
(the card host, where training runs the device augmentations instead).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


class _LazyCV2:
    """``cv2``, imported at its first use."""

    def __getattr__(self, name):
        import cv2

        return getattr(cv2, name)


cv2 = _LazyCV2()


class Transform:
    """Base: applied with probability ``p``; params drawn once per call."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def sample_params(self, rng: np.random.RandomState, img: np.ndarray) -> Dict[str, Any]:
        return {}

    def apply(self, img: np.ndarray, params: Dict[str, Any]) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        if rng.rand() < self.p:
            return self.apply(img, self.sample_params(rng, img))
        return img


class OneOf(Transform):
    def __init__(self, transforms: Sequence[Transform], p: float = 0.5):
        super().__init__(p)
        self.transforms = list(transforms)

    def __call__(self, img, rng):
        if rng.rand() < self.p and self.transforms:
            t = self.transforms[rng.randint(len(self.transforms))]
            return t.apply(img, t.sample_params(rng, img))
        return img


class Compose:
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        for t in self.transforms:
            img = t(img, rng)
        return img


class PairedCompose:
    """Apply each transform with ONE parameter draw to a group of images
    (template, search[, aux])."""

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, *args):
        *images, rng = args
        images = list(images)
        for t in self.transforms:
            if isinstance(t, OneOf):
                if rng.rand() < t.p and t.transforms:
                    inner = t.transforms[rng.randint(len(t.transforms))]
                    params = inner.sample_params(rng, images[0])
                    images = [inner.apply(im, params) for im in images]
            elif rng.rand() < t.p:
                params = t.sample_params(rng, images[0])
                images = [t.apply(im, params) for im in images]
        return tuple(images)


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


# --- blur family -------------------------------------------------------------


class Blur(Transform):
    def sample_params(self, rng, img):
        return {"k": int(rng.randint(3, 8) | 1)}

    def apply(self, img, params):
        return cv2.blur(img, (params["k"], params["k"]))


class MotionBlur(Transform):
    def sample_params(self, rng, img):
        k = int(rng.randint(3, 8) | 1)
        angle = rng.uniform(0, 180)
        return {"k": k, "angle": angle}

    def apply(self, img, params):
        k = params["k"]
        kernel = np.zeros((k, k), np.float32)
        kernel[k // 2, :] = 1.0
        m = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), params["angle"], 1.0)
        kernel = cv2.warpAffine(kernel, m, (k, k))
        kernel /= max(kernel.sum(), 1e-6)
        return cv2.filter2D(img, -1, kernel)


class MedianBlur(Transform):
    def sample_params(self, rng, img):
        return {"k": int(rng.randint(3, 8) | 1)}

    def apply(self, img, params):
        return cv2.medianBlur(img, params["k"])


class GaussianBlur(Transform):
    def sample_params(self, rng, img):
        return {"k": int(rng.randint(3, 8) | 1)}

    def apply(self, img, params):
        return cv2.GaussianBlur(img, (params["k"], params["k"]), 0)


class GlassBlur(Transform):
    """Local pixel shuffling + gaussian blur (cheap variant)."""

    def sample_params(self, rng, img):
        h, w = img.shape[:2]
        dx = rng.randint(-2, 3, size=(h, w)).astype(np.float32)
        dy = rng.randint(-2, 3, size=(h, w)).astype(np.float32)
        return {"dx": dx, "dy": dy}

    def apply(self, img, params):
        h, w = img.shape[:2]
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        mapx = np.clip(xx + params["dx"][:h, :w], 0, w - 1)
        mapy = np.clip(yy + params["dy"][:h, :w], 0, h - 1)
        out = cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)
        return cv2.GaussianBlur(out, (3, 3), 0)


# --- noise family ------------------------------------------------------------


class GaussNoise(Transform):
    def __init__(self, var_limit=(10.0, 35.0), p: float = 0.5):
        super().__init__(p)
        self.var_limit = var_limit

    def sample_params(self, rng, img):
        var = rng.uniform(*self.var_limit)
        return {"noise": rng.normal(0, math.sqrt(var), img.shape).astype(np.float32)}

    def apply(self, img, params):
        return _u8(img.astype(np.float32) + params["noise"][: img.shape[0], : img.shape[1]])


class ImageCompression(Transform):
    def __init__(self, quality_lower: int = 50, quality_upper: int = 100, p: float = 0.5):
        super().__init__(p)
        self.lo, self.hi = quality_lower, quality_upper

    def sample_params(self, rng, img):
        return {"q": int(rng.randint(self.lo, self.hi + 1))}

    def apply(self, img, params):
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, params["q"]])
        return cv2.imdecode(enc, cv2.IMREAD_COLOR) if ok else img


class ISONoise(Transform):
    def sample_params(self, rng, img):
        return {
            "color_shift": rng.uniform(0.01, 0.05),
            "intensity": rng.uniform(0.1, 0.5),
            "seed": rng.randint(1 << 31),
        }

    def apply(self, img, params):
        r = np.random.RandomState(params["seed"])
        hls = cv2.cvtColor(img, cv2.COLOR_RGB2HLS).astype(np.float32)
        stddev = hls[..., 1].std()
        luminance_noise = r.poisson(max(stddev * params["intensity"] * 255, 1e-3), hls.shape[:2])
        color_noise = r.normal(0, params["color_shift"] * 360 * params["intensity"], hls.shape[:2])
        hls[..., 0] = (hls[..., 0] + color_noise) % 360
        hls[..., 1] += luminance_noise * (params["intensity"] / 255.0)
        hls[..., 1] = np.clip(hls[..., 1], 0, 255)
        return cv2.cvtColor(hls.astype(np.uint8), cv2.COLOR_HLS2RGB)


class MultiplicativeNoise(Transform):
    def sample_params(self, rng, img):
        return {"mult": rng.uniform(0.9, 1.1, img.shape).astype(np.float32)}

    def apply(self, img, params):
        return _u8(img.astype(np.float32) * params["mult"][: img.shape[0], : img.shape[1]])


# --- weather -----------------------------------------------------------------


class RandomRain(Transform):
    def sample_params(self, rng, img):
        h, w = img.shape[:2]
        n = int(0.01 * h * w / 20)
        return {
            "drops": rng.randint(0, max(w - 1, 1), size=(n, 2)),
            "length": int(rng.randint(5, 15)),
            "slant": int(rng.randint(-5, 6)),
        }

    def apply(self, img, params):
        out = img.copy()
        h, w = out.shape[:2]
        for x, y in params["drops"]:
            x, y = int(x % w), int(y % h)
            x2 = np.clip(x + params["slant"], 0, w - 1)
            y2 = np.clip(y + params["length"], 0, h - 1)
            cv2.line(out, (x, y), (int(x2), int(y2)), (200, 200, 200), 1)
        return cv2.blur(out, (3, 3))


class RandomShadow(Transform):
    def sample_params(self, rng, img):
        h, w = img.shape[:2]
        n = rng.randint(3, 6)
        poly = np.stack([rng.randint(0, w, n), rng.randint(h // 2, h, n)], axis=1)
        return {"poly": poly, "alpha": rng.uniform(0.3, 0.6)}

    def apply(self, img, params):
        mask = np.zeros(img.shape[:2], np.uint8)
        cv2.fillPoly(mask, [params["poly"].astype(np.int32)], 255)
        out = img.astype(np.float32)
        out[mask > 0] *= 1.0 - params["alpha"]
        return _u8(out)


class Downscale(Transform):
    """Nearest-neighbour downscale by a drawn factor and back."""

    def __init__(self, scale_min: float = 0.5, scale_max: float = 0.5, p: float = 0.5):
        super().__init__(p)
        self.scale_min, self.scale_max = scale_min, scale_max

    def sample_params(self, rng, img):
        return {"scale": rng.uniform(self.scale_min, self.scale_max)}

    def apply(self, img, params):
        h, w = img.shape[:2]
        s = params["scale"]
        small = cv2.resize(img, (max(1, int(w * s)), max(1, int(h * s))), interpolation=cv2.INTER_NEAREST)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


# --- color family ------------------------------------------------------------


class ToGray(Transform):
    def apply(self, img, params):
        g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        return cv2.cvtColor(g, cv2.COLOR_GRAY2RGB)


class ToSepia(Transform):
    _M = np.array(
        [[0.393, 0.769, 0.189], [0.349, 0.686, 0.168], [0.272, 0.534, 0.131]], np.float32
    )

    def apply(self, img, params):
        return _u8(img.astype(np.float32) @ self._M.T)


class CLAHE(Transform):
    def __init__(self, clip_limit: float = 2.0, p: float = 0.5):
        super().__init__(p)
        self.clip_limit = clip_limit

    def sample_params(self, rng, img):
        return {"clip": rng.uniform(1.0, self.clip_limit)}

    def apply(self, img, params):
        lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=params["clip"], tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


class RandomBrightnessContrast(Transform):
    def sample_params(self, rng, img):
        return {"alpha": 1.0 + rng.uniform(-0.2, 0.2), "beta": rng.uniform(-0.2, 0.2) * 255}

    def apply(self, img, params):
        return _u8(img.astype(np.float32) * params["alpha"] + params["beta"])


class Emboss(Transform):
    def sample_params(self, rng, img):
        return {"alpha": rng.uniform(0.2, 0.5), "strength": rng.uniform(0.2, 0.7)}

    def apply(self, img, params):
        s = params["strength"]
        kernel = np.array([[-1 - s, 0 - s, 0], [0 - s, 1, 0 + s], [0, 0 + s, 1 + s]], np.float32)
        embossed = cv2.filter2D(img, -1, kernel)
        a = params["alpha"]
        return _u8(img.astype(np.float32) * (1 - a) + embossed.astype(np.float32) * a)


class RandomGamma(Transform):
    def sample_params(self, rng, img):
        return {"gamma": rng.uniform(0.8, 1.2)}

    def apply(self, img, params):
        table = (np.linspace(0, 1, 256) ** params["gamma"] * 255).astype(np.uint8)
        return cv2.LUT(img, table)


class HueSaturationValue(Transform):
    def sample_params(self, rng, img):
        return {
            "h": rng.uniform(-20, 20),
            "s": rng.uniform(-30, 30),
            "v": rng.uniform(-20, 20),
        }

    def apply(self, img, params):
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + params["h"]) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + params["s"], 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + params["v"], 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


class RGBShift(Transform):
    def sample_params(self, rng, img):
        return {"shift": rng.uniform(-20, 20, 3).astype(np.float32)}

    def apply(self, img, params):
        return _u8(img.astype(np.float32) + params["shift"])


class Equalize(Transform):
    def apply(self, img, params):
        out = img.copy()
        for c in range(3):
            out[..., c] = cv2.equalizeHist(img[..., c])
        return out


class ColorJitter(Transform):
    def sample_params(self, rng, img):
        return {
            "brightness": rng.uniform(0.8, 1.2),
            "contrast": rng.uniform(0.8, 1.2),
            "saturation": rng.uniform(0.8, 1.2),
            "hue": rng.uniform(-0.1, 0.1),
        }

    def apply(self, img, params):
        out = img.astype(np.float32) * params["brightness"]
        mean = out.mean()
        out = (out - mean) * params["contrast"] + mean
        hsv = cv2.cvtColor(_u8(out), cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * params["saturation"], 0, 255)
        hsv[..., 0] = (hsv[..., 0] + params["hue"] * 180) % 180
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


class RandomToneCurve(Transform):
    def sample_params(self, rng, img):
        return {"scale": rng.normal(0, 0.1)}

    def apply(self, img, params):
        s = params["scale"]
        x = np.linspace(0, 1, 256)
        curve = np.clip(x + s * np.sin(x * np.pi), 0, 1)
        return cv2.LUT(img, (curve * 255).astype(np.uint8))


# --- geometric crop transform ------------------------------------------------


class BBoxCropWithOffsets:
    """Random scale/shift of an initial crop window, then affine-resize to a
    square. Transforms the image and the object bbox consistently.
    """

    def __init__(self, bbox_crop, scale, shift, crop_size: int):
        self.bbox_crop = bbox_crop
        self.scale = (-abs(scale), abs(scale)) if np.isscalar(scale) else tuple(scale)
        self.shift = (-abs(shift), abs(shift)) if np.isscalar(shift) else tuple(shift)
        self.crop_size = crop_size

    def _modified_crop(self, rng, img_shape) -> List[float]:
        """The crop window, scaled and shifted at random."""
        x, y, w, h = self.bbox_crop
        img_h, img_w = img_shape[:2]
        scale_x = rng.uniform(min(self.scale), max(self.scale))
        scale_y = rng.uniform(min(self.scale), max(self.scale))
        shift_x = rng.uniform(min(self.shift), max(self.shift))
        shift_y = rng.uniform(min(self.shift), max(self.shift))
        new_x = max(0, x - scale_x * w / 2 + shift_x)
        new_y = max(0, y - scale_y * h / 2 + shift_y)
        new_w = min(img_w, new_x + w + scale_x * w) - new_x
        new_h = min(img_h, new_y + h + scale_y * h) - new_y
        return [new_x, new_y, new_w, new_h]

    @staticmethod
    def affine_crop(image: np.ndarray, bbox, out_size: int) -> np.ndarray:
        """``warpAffine`` of the window onto ``out_size``², scale
        (out−1)/size, constant zero border."""
        b = [float(v) for v in bbox]
        a = (out_size - 1) / b[2]
        c = (out_size - 1) / b[3]
        mapping = np.array([[a, 0, -a * b[0]], [0, c, -c * b[1]]], np.float64)
        return cv2.warpAffine(
            image, mapping, (out_size, out_size), borderMode=cv2.BORDER_CONSTANT, borderValue=0
        )

    def _transform_bbox(self, bbox, crop_bbox) -> Tuple[int, int, int, int]:
        """The object box in crop pixels, truncated to int."""
        cs = self.crop_size
        new_x = (bbox[0] - crop_bbox[0]) * cs / crop_bbox[2]
        new_y = (bbox[1] - crop_bbox[1]) * cs / crop_bbox[3]
        new_w = bbox[2] * cs / crop_bbox[2]
        new_h = bbox[3] * cs / crop_bbox[3]
        if new_x < 0:
            new_x, new_w = 0, new_w + new_x
        if new_y < 0:
            new_y, new_h = 0, new_h + new_y
        new_w = min(cs, new_x + new_w) - new_x
        new_h = min(cs, new_y + new_h) - new_y
        return int(new_x), int(new_y), int(new_w), int(new_h)

    def __call__(self, image: np.ndarray, bbox, rng: np.random.RandomState):
        crop_bbox = self._modified_crop(rng, image.shape)
        out_img = self.affine_crop(image, crop_bbox, self.crop_size)
        out_bbox = self._transform_bbox(bbox, crop_bbox)
        return out_img, np.asarray(out_bbox)


# --- pipelines ---------------------------------------------------------------


def photometric_augmentations() -> Compose:
    return Compose(
        [
            OneOf([Blur(), MotionBlur(), MedianBlur(), GaussianBlur(), GlassBlur()], p=0.2),
            OneOf(
                [GaussNoise(var_limit=(10, 35)), ImageCompression(quality_lower=50), ISONoise(), MultiplicativeNoise()],
                p=0.2,
            ),
            OneOf([RandomRain(), RandomShadow()], p=0.05),
            Downscale(0.5, 0.5, p=0.2),
        ]
    )


def tracking_augmentations() -> PairedCompose:
    return PairedCompose(
        [
            OneOf([ToGray(), ToSepia()], p=0.05),
            OneOf(
                [
                    CLAHE(clip_limit=2),
                    RandomBrightnessContrast(),
                    Emboss(),
                    RandomGamma(),
                    HueSaturationValue(),
                    RGBShift(),
                    Equalize(),
                    ColorJitter(),
                    RandomToneCurve(),
                ],
                p=0.5,
            ),
        ]
    )
