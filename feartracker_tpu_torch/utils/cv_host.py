"""The cv2 operations of the host augmentations and the batch mosaics,
byte for byte as OpenCV 5.0 computes them on uint8 images: in numpy, and
the colour maps in C (the ``cvh_*`` functions of ``csrc/jpeg.cpp``'s
library, which ``data/jpeg.py`` builds).

The card host has no cv2. Each function below names the cv2 call it
replaces and the rule that makes it exact; every one is probed against
cv2 here (``tests/test_torch_host_augs.py``: the colour maps over all 2**24
inputs, the filters on random images at every size the transforms draw):

* ``blur``: box sum with ``BORDER_REFLECT_101``, divided in 23-bit fixed
  point (``ColumnSum<ushort, uchar>``), not rounded from a float;
* ``gaussian_blur(k, sigma=0)``: the bit-exact 8U path, separable integer
  taps of 8 fractional bits (``small_gaussian_tab``), round half up at bit 16;
* ``median_blur``: the true median over a replicated border;
* ``filter2d``: the kernel's nonzero taps in row-major order, each added by
  a fused multiply-add in float32, then rounded half to even;
* ``warp_affine_f32``: ``warpAffine``'s scalar loop (destination narrower
  than 16): the inverted map in float32, ``sx = fma(x, M0, y*M1) + M2``,
  bilinear taps by fused multiply-adds, zero border;
* ``remap_linear``: float coordinates, floor, the same three fused
  multiply-adds, zero border, rounded half to even;
* the colour maps of ``cvtColor`` (8U): gray in 15-bit fixed point; RGB→HSV
  in integer tables; HSV→RGB in float, truncated in the vector body (whole
  blocks of 32 columns) and rounded in the scalar tail; RGB→HLS in float,
  the vector body (blocks of 8) folding the +360 into the hue's fused
  multiply-add; HLS→RGB in float; RGB↔Lab on OpenCV's integer tables;
* ``clahe``: per-tile clipped histograms on a REFLECT_101 extension,
  bilinear in float32 between tile LUTs;
* ``equalize_hist``, ``lut``, ``line`` (8-connected) and ``rectangle``
  (thick: the quadrilateral of each side and a filled circle per corner);
* ``put_header_text``: OpenCV 5.0 draws ``FONT_HERSHEY_SIMPLEX`` text with
  anti-aliased outline glyphs, not Hershey strokes. The glyphs that a mosaic
  header prints, at scale 0.5, are kept here as the alpha bitmaps cv2 draws,
  laid out by their whole-pixel advances and composited "over", which
  equals cv2 on the header strings probed.
"""

from __future__ import annotations

import ctypes
import functools
import math
from fractions import Fraction
from typing import Tuple

import numpy as np

from feartracker_tpu_torch.data.jpeg import load_library
from feartracker_tpu_torch.ops.resize import _invert_affine
from feartracker_tpu_torch.utils import raster

_F32 = np.float32


def fma_f32(a, b, c) -> np.ndarray:
    """``fmaf(a, b, c)`` elementwise on float32 arrays: a·b + c rounded once.

    a·b is exact in float64; a·b + c rounds once more there, and its float32
    rounding is then right unless the float64 sum sits exactly halfway
    between two float32s, where the float64 rounding error decides (TwoSum).
    """
    a64, b64, c64 = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a64 * b64
    s = p + c64
    r = s.astype(np.float32)
    half = (s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    if half.any():
        r = np.array(r, copy=True)
        ps, cs, ss, rs = (np.broadcast_to(v, s.shape)[half] for v in (p, c64, s, r))
        z = ss - ps
        err = (ps - (ss - z)) + (cs - z)  # ss + err == ps + cs exactly
        # the float32 on the side of the float64 sum that the error points to
        lo = np.nextafter(ss, -np.inf).astype(np.float32)
        hi = np.nextafter(ss, np.inf).astype(np.float32)
        r[half] = np.where(err > 0, hi, np.where(err < 0, lo, rs))
    return r


def _pad101(img: np.ndarray, r: int) -> np.ndarray:
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, pad, mode="reflect")


def _windows(p: np.ndarray, k: int, h: int, w: int):
    for i in range(k):
        for j in range(k):
            yield i, j, p[i:i + h, j:j + w]


# --- filters -------------------------------------------------------------------


def blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` of uint8."""
    d = k * k
    if d > 256:
        raise ValueError(f"blur: a {k}x{k} box leaves cv2's 16-bit sum path")
    h, w = img.shape[:2]
    s = sum(win.astype(np.int64) for _, _, win in _windows(_pad101(img, k // 2), k, h, w))
    scalef = float(1 << 23) / d
    div_scale = math.floor(scalef)
    div_delta = d // 2
    if scalef - div_scale < 0.5:
        div_delta += 1
    else:
        div_scale += 1
    return (((s + div_delta) * div_scale) >> 23).astype(np.uint8)


_GAUSS_TAPS = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16), 7: (8, 28, 56, 72, 56, 28, 8)}


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of uint8, k in 3, 5, 7."""
    if k not in _GAUSS_TAPS:
        raise ValueError(f"gaussian_blur: k={k} is outside cv2's fixed sigma=0 tables (3, 5, 7)")
    g = _GAUSS_TAPS[k]
    h, w = img.shape[:2]
    p = _pad101(img, k // 2).astype(np.int64)
    rows = sum(g[j] * p[:, j:j + w] for j in range(k))
    s = sum(g[i] * rows[i:i + h] for i in range(k))
    return ((s + (1 << 15)) >> 16).astype(np.uint8)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(img, k)`` of uint8: replicated border."""
    h, w = img.shape[:2]
    r = k // 2
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img, pad, mode="edge")
    stack = np.stack([win for _, _, win in _windows(p, k, h, w)], 0)
    return np.partition(stack, k * k // 2, axis=0)[k * k // 2]


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` of uint8 with a float32 kernel of odd
    size, centred anchor, ``BORDER_REFLECT_101``."""
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"filter2d: need an odd square kernel, got {kernel.shape}")
    h, w = img.shape[:2]
    acc = np.zeros(img.shape, np.float32)
    for i, j, win in _windows(_pad101(img, kh // 2), kh, h, w):
        if kernel[i, j] != 0:
            acc = fma_f32(kernel[i, j], win.astype(np.float32), acc)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def warp_affine_f32(src: np.ndarray, m: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(src, m, size)`` of a (H, W) float32 image: bilinear,
    zero border. Only destinations narrower than 16 columns (cv2's scalar
    loop) are held to cv2's bits."""
    dst_w, dst_h = int(size[0]), int(size[1])
    if dst_w >= 16:
        raise ValueError("warp_affine_f32: cv2's vector body (16 columns or more) is not reproduced")
    M = _invert_affine(m).astype(np.float32)
    src = np.asarray(src, np.float32)
    H, W = src.shape
    ys, xs = np.meshgrid(np.arange(dst_h, dtype=np.float32), np.arange(dst_w, dtype=np.float32), indexing="ij")
    sx = fma_f32(xs, M[0], ys * M[1]) + M[2]
    sy = fma_f32(xs, M[3], ys * M[4]) + M[5]
    return _bilinear(src[..., None], sx, sy)[..., 0]


def _bilinear(src: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """Bilinear taps of (H, W, C) float32 at float32 coordinates, zero
    outside, combined by three fused multiply-adds."""
    H, W = src.shape[:2]
    ix, iy = np.floor(sx), np.floor(sy)
    a = (sx - ix).astype(np.float32)[..., None]
    b = (sy - iy).astype(np.float32)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)

    def tap(r, c):
        inside = ((r >= 0) & (r < H) & (c >= 0) & (c < W))[..., None]
        return np.where(inside, src[np.clip(r, 0, H - 1), np.clip(c, 0, W - 1)], _F32(0)).astype(np.float32)

    p00, p01, p10, p11 = tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1)
    a, b = np.broadcast_to(a, p00.shape), np.broadcast_to(b, p00.shape)
    v0 = fma_f32(a, p01 - p00, p00)
    v1 = fma_f32(a, p11 - p10, p10)
    return fma_f32(b, v1 - v0, v0)


def remap_linear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)`` of (H, W, C) uint8
    with float32 maps: constant 0 border."""
    sx = np.asarray(mapx, np.float32)
    sy = np.asarray(mapy, np.float32)
    v = _bilinear(img.astype(np.float32), sx, sy)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


# --- colour maps (uint8 RGB in, uint8 out) ----------------------------------------
# The per-pixel work runs in the codec's library (``csrc/jpeg.cpp``, the
# ``cvh_*`` functions): in numpy the maps would pace the loader. The tables
# are built here.


@functools.cache
def _maps():
    """The library with the colour maps' C signatures set."""
    lib = load_library()
    p, n = ctypes.c_void_p, ctypes.c_size_t
    for name, args in {"cvh_rgb2gray": [p, p, n], "cvh_rgb2hsv": [p, p, n, p, p], "cvh_hsv2rgb": [p, p, n, n],
                       "cvh_rgb2hls": [p, p, n, n], "cvh_hls2rgb": [p, p, n], "cvh_rgb2lab": [p, p, n, p, p, p],
                       "cvh_lab2rgb": [p, p, n, p, p, p, p, p]}.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    return lib


def _apply(name: str, img: np.ndarray, channels: int, *tables, rows: bool = False) -> np.ndarray:
    """``cvh_<name>`` over an (..., W, 3) uint8 image → (..., W, channels);
    with ``rows`` the library gets (rows, W), else the pixel count."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim < 2 or img.shape[-1] != 3:
        raise ValueError(f"{name}: need an (..., 3) uint8 image, got {img.dtype} {img.shape}")
    out = np.empty(img.shape[:-1] + ((channels,) if channels > 1 else ()), np.uint8)
    n = img.size // 3
    size = (n // img.shape[-2], img.shape[-2]) if rows else (n,)
    getattr(_maps(), "cvh_" + name)(img.ctypes.data, out.ctypes.data, *size, *(t.ctypes.data for t in tables))
    return out


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``: 15-bit fixed point."""
    return _apply("rgb2gray", img, 1)


def gray2rgb(gray: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB)``."""
    return np.repeat(gray[..., None], 3, axis=-1)


@functools.cache
def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int32)
    hdiv = np.zeros(256, np.int32)
    sdiv[1:] = np.rint((255 << 12) / i)
    hdiv[1:] = np.rint((180 << 12) / (6.0 * i))
    return sdiv, hdiv


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` (H in 0..179): integer
    tables, 12-bit."""
    return _apply("rgb2hsv", img, 3, *_hsv_tables())


def hsv2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)``: float32, two fused
    multiply-adds; truncated in the vector body (whole blocks of 32 columns
    of each row), rounded in the scalar tail."""
    return _apply("hsv2rgb", img, 3, rows=True)


def rgb2hls(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HLS)`` (H in 0..179): float32, the
    hue by a fused multiply-add; in the vector body (blocks of 8 columns) a
    negative hue's +360 inside it and the saturation over one divisor, in
    the scalar tail after it and over 2 - max - min in two steps."""
    return _apply("rgb2hls", img, 3, rows=True)


def hls2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HLS2RGB)``: float32, rounded."""
    return _apply("hls2rgb", img, 3)


def _cbrt_f32(x: np.float32) -> np.float32:
    """The float32 nearest the cube root of a float32, decided in exact
    arithmetic (the host's libm plays no part)."""
    c = _F32(np.cbrt(np.float64(x)))
    fx = Fraction(float(x))
    cands = [np.nextafter(c, _F32(-np.inf)), c, np.nextafter(c, _F32(np.inf))]
    return min(cands, key=lambda v: abs(Fraction(float(v)) ** 3 - fx))


# OpenCV's softfloat cube root misses the nearest float32 here, which moves
# this entry of LabCbrtTab_b (found over all 2**24 RGB inputs)
_LAB_CBRT_FIXES = {324: 17745}


@functools.cache
def _lab_tables():
    f255 = _F32(255)
    # sRGBGammaTab_b: cvRound(2040 * gamma(i / 255)) in float32 over a double gamma
    g = np.zeros(256, np.int64)
    for i in range(256):
        x = float(_F32(i) / f255)
        v = x / (323 / 25) if x <= 809 / 20000 else ((x + 11 / 200) / (1 + 11 / 200)) ** (12 / 5)
        g[i] = int(np.rint(_F32(2040) * _F32(v)))
    lthresh, lscale, lbias = _F32(216) / _F32(24389), _F32(841) / _F32(108), _F32(16) / _F32(116)
    step = _F32(1.0 / 2040.0)
    cbrt = np.zeros(3072, np.int64)
    for i in range(3072):
        x = _F32(step * _F32(i))
        v = fma_f32(x, lscale, lbias)[()] if x < lthresh else _cbrt_f32(x)
        cbrt[i] = int(np.rint(_F32(32768) * v))
    for i, v in _LAB_CBRT_FIXES.items():
        cbrt[i] = v
    # RGB -> XYZ / white point, 12-bit
    srgb2xyz = np.array([0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
                         0.019334, 0.119193, 0.950227]).reshape(3, 3)
    d65 = np.array([0.950456, 1.0, 1.088754])
    to_xyz = np.rint(4096.0 * srgb2xyz / d65[:, None]).astype(np.int64)
    # Lab -> RGB: L -> (Y, f(Y)), f -> X/Z, XYZ -> linear RGB (12-bit), inverse gamma
    base = 1 << 14
    y_tab = np.zeros(256, np.int64)
    fy_tab = np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:
            y = Fraction(i * 100 * base * 27, 255 * 24389)
            y_tab[i] = round(y)
            fy_tab[i] = round(base * (Fraction(16, 116) + Fraction(841, 108) * y / base))
        else:
            fy = Fraction(i * 100 * base, 255 * 116) + Fraction(16 * base, 116)
            fy_tab[i] = round(fy)
            y_tab[i] = round(fy * fy * fy / (base * base))
    ab = np.arange(-8145, base * 9 // 4 - 8145, dtype=np.int64)
    lin = np.abs(ab * 108) // 841 * np.sign(ab) - 290  # C division truncates
    xz = np.where(ab <= 3390, lin, (ab * ab // base) * ab // base)
    xyz2srgb = np.array([3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
                         0.055648, -0.204043, 1.057311]).reshape(3, 3)
    to_rgb = np.rint(4096.0 * xyz2srgb * d65[None, :]).astype(np.int64)
    inv_gamma = np.zeros(4096, np.int64)
    for i in range(4096):
        x = float(_F32(1) / _F32(4096) * _F32(i))
        v = x * (323 / 25) if x <= 7827 / 2500000 else x ** (1 / (12 / 5)) * (1 + 11 / 200) - 11 / 200
        inv_gamma[i] = int(np.rint(f255 * _F32(v)))
    return tuple(np.ascontiguousarray(t, np.int32).ravel()
                 for t in (g, cbrt, to_xyz, y_tab, fy_tab, xz, to_rgb, inv_gamma))


def rgb2lab(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)`` of uint8 (sRGB, D65):
    OpenCV's integer path (``RGB2Lab_b``)."""
    gamma, cbrt, to_xyz, *_ = _lab_tables()
    return _apply("rgb2lab", img, 3, gamma, cbrt, to_xyz)


def lab2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_LAB2RGB)`` of uint8: OpenCV's integer
    path (``Lab2RGBinteger``)."""
    *_, y_tab, fy_tab, xz, to_rgb, inv_gamma = _lab_tables()
    return _apply("lab2rgb", img, 3, y_tab, fy_tab, xz, to_rgb, inv_gamma)


# --- histograms and tables -----------------------------------------------------------


def equalize_hist(ch: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a (H, W) uint8 channel."""
    hist = np.bincount(ch.ravel(), minlength=256)
    first = int(np.flatnonzero(hist)[0])
    if hist[first] == ch.size:
        return np.full_like(ch, first)
    scale = _F32(255) / _F32(ch.size - hist[first])
    lut_ = np.zeros(256, np.uint8)
    lut_[first:] = np.clip(np.rint((np.cumsum(hist) - hist[first]).astype(np.float32) * scale), 0, 255)[first:]
    return lut_[ch]


def clahe(ch: np.ndarray, clip_limit: float, tiles: int = 8) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, (tiles, tiles)).apply(ch)`` of a (H, W)
    uint8 channel."""
    H, W = ch.shape
    if H % tiles == 0 and W % tiles == 0:
        ext = ch
    else:  # cv2 pads both sides, by a whole tile row or column where one divides
        ext = np.pad(ch, ((0, tiles - H % tiles), (0, tiles - W % tiles)), mode="reflect")
    th, tw = ext.shape[0] // tiles, ext.shape[1] // tiles
    total = th * tw
    limit = max(int(clip_limit * total / 256), 1) if clip_limit > 0 else 0
    lut_scale = _F32(255) / _F32(total)
    luts = np.zeros((tiles, tiles, 256), np.int64)
    for ty in range(tiles):
        for tx in range(tiles):
            hist = np.bincount(ext[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw].ravel(), minlength=256)
            if limit > 0:
                clipped = int(np.maximum(hist - limit, 0).sum())
                hist = np.minimum(hist, limit) + clipped // 256
                residual = clipped % 256
                if residual:
                    hist[np.arange(0, 256, max(256 // residual, 1))[:residual]] += 1
            luts[ty, tx] = np.clip(np.rint(np.cumsum(hist).astype(np.float32) * lut_scale), 0, 255)

    def axis(n, size):
        t = np.arange(n).astype(np.float32) * (_F32(1) / _F32(size)) - _F32(0.5)
        t1 = np.floor(t).astype(np.int64)
        frac = (t - t1.astype(np.float32)).astype(np.float32)
        return np.maximum(t1, 0), np.minimum(t1 + 1, tiles - 1), frac, _F32(1) - frac

    x1, x2, xa, xa1 = axis(W, tw)
    y1, y2, ya, ya1 = axis(H, th)
    v = ch.astype(np.int64)

    def at(ty, tx):
        return luts[ty[:, None], tx[None, :], v].astype(np.float32)

    top = at(y1, x1) * xa1[None] + at(y1, x2) * xa[None]
    bottom = at(y2, x1) * xa1[None] + at(y2, x2) * xa[None]
    res = top * ya1[:, None] + bottom * ya[:, None]
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``cv2.LUT(img, table)`` with one uint8 table of 256 entries."""
    table = np.asarray(table)
    if table.shape != (256,) or table.dtype != np.uint8:
        raise ValueError(f"lut: need a (256,) uint8 table, got {table.dtype} {table.shape}")
    return table[img]


# --- drawing -------------------------------------------------------------------------


def line(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color) -> None:
    """``cv2.line(img, pt1, pt2, color, 1)`` (LINE_8), in place."""
    raster._line(img, int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1]), raster._color(img, color))


def rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` (LINE_8, an
    outline: ``raster.rectangle_filled`` fills), in place; returns ``img``
    as cv2 does."""
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    raster.polyline(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], True, raster._color(img, color), thickness)
    return img


# (advance, top row from the baseline, left offset, rows, cols, alpha bitmap)
# of cv2 5.0's putText(FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1)
_HEADER_GLYPHS = {
    'a': (8, -8, 0, 9, 8, "001194d7dda9220000b5d84f4ec7d804004a1b00004bff2a00002780b0dbff3700a8e492545eff373cfc22000065ff3740ff550436e4ff370181f5fdeb7efd300000051b03000000"),
    'b': (8, -11, 1, 12, 8, "854c000000000000e087000000000000e087000000000000e08f8ad5d17d0200e0fbb15b89fd8200e0ce03000095f002e08e00000053ff1de0890000004cff23e0bd0000007cfa05e0ff78204cf0a400d893c8fefdb81400000000100c000000"),
    'c': (8, -8, 0, 9, 8, "00027ac3e1b73a000094f28c58baf93107f69100000dcb7435ff4200000000003bff3900000000000efb7c0000028f5800b7df501d86ff53000eb2f6fff07700000000051c040000"),
    'e': (8, -8, 0, 9, 8, "000071c2d89820000084ee5e43b3d71105f367000009ef6537ff90727272e1993cffaa959595955f04e55c00000009030086e02e0865fb5200127edefdec70000000000219010000"),
    'f': (5, -12, 0, 12, 6, "000000000f09000050e1ffa90001edad2a0f0018ff4d00008acfffd7c863457aff916930001dff430000001dff430000001dff430000001dff430000001dff4300000018fc3c0000"),
    'h': (9, -11, 1, 11, 8, "8551000000000000e08f000000000000e08f000000000000e09386d2cf800200e0f9bc62a1fa8400e0e6030000b2e000e09a0000006cff0de08f00000061ff12e08f00000061ff12e08f00000061ff12d8870000005afb0e"),
    'i': (3, -11, 0, 11, 3, "01b46b01bb7000000000aa5b00e38000e38000e38000e38000e38000e38000dc77"),
    'n': (9, -8, 1, 8, 8, "aa5f8ad3cd7c0100e3f7b861a4fc7a00e3e0010000b8d500e39300000070fd04e38700000065ff07e38700000065ff07e38700000065ff07dc7f0000005ef905"),
    'o': (8, -8, 0, 9, 8, "000173bfdda53400008cf28a59bbef2d06f590000009f28d32ff40000000abc638ff36000000a2cc0dfb7c000002e59d00b4e04f1e87fd4a000daff4ffde63000000000415000000"),
    'r': (5, -8, 1, 8, 5, "aa6087c05de3f7cc873be3ce000000e38b000000e387000000e387000000e387000000dc7f000000"),
    's': (7, -8, 0, 9, 7, "0022aadfcf7c0502e1b64053e48518ff5c0000121600b3f9ab6111000004489ce2f9600000000003a6e93ef4560319c8cd0074edfafdcc2b000001190a0000"),
    't': (5, -11, 0, 11, 6, "001b9e1300000038ff2900000038ff2900008ad4ffd1c842458aff81691f0038ff2900000038ff2900000038ff290000002fff3800000009f8ab3b15000059d9fe7a"),
    '0': (9, -11, 0, 12, 9, "0000196b94772e00000031e8fec3ffff5c0000bfe52a009cffec0d0bfe9b0008de68ff462bff5b005d961aff6a34ff4e00c82c0eff7132ff5034c0000fff701cff759e560035ff5d01eecedc05007eff310083ffff3e83efc2000005a1fffff8b11500000000011a05000000"),
    '1': (9, -11, 1, 11, 8, "0000086d4c0000000020ccffb000000045edcedbb00000006d9908c6b0000000000000c6b0000000000000c6b0000000000000c6b0000000000000c6b0000000000000c6b00000002b4d4dd7c84d4d13a2ffffffffffff56"),
    '2': (9, -11, 0, 11, 9, "00000e6b946f2a00000019ddeeb6edf74800009aed1f0006d3d00000b78800000087fa02000000000002c4d200000000000192fe4c00000000029efe680000000002a0fe6a0000000002a0fe6e00000000009cffb74d4d4d4d0c07faffffffffffff3b"),
    '3': (9, -11, 0, 12, 9, "00547b7b7b7b7b67000094cececed2ffd7000000000001a0ef2c00000000008bf83f000000000075fd55000000000008fdffebb426000000001e2557cced0d00000000000045ff4a21cb3900000057ff4305dcda4e2b64dbe5060022b2fbfff5b81c00000000051c03000000"),
    '4': (9, -11, 0, 11, 9, "0000000001607705000000000068ffff150000000028f5b5ff1500000006cdab57ff1500000089e41257ff15000041fc450057ff150011e28f000057ff150080ffcdc5c5d9ffd1963e7f7f7f7fadff8a5b00000000005bff1500000000000053fc1000"),
    '5': (9, -11, 0, 12, 9, "000f797b7b7b7b5400003fffd2cecece93000057ff0900000000000070ef0000000000000088e589b5a152000000a0ffb079abfe9200001f2b0000007dff270002000000002eff540efb7200000059ff2700b4f05f285aeccc00000ba3effff2ab0f00000000011c03000000"),
    '6': (9, -11, 0, 12, 9, "0000000018781f000000000003bfdd0d00000000007bfb38000000000038fb7e00000000000eddfffae09a1300008cff9f516febd30707f1a60000003aff5d1eff6600000002f68601ea970000002bff560081fd7d304cdad71000007bdcfff1b31a00000000001403000000"),
    '7': (9, -11, 1, 11, 8, "587b7b7b7b7b7503a0d5d5d5d5edfe0a0000000000d0bb00000000003eff4e0000000000acdd02000000001efb72000000000087f3100000000009ec96000000000063fe290000000000d0b900000000002ffd4800000000"),
    '8': (9, -11, 0, 12, 9, "0000216c94783600000042f0d9a1c6fd700000b8c40600008aef0400d59600000057fe140081f264284fddbf00000fe7fffffffe380000cbe1511c3bc1ee1b28ff5000000016fc6730ff5000000016fc6704d1e14e1938c0f31b001eacfbfff8c62b00000000041c05000000"),
    '9': (9, -11, 0, 11, 9, "00001d6f95742500000045f0e9b7e5f6560004e2c60c0007b6ef1029ff5b00000045ff4421ff660000004fff3e01ccda22001acee6070027d3fee4fdff5b000000063977fda7000000000002bbe010000000000074fc3d00000000001bf87f00000000"),
    '.': (3, -2, 1, 2, 2, "ba8df6bc"),
    '-': (7, -6, 1, 3, 6, "151b1b1b1a01f6ffffffff311c2323232202"),
    ' ': (3, -17, 0, 0, 0, ""),
}


def put_header_text(img: np.ndarray, text: str, org: Tuple[int, int]) -> None:
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255,
    255, 255), 1)`` in place, for the characters a mosaic header prints
    (``batch score`` and a number, ``nan``, ``inf`` or ``-inf`` included):
    each glyph's alpha composited "over" the image in white at its advance."""
    x0, base = int(org[0]), int(org[1])
    h, w = img.shape[:2]
    x = x0
    for ch in text:
        if ch not in _HEADER_GLYPHS:
            raise ValueError(f"put_header_text: no glyph for {ch!r}")
        advance, top, left, rows, cols, bits = _HEADER_GLYPHS[ch]
        if rows:
            alpha = np.frombuffer(bytes.fromhex(bits), np.uint8).reshape(rows, cols).astype(np.int64)
            gy, gx = base + top, x + left
            y0, y1, x0_, x1 = max(gy, 0), min(gy + rows, h), max(gx, 0), min(gx + cols, w)
            if y1 > y0 and x1 > x0_:  # clipped to the image
                a = alpha[y0 - gy:y1 - gy, x0_ - gx:x1 - gx][..., None]
                under = img[y0:y1, x0_:x1].astype(np.int64)
                img[y0:y1, x0_:x1] = ((under * (255 - a) + 255 * a + 127) // 255).astype(img.dtype)
        x += advance
