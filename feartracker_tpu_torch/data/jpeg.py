"""JPEG decode and encode on the host, without cv2: ``csrc/jpeg.cpp``,
built with g++ at first use and bound with ctypes.

The codec gives the bytes that OpenCV 5.0 (libjpeg-turbo 3.1) gives:

* :func:`decode_jpeg` equals ``cv2.imread`` / ``cv2.imdecode(buf,
  IMREAD_COLOR)`` with the channels in RGB order: baseline and progressive
  Huffman, 8-bit, 1, 3 or 4 components (CMYK and YCCK through OpenCV's own
  CMYK conversion) at sampling factors 1-4, progressive block smoothing,
  restart intervals, the EXIF orientation applied as ``imread`` applies
  it. Arithmetic coding, lossless, hierarchical, 12-bit, DNL and
  2-component files raise ``ValueError`` naming the mode;
* :func:`encode_jpeg` equals ``cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY,
  q])`` of the same image in BGR order (``cv2.imwrite`` is q 95);
* :func:`jpeg_roundtrip` is ``cv2.imdecode(cv2.imencode(".jpg", img, q))``
  with cv2's channel convention: channel 0 is taken as blue, as cv2 takes
  it, whatever the caller holds (``ImageCompression`` hands cv2 RGB).

Build (once per source hash, into ``feartracker_tpu_torch/_kernels_build/``;
:func:`build` also builds ``csrc/imgcodecs.cpp`` for ``data/imread.py``)::

    g++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off csrc/jpeg.cpp -o libfear_jpeg_<hash>.so

The library is separate from the CUDA kernels' (``ops/cuda/build.py``): the
host needs no nvcc for it. ctypes drops the GIL during a call, so loader
threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Union

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "jpeg.cpp"
BUILD_DIR = PACKAGE_DIR / "_kernels_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_build_locks = {}  # source path → the lock its build holds: builds of different sources run at once
_locks_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _compiler(source: Path) -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the host codecs build from csrc/{source.name} with g++")
    return gxx


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (a host C++ file of ``csrc/``) if no build of its
    current text exists; return the library's path,
    ``_kernels_build/libfear_<stem>_<hash>.so``."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfear_{source.stem}_{digest}.so"
    with _locks_lock:
        lock = _build_locks.setdefault(source, threading.Lock())
    with lock:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, "lib.so")
            proc = subprocess.run([_compiler(source), *CXX_FLAGS, str(source), "-o", out], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {source.name} failed:\n{proc.stdout}{proc.stderr}"[-4000:])
            os.replace(out, lib)  # atomic: concurrent builds race harmlessly
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.jpg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(_U8P),
                               ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.jpg_decode.restype = ctypes.c_int
    lib.jpg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_size_t),
                               ctypes.c_char_p, ctypes.c_int]
    lib.jpg_encode.restype = ctypes.c_int
    lib.jpg_free.argtypes = [ctypes.c_void_p]
    lib.jpg_free.restype = None
    return lib


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` (EXIF tag 0x0112, values 1-8; any
    other value leaves the image as it is)."""
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    elif orientation == 5:
        img = img.transpose(1, 0, 2)
    elif orientation == 6:
        img = img.transpose(1, 0, 2)[:, ::-1]
    elif orientation == 7:
        img = img[::-1, ::-1].transpose(1, 0, 2)
    elif orientation == 8:
        img = img.transpose(1, 0, 2)[::-1]
    return np.ascontiguousarray(img)


# jpg_decode's mode bits (csrc/jpeg.cpp)
DECODE_BLUE_FIRST, DECODE_AS_IS, DECODE_YCBCR, DECODE_FOUR, DECODE_ONE = 1, 2, 4, 8, 16


def _decode(data: bytes, blue_first: bool, mode: int = 0, orient: bool = True, channels: int = 3) -> np.ndarray:
    lib = load_library()
    out = _U8P()
    h, w, o = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    mode |= DECODE_BLUE_FIRST if blue_first else 0
    rc = lib.jpg_decode(data, len(data), mode, ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(o), err, len(err))
    if rc != 0:
        raise ValueError(f"cannot decode JPEG: {err.value.decode()}")
    try:
        img = np.ctypeslib.as_array(out, shape=(h.value, w.value, channels)).copy()
    finally:
        lib.jpg_free(out)
    return apply_orientation(img, o.value) if orient else img


def decode_jpeg(src: Union[bytes, bytearray, memoryview, str, os.PathLike]) -> np.ndarray:
    """A JPEG file (path) or its bytes → (H, W, 3) uint8 RGB, equal to
    ``cv2.imread(path)[..., ::-1]``."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = bytes(src)
    return _decode(data, blue_first=False)


def decode_tiff_jpeg(data: bytes, ycbcr: bool, components: int = 3) -> np.ndarray:
    """One JPEG strip or tile of a TIFF (its JPEGTables already in front)
    holding ``components`` components (1, 3 or 4, else ``ValueError``) →
    (h, w, 3) uint8, or (h, w, 4) for four: YCbCr converted to RGB where
    ``ycbcr`` (libtiff's JPEGCOLORMODE_RGB), else the components as they are
    (JCS_UNKNOWN; one replicated); no EXIF orientation."""
    mode = (DECODE_YCBCR if ycbcr else DECODE_AS_IS) | {1: DECODE_ONE, 3: 0, 4: DECODE_FOUR}[components]
    return _decode(data, False, mode, orient=False, channels=4 if components == 4 else 3)


def _encode(img: np.ndarray, quality: int, blue_first: bool) -> bytes:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: need (H, W) or (H, W, 3) uint8, got {img.dtype} {img.shape}")
    c = 1 if img.ndim == 2 else 3
    lib = load_library()
    out = _U8P()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    rc = lib.jpg_encode(img.ctypes.data, img.shape[0], img.shape[1], c, int(quality), int(blue_first),
                        ctypes.byref(out), ctypes.byref(n), err, len(err))
    if rc != 0:
        raise ValueError(f"cannot encode JPEG: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.jpg_free(out)


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB or (H, W) gray uint8 → JPEG bytes, equal to
    ``cv2.imencode(".jpg", img[..., ::-1], [IMWRITE_JPEG_QUALITY, quality])``."""
    return _encode(img, quality, blue_first=False)


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY,
    quality])[1], IMREAD_COLOR)``: channel 0 is encoded as blue and decoded
    back into channel 0, as cv2 does with whatever order it is given."""
    return _decode(_encode(img, quality, blue_first=True), blue_first=True)
