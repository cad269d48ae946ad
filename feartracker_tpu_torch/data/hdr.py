"""Radiance HDR (RGBE) as OpenCV 5.0's ``cv2.imread`` reads it, without cv2.

OpenCV reads these files with Greg Ward's RGBE reader (``rgbe.cpp``):

* the header is the lines up to the first blank one; one of them must be
  exactly ``FORMAT=32-bit_rle_rgbe`` (any other, e.g. ``32-bit_rle_xyze``,
  is refused); the others (``EXPOSURE``, ``GAMMA``, comments) are passed
  over and change nothing;
* the next line is ``-Y <height> +X <width>`` (as ``sscanf`` reads it: the
  spaces may be none or many); every other orientation is refused;
* the pixels are new-style run-length scanlines or flat RGBE quadruples
  (``csrc/imgcodecs.cpp:hdr_rle``);
* a pixel is ``m * 2^(e - 136)`` for each mantissa m (0 where e = 0), times
  255, then ``saturate_cast<uchar>`` (``convertTo``): rounded half to even,
  clamped to 0-255, and 0 where it rounds past int32.
"""

from __future__ import annotations

import ctypes
import functools
import re

import numpy as np

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def is_hdr(data: bytes) -> bool:
    return data.startswith(SIGNATURES)


def _lines(data: bytes, pos: int):
    """fgets-sized header lines from pos: (line with its newline, end)."""
    while pos < len(data):
        end = data.find(b"\n", pos, pos + 127)
        end = min(pos + 127, len(data)) if end < 0 else end + 1
        yield data[pos:end], end
        pos = end


def hdr_header(data: bytes) -> dict:
    """(width, height, offset of the pixels), checked as RGBE_ReadHeader
    checks it."""
    from feartracker_tpu_torch.data.imread import check_size

    found, size = False, None
    lines = _lines(data, 0)
    for line, end in lines:
        if line in (b"\n", b"") or line[:1] == b"\0":
            if not found:
                raise ValueError("RGBE bad file format: no FORMAT specifier found")
            size = next(lines, None)
            break
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            found = True
    if size is None:
        raise ValueError("RGBE read error: the header ends early")
    line, end = size
    m = _SIZE.match(line)
    if m is None:
        raise ValueError("RGBE bad file format: missing image size specifier (cv2 reads -Y <height> +X <width> only)")
    height, width = int(m.group(1)), int(m.group(2))
    check_size(width, height, "Radiance HDR")
    return {"width": width, "height": height, "offset": end}


def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance HDR bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    from feartracker_tpu_torch.data.imread import load_library

    hd = hdr_header(data)
    w, h = hd["width"], hd["height"]
    body = data[hd["offset"]:]
    rgbe = np.empty((h, w, 4), np.uint8)
    err = ctypes.create_string_buffer(128)
    if load_library().hdr_rle(body, len(body), w, h, rgbe.ctypes.data, err, len(err)):
        raise ValueError(f"Radiance HDR: {err.value.decode()}")
    return _table()[rgbe[..., 3:], rgbe[..., :3]]


@functools.cache
def _table() -> np.ndarray:
    """The 8-bit value of each (exponent, mantissa): m * 2^(e - 136) * 255,
    exact in float64, through ``saturate_cast<uchar>``; 0 where e = 0."""
    from feartracker_tpu_torch.data.imread import saturate_u8

    e, m = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return saturate_u8(np.where(e > 0, m * np.ldexp(1.0, e - 136), 0.0) * 255.0)
