"""WebP as OpenCV 5.0's ``cv2.imread`` reads it through libwebp, without
cv2 or PIL.

The RIFF container is read here: a simple lossy (``VP8 ``) or lossless
(``VP8L``) file, or an extended one (``VP8X``) whose ``ALPH``, ``EXIF``,
``ICCP`` and other chunks are passed over as libwebp's BGR decode passes
them (the alpha plane is not applied), the orientation of the first
``EXIF`` chunk applied where the VP8X flags announce EXIF (OpenCV reads it
through libwebp's demuxer), and the first frame of an animation (``ANMF``),
placed on a transparent black canvas. The bitstreams are decoded by
``csrc/webp.cpp``: VP8 key frames as RFC 6386 specifies, then libwebp's
"fancy" chroma upsampler and fixed-point YUV->RGB; VP8L with its prefix
codes, colour cache, backward references and four transforms. What libwebp
refuses raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from feartracker_tpu_torch.data import jpeg

SOURCE = jpeg.PACKAGE_DIR / "csrc" / "webp.cpp"


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(jpeg.build(SOURCE)))
    lib.webp_vp8.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.webp_vp8.restype = ctypes.c_int
    lib.webp_vp8l.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_char_p, ctypes.c_int]
    lib.webp_vp8l.restype = ctypes.c_int
    return lib


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload size) of each chunk in [pos, end)."""
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > end:
            raise ValueError(f"WebP chunk {kind!r} runs past the end of the file")
        yield kind, pos + 8, size
        pos += 8 + size + (size & 1)


def _bitstream(data: bytes, pos: int, end: int):
    """The first VP8 or VP8L chunk from pos on: (kind, payload)."""
    for kind, at, size in _chunks(data, pos, end):
        if kind in (b"VP8 ", b"VP8L"):
            return kind, data[at:at + size]
    raise ValueError("WebP without a VP8 or VP8L bitstream")


def _size(kind: bytes, payload: bytes):
    if kind == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F:
            raise ValueError("WebP VP8L: bad signature")
        (bits,) = struct.unpack("<I", payload[1:5])
        if bits >> 29:
            raise ValueError(f"WebP VP8L version {bits >> 29}")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP VP8: bad frame header")
    if payload[0] & 1:
        raise ValueError("WebP VP8: not a key frame")
    return (payload[6] | payload[7] << 8) & 0x3FFF, (payload[8] | payload[9] << 8) & 0x3FFF


def webp_header(data: bytes) -> dict:
    """Canvas size, where the first frame's bitstream lies and the EXIF
    orientation, checked as ``WebPGetFeatures`` and the animation decoder
    check them."""
    from feartracker_tpu_torch.data.imread import tiff_orientation

    if len(data) < 20:
        raise ValueError("WebP header is truncated")
    (riff,) = struct.unpack("<I", data[4:8])
    if riff < 12 or riff + 8 > len(data):
        raise ValueError("WebP RIFF size past the end of the file")
    end = riff + 8
    first = data[12:16]
    if first == b"VP8X":
        (size,) = struct.unpack("<I", data[16:20])
        if size != 10 or len(data) < 30:
            raise ValueError("WebP VP8X chunk of a bad size")
        flags = data[20]
        cw = 1 + int.from_bytes(data[24:27], "little")
        ch = 1 + int.from_bytes(data[27:30], "little")
        orientation = 1
        if flags & 0x08:  # the EXIF flag: the first EXIF chunk's orientation
            exif = next((data[at:at + size] for kind, at, size in _chunks(data, 30, end) if kind == b"EXIF"), b"")
            orientation = tiff_orientation(exif)
        if flags & 0x02:  # animation: the first ANMF frame
            for kind, at, size in _chunks(data, 30, end):
                if kind == b"ANMF":
                    if size < 16:
                        raise ValueError("WebP ANMF chunk too short")
                    x = 2 * int.from_bytes(data[at:at + 3], "little")
                    y = 2 * int.from_bytes(data[at + 3:at + 6], "little")
                    fw = 1 + int.from_bytes(data[at + 6:at + 9], "little")
                    fh = 1 + int.from_bytes(data[at + 9:at + 12], "little")
                    kind2, payload = _bitstream(data, at + 16, at + size)
                    if (fw, fh) != _size(kind2, payload) or x + fw > cw or y + fh > ch:
                        raise ValueError("WebP ANMF frame does not fit its canvas")
                    return {"width": cw, "height": ch, "kind": kind2, "payload": payload, "offset": (x, y),
                            "orientation": orientation}
            raise ValueError("WebP animation without a frame")
        kind, payload = _bitstream(data, 30, end)
        if _size(kind, payload) != (cw, ch):
            raise ValueError("WebP bitstream size differs from the VP8X canvas")
        return {"width": cw, "height": ch, "kind": kind, "payload": payload, "offset": None,
                "orientation": orientation}
    kind, payload = _bitstream(data, 12, end)
    w, h = _size(kind, payload)
    return {"width": w, "height": h, "kind": kind, "payload": payload, "offset": None, "orientation": 1}


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    hd = webp_header(data)
    kind, payload = hd["kind"], hd["payload"]
    w, h = _size(kind, payload)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(128)
    lib = load_library()
    if kind == b"VP8L":
        rc = lib.webp_vp8l(payload, len(payload), w, h, out.ctypes.data, err, len(err))
    else:
        rc = lib.webp_vp8(payload, len(payload), out.ctypes.data, err, len(err))
    if rc:
        raise ValueError(f"WebP: {err.value.decode()}")
    if hd["offset"] is not None:  # the animation's canvas starts transparent black
        canvas = np.zeros((hd["height"], hd["width"], 3), np.uint8)
        x, y = hd["offset"]
        canvas[y:y + h, x:x + w] = out
        out = canvas
    return jpeg.apply_orientation(out, hd["orientation"])
