"""``cv2.imread(path)`` without cv2, for the formats the datasets hold:
:func:`imread` → RGB uint8 (H, W, 3), the pixels of OpenCV 5.0's
``cv2.imread(path)[..., ::-1]``.

The decoder is picked from the file's first bytes, as cv2 picks it, never
from its name (an ImageNet file named ``.JPEG`` may hold a PNG):

* JPEG (``FF D8 FF``): ``data/jpeg.py`` (libjpeg-turbo 3.1's output,
  including CMYK/YCCK through OpenCV's own CMYK conversion, sampling
  factors up to 4, progressive block smoothing, arithmetic coding and
  lossless files);
* PNG (``89 50 4E 47``): chunks and ``zlib`` here, the row filters undone
  in ``csrc/imgcodecs.cpp``; every colour type at bit depths 1-16, palette
  (indices past the palette read black), Adam7; what libpng gives under
  OpenCV's settings: alpha and ``tRNS`` dropped (not composited), 16-bit
  samples as ``v >> 8``, grey replicated, ``gAMA``/``sBIT`` ignored, the
  ``eXIf`` orientation applied; a bad CRC on IHDR, PLTE or IDAT raises,
  one on an ancillary chunk drops that chunk;
* BMP (``BM``): OpenCV's own decoder (``grfmt_bmp.cpp``): 1, 4 and 8 bits
  with a palette, RLE4 and RLE8 (``csrc/imgcodecs.cpp``), 16 bits as 5-5-5
  or 5-6-5 (BITFIELDS) with the low bits zero, 24 bits, 32 bits with the
  fourth byte dropped; bottom-up and top-down rows; OS/2 headers;
* PNM (``P1``-``P6``): OpenCV's decoder (``grfmt_pxm.cpp``): ASCII samples
  scaled as ``v * 255 // maxval``, binary 8-bit samples as they are,
  samples of a maxval above 255 as ``v >> 8``; P1/P4 1 = black;
* PAM (``P7``): OpenCV's decoder (``grfmt_pam.cpp``): the header's WIDTH,
  HEIGHT, DEPTH, MAXVAL (required, decimal digits) and TUPLTYPE (without
  one, depth 1 or 3 at maxval 255 or below); samples as they are (maxval
  does not scale them), 16-bit ones as ``v >> 8``; maxval 1 reads each
  row's first bytes as packed bits, 1 = white; depth 3 lands in cv2's BGR
  order as stored; the alpha tuple types above maxval 1 raise (cv2's
  pixels for them come from memory past its row buffer);
* PFM (``PF``): OpenCV's decoder: rows bottom-up, the scale's sign the byte
  order, samples times float32(1 / |scale|) through ``saturate_cast<uchar>``
  (NaN, ±inf and values past int32 read 0); ``Pf`` (grey) raises, as
  ``cv2.imread`` in colour mode reads none;
* Sun raster (``59 A6 6A 95``): OpenCV's decoder: the old and standard
  types (cv2 reads neither the byte-encoded nor the RGB type), 1, 8, 24
  and 32 bits, rows padded to 16 bits, equal-RGB colour maps;
* TIFF (``II*\\0``, ``MM\\0*``, BigTIFF): ``data/tiff.py``, libtiff's RGBA
  reader as OpenCV drives it;
* GIF (``GIF87a``, ``GIF89a``): ``data/gif.py``, OpenCV's own decoder's
  first frame;
* WebP (``RIFF....WEBP``): ``data/webp.py``, libwebp's lossy and lossless
  decoders as OpenCV calls them;
* JPEG 2000 (a JP2 file or a raw ``FF 4F FF 51`` codestream):
  ``data/jp2.py`` + ``csrc/jp2.cpp``, OpenJPEG 2.5's samples and OpenCV's
  conversion to 8-bit BGR;
* Radiance HDR (``#?RADIANCE``, ``#?RGBE``): ``data/hdr.py``, Greg Ward's
  RGBE reader and ``convertTo`` as OpenCV uses them.

Anything else raises ``IOError``; AVIF, the one other format cv2 reads, is
named. A file a decoder takes but cannot read (a refused mode, a bad CRC,
truncated data) raises ``ValueError`` naming what failed, where
``cv2.imread`` returns None.

The C++ library builds with g++ at first use, beside the JPEG codec's
(``data/jpeg.py:build``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import struct
import zlib
from typing import Union

import numpy as np

from feartracker_tpu_torch.data import gif, hdr, jp2, jpeg, tiff, webp

SOURCE = jpeg.PACKAGE_DIR / "csrc" / "imgcodecs.cpp"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
READ = "JPEG, PNG, BMP, PNM, PAM, PFM, Sun raster, TIFF, GIF, WebP, JPEG 2000 and Radiance HDR"


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(jpeg.build(SOURCE)))
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    lib.bmp_rle.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.bmp_rle.restype = ctypes.c_int
    for name in ("tiff_lzw", "tiff_packbits"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.gif_lzw.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
    lib.gif_lzw.restype = ctypes.c_int
    lib.hdr_rle.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_char_p, ctypes.c_int]
    lib.hdr_rle.restype = ctypes.c_int
    lib.tiff_fax.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                             ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
    lib.tiff_fax.restype = ctypes.c_int
    lib.tiff_cielab.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.tiff_cielab.restype = ctypes.c_int
    return lib


def check_size(width: int, height: int, what: str) -> None:
    """OpenCV's ``validateInputImageSize``: sides above 0 and at most 2^20,
    at most 2^30 pixels."""
    if not (0 < width <= 1 << 20 and 0 < height <= 1 << 20 and width * height <= 1 << 30):
        raise ValueError(f"{what} of size {width}x{height}: outside cv2's image size limits")


def format_of(data: bytes) -> str:
    """The format cv2 would pick for these leading bytes: "jpeg", "png",
    "bmp", "pnm", "pam", "pfm", "sun", "tiff", "gif", "webp", "jp2", "hdr",
    "AVIF" (named, not read), or ""."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == PNG_SIGNATURE:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"123456" and data[2:3].isspace():
        return "pnm"
    if tiff.is_tiff(data):
        return "tiff"
    if gif.is_gif(data):
        return "gif"
    if webp.is_webp(data):
        return "webp"
    if data[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    if len(data) >= 3 and data[:2] in (b"PF", b"Pf") and data[2:3].isspace():
        return "pfm"
    if len(data) >= 3 and data[:2] == b"P7" and data[2:3].isspace():
        return "pam"
    if jp2.is_jp2(data):
        return "jp2"
    if hdr.is_hdr(data):
        return "hdr"
    if data.startswith(SUN_RASTER_SIGNATURE):
        return "sun"
    return ""


def imread(src: Union[str, os.PathLike, bytes, bytearray, memoryview]) -> np.ndarray:
    """A file (path) or its bytes → (H, W, 3) uint8 RGB, equal to
    ``cv2.imread(path)[..., ::-1]``."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as fh:
            data = fh.read()
    else:
        data = bytes(src)
    kind = format_of(data)
    decode = DECODERS.get(kind)
    if decode is not None:
        return decode(data)
    if kind:
        raise IOError(f"{kind} images are not read here ({READ} are)")
    raise IOError(f"no {READ.replace(' and ', ' or ')} signature: not a format read here")


# -- PNG ------------------------------------------------------------------------

PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def tiff_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112, SHORT) of an EXIF TIFF block's first
    IFD; 1 when absent or unreadable."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            at = ifd + 2 + 12 * i
            tag, typ = struct.unpack(end + "HH", tiff[at:at + 4])
            if tag == 0x0112 and typ == 3:
                return struct.unpack(end + "H", tiff[at + 8:at + 10])[0]
    except struct.error:
        pass
    return 1


def png_chunks(data: bytes):
    """(type, payload) of each chunk before IEND, as libpng under OpenCV
    takes them: a bad CRC on IHDR, PLTE or IDAT raises, one on an ancillary
    chunk (lower-case first letter) drops the chunk, one on IEND is ignored;
    an unknown critical chunk raises."""
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG ends before IEND")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG chunk {kind!r} runs past the end of the file")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        critical = kind[0] & 0x20 == 0
        if critical and kind not in (b"IHDR", b"PLTE", b"IDAT", b"IEND"):
            raise ValueError(f"PNG {kind.decode('latin-1')}: unhandled critical chunk")
        if kind == b"IEND":
            return
        if zlib.crc32(kind + body) & 0xFFFFFFFF == crc:
            yield kind, body
        elif critical:
            raise ValueError(f"PNG {kind.decode('latin-1')}: CRC error")
        pos = end + 4


def _unfilter(lib, raw: memoryview, rows: int, rowbytes: int, bpp: int) -> np.ndarray:
    out = np.empty((rows, rowbytes), np.uint8)
    err = ctypes.create_string_buffer(128)
    if lib.png_unfilter(bytes(raw), rows, rowbytes, bpp, out.ctypes.data, err, len(err)):
        raise ValueError(f"PNG: {err.value.decode()}")
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows → (h, width, channels) 8-bit samples: 16-bit ones as
    their high byte (libpng's strip_16), those below 8 bits as values."""
    h = rows.shape[0]
    n = width * channels
    if depth == 16:
        return rows.reshape(h, -1, 2)[:, :n, 0].reshape(h, width, channels)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
        rows = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
    return rows[:, :n].reshape(h, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    ihdr, palette, orientation, idat = None, None, 1, []
    for kind, body in png_chunks(data):
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = tiff_orientation(body)
    if ihdr is None or len(ihdr) != 13:
        raise ValueError("PNG without a valid IHDR")
    W, H, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if W == 0 or H == 0 or ctype not in PNG_DEPTHS or depth not in PNG_DEPTHS[ctype] or comp or filt or interlace > 1:
        raise ValueError(f"PNG: invalid IHDR (size {W}x{H}, depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    if ctype == 3 and (palette is None or not palette or len(palette) % 3 or len(palette) > 768):
        raise ValueError("PNG: palette image without a valid PLTE")
    if not idat:
        raise ValueError("PNG without image data (IDAT)")
    C = PNG_CHANNELS[ctype]
    bpp = max(1, C * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(H - y0) // dy), -(-(W - x0) // dx)) for x0, y0, dx, dy in passes]
    need = sum(h * (1 + -(-w * C * depth // 8)) for h, w in sizes if h > 0 and w > 0)
    raw = _inflate(b"".join(idat), need)
    lib = load_library()
    img = np.empty((H, W, C), np.uint8)
    at = 0
    for (x0, y0, dx, dy), (h, w) in zip(passes, sizes):
        if h <= 0 or w <= 0:
            continue
        rowbytes = -(-w * C * depth // 8)
        rows = _unfilter(lib, raw[at:at + h * (rowbytes + 1)], h, rowbytes, bpp)
        at += h * (rowbytes + 1)
        img[y0::dy, x0::dx] = _samples(rows, w, C, depth)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        lut[:len(pal)] = pal
        rgb = lut[img[..., 0]]
    elif ctype in (0, 4):
        grey = img[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // (2 ** depth - 1))
        rgb = np.repeat(grey[..., None], 3, axis=2)
    else:
        rgb = img[..., :3]
    return jpeg.apply_orientation(rgb, orientation)


def _inflate(stream: bytes, need: int) -> memoryview:
    """The first ``need`` bytes of a zlib stream. Extra data is ignored, and
    so is damage past them (libpng reads no further than the rows); fewer
    bytes raise."""
    d = zlib.decompressobj()
    out = bytearray()
    step = 1 << 20
    try:
        for i in range(0, len(stream), step):
            out += d.decompress(stream[i:i + step], need - len(out))
            if len(out) >= need:
                break
    except zlib.error as e:
        if len(out) < need:
            raise ValueError(f"PNG: bad image data ({e})") from e
    if len(out) < need:
        raise ValueError("PNG: not enough image data")
    return memoryview(out)


# -- BMP ------------------------------------------------------------------------

def _bytes_at(data: bytes, offset: int, n: int, what: str) -> np.ndarray:
    if offset + n > len(data):
        raise ValueError(f"{what} is truncated")
    return np.frombuffer(data, np.uint8, n, offset)


BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def bmp_header(data: bytes) -> dict:
    """OpenCV's ``BmpDecoder::readHeader``: size, bits a pixel (15 for 5-5-5),
    compression, palette (256 RGB entries, zero past the file's), pixel
    offset, row order; ``ValueError`` for a file it refuses."""
    def u16(o):
        return struct.unpack("<H", data[o:o + 2])[0]

    def s32(o):
        return struct.unpack("<i", data[o:o + 4])[0]

    try:
        offset, size = s32(10), s32(14)
        pal = np.zeros((256, 3), np.uint8)
        if size >= 36:
            width, height, bpp, comp, clrused = s32(18), s32(22), s32(26) >> 16 & 0xFFFF, s32(30), s32(46)
            if not 0 <= comp <= BI_BITFIELDS:
                raise ValueError(f"BMP compression {comp} is not read (OpenCV reads RGB, RLE4, RLE8, BITFIELDS)")
            ok = width > 0 and height != 0 and (
                (bpp in (1, 4, 8, 24, 32) and comp == BI_RGB) or (bpp in (16, 32) and comp in (BI_RGB, BI_BITFIELDS))
                or (bpp == 4 and comp == BI_RLE4) or (bpp == 8 and comp == BI_RLE8))
            at = 14 + size
            if ok and bpp <= 8:
                if not 0 <= clrused <= 256:
                    raise ValueError(f"BMP palette of {clrused} colours")
                n = clrused or 1 << bpp
                quads = np.frombuffer(data[at:at + 4 * n], np.uint8)
                if quads.size != 4 * n:
                    raise ValueError("BMP ends inside its palette")
                pal[:n] = quads.reshape(n, 4)[:, 2::-1]
            elif ok and bpp == 16 and comp == BI_BITFIELDS:
                masks = struct.unpack("<III", data[at:at + 12])  # read after the header, as OpenCV reads them
                bpp = {(0x7C00, 0x3E0, 0x1F): 15, (0xF800, 0x7E0, 0x1F): 16}.get(masks, 0)
                ok = bool(bpp)
            elif ok and bpp == 16:
                bpp = 15
        elif size == 12:
            width, height, bpp, comp = u16(18), u16(20), s32(22) >> 16 & 0xFFFF, BI_RGB
            ok = width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)
            if ok and bpp <= 8:
                n = 1 << bpp
                triples = np.frombuffer(data[26:26 + 3 * n], np.uint8)
                if triples.size != 3 * n:
                    raise ValueError("BMP ends inside its palette")
                pal[:n] = triples.reshape(n, 3)[:, ::-1]
        else:
            ok = False
    except struct.error as e:
        raise ValueError("BMP header is truncated") from e
    if not ok:
        raise ValueError(f"BMP of this kind is not read (header {size} bytes, {bpp} bits, compression "
                         f"{comp if size >= 12 else '?'})")
    return {"width": width, "height": abs(height), "bottom_up": height > 0, "bpp": bpp, "comp": comp,
            "palette": pal, "offset": offset}


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    hd = bmp_header(data)
    W, H, bpp, off = hd["width"], hd["height"], hd["bpp"], hd["offset"]
    if H * W * 3 >= 1 << 30:
        raise ValueError("BMP too large for OpenCV's BMP reader")
    if off < 0:
        raise ValueError("BMP pixel offset is negative")
    if hd["comp"] in (BI_RLE4, BI_RLE8):
        idx = np.zeros((H, W), np.uint8)
        err = ctypes.create_string_buffer(128)
        body = data[off:]
        if load_library().bmp_rle(body, len(body), W, H, bpp, int(hd["bottom_up"]), idx.ctypes.data, err, len(err)):
            raise ValueError(f"BMP: {err.value.decode()}")
        return hd["palette"][idx]
    pitch = ((W * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    rows = _bytes_at(data, off, H * pitch, "BMP pixel data").reshape(H, pitch)
    if hd["bottom_up"]:
        rows = rows[::-1]
    if bpp <= 8:
        if bpp < 8:
            bits = np.unpackbits(rows, axis=1)[:, :W * bpp].reshape(H, W, bpp)
            idx = (bits << np.arange(bpp - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        else:
            idx = rows[:, :W]
        return hd["palette"][idx]
    if bpp in (15, 16):
        t = rows[:, :2 * W].copy().view("<u2").astype(np.int32)
        if bpp == 15:
            b, g, r = (t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8
        else:
            b, g, r = (t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8
        return np.stack([r, g, b], axis=-1).astype(np.uint8)
    n = bpp // 8
    return np.ascontiguousarray(rows[:, :n * W].reshape(H, W, n)[:, :, 2::-1])


# -- PNM ------------------------------------------------------------------------

_SPACE = b" \t\n\v\f\r"


def _read_number(data: bytes, pos: int):
    """OpenCV's ``ReadNumber``: skip white space and ``#`` comments, read
    the digits; the byte that ends the number is consumed. → (value, pos)."""
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("PNM ends before a number")
        c = data[pos]
        if 48 <= c <= 57:
            break
        if c == 35:  # '#': to the end of the line
            while pos < n and data[pos] not in b"\n\r":
                pos += 1
            pos += 1
        elif c in _SPACE:
            pos += 1
        else:
            raise ValueError(f"PNM: unexpected byte {c:#x} where a number should be")
    value = 0
    while pos < n and 48 <= data[pos] <= 57:
        value = value * 10 + data[pos] - 48
        pos += 1
    if value > 2 ** 31 - 1:
        raise ValueError("PNM number too large")
    return value, pos + 1


def pnm_header(data: bytes) -> dict:
    """OpenCV's ``PxMDecoder::readHeader``: kind (1-6), width, height,
    maxval and the offset of the samples."""
    kind = data[1] - 48
    width, pos = _read_number(data, 2)
    height, pos = _read_number(data, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _read_number(data, pos)
    if not (width > 0 and height > 0 and 0 < maxval < 1 << 16):
        raise ValueError(f"PNM header: size {width}x{height}, maxval {maxval}")
    return {"kind": kind, "width": width, "height": height, "maxval": maxval, "offset": pos}


def decode_pnm(data: bytes) -> np.ndarray:
    """P1-P6 bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    hd = pnm_header(data)
    kind, W, H, maxval, off = hd["kind"], hd["width"], hd["height"], hd["maxval"], hd["offset"]
    channels = 3 if kind in (3, 6) else 1
    n = W * H * channels
    if kind == 1:  # one digit a sample, 1 = black
        digits = re.sub(rb"\s", b"", re.sub(rb"#[^\n\r]*", b"", data[off:]))[:n]
        if len(digits) < n or not digits.isdigit():
            raise ValueError("PNM: P1 data ends early or holds a byte that is not a digit")
        img = np.where(np.frombuffer(digits, np.uint8) != 48, 0, 255).astype(np.uint8)
    elif kind == 4:
        pitch = (W + 7) // 8
        bits = np.unpackbits(_bytes_at(data, off, H * pitch, "PNM data").reshape(H, pitch), axis=1)[:, :W]
        img = np.where(bits == 1, 0, 255).astype(np.uint8)
    elif kind in (2, 3):
        tokens = re.sub(rb"#[^\n\r]*", b" ", data[off:]).split(None, n)[:n]
        if len(tokens) < n or not all(t.isdigit() for t in tokens):
            raise ValueError("PNM: ASCII data ends early or holds a byte that is not a digit")
        vals = np.minimum(np.array(tokens, dtype=np.int64), maxval)
        img = (vals >> 8 if maxval > 255 else vals * 255 // maxval).astype(np.uint8)
    else:
        raw = _bytes_at(data, off, 2 * n if maxval > 255 else n, "PNM data")
        img = raw[0::2] if maxval > 255 else raw
    img = img.reshape(H, W, channels)
    return np.ascontiguousarray(img if channels == 3 else np.repeat(img, 3, axis=2))


# -- PAM ------------------------------------------------------------------------

PAM_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3, b"RGB_ALPHA": 4}
PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")


def pam_header(data: bytes) -> dict:
    """OpenCV's ``PAMDecoder::readHeader``: width, height, depth, maxval,
    the tuple type's channel count (None where there is none) and the
    offset of the samples; ``ValueError`` where it reads nothing."""
    n, pos = len(data), 3
    fields = {}
    while True:
        while pos < n and data[pos] in _SPACE:
            pos += 1
        if pos >= n:
            raise ValueError("PAM header ends before ENDHDR")
        if data[pos] == 35:  # '#': to the end of the line
            while pos < n and data[pos] not in b"\n\r":
                pos += 1
            pos += 1
            continue
        start = pos
        while pos < n and data[pos] not in _SPACE:
            pos += 1
        ident = data[start:pos]
        if ident not in PAM_FIELDS:
            raise ValueError(f"PAM header: unknown field {ident[:16]!r}")
        value = b""
        if pos < n and data[pos] not in b"\n\r":
            while pos < n and data[pos] in _SPACE:
                pos += 1
            start = pos
            while pos < n and data[pos] not in b"\n\r":
                pos += 1
            value = data[start:pos].rstrip(_SPACE)
        pos += 1  # the line end
        if ident == b"ENDHDR":
            if value:
                raise ValueError("PAM header: ENDHDR followed by more text")
            break
        if ident in fields:
            raise ValueError(f"PAM header: {ident.decode()} given twice")
        if ident == b"TUPLTYPE":
            if value and value not in PAM_TUPLTYPES:
                raise ValueError(f"PAM tuple type {value[:32]!r} is not read (cv2 reads "
                                 f"{', '.join(t.decode() for t in PAM_TUPLTYPES)})")
            fields[ident] = PAM_TUPLTYPES.get(value)
        else:
            if not value.isdigit():
                raise ValueError(f"PAM header: {ident.decode()} {value[:16]!r} is not a number")
            fields[ident] = int(value)
    missing = [f.decode() for f in PAM_FIELDS[:4] if f not in fields]
    if missing:
        raise ValueError(f"PAM header without {', '.join(missing)}")
    width, height, depth, maxval = (fields[f] for f in PAM_FIELDS[:4])
    channels = fields.get(b"TUPLTYPE")
    if maxval > 65535:
        raise ValueError(f"PAM header: maxval {maxval}")
    check_size(width, height, "PAM")
    if channels is None:
        if maxval >= 256 or depth not in (1, 3):
            raise ValueError("PAM without a tuple type of depth other than 1 or 3 or maxval above 255: cv2 cannot "
                             "determine its format")
    elif channels != depth:
        raise ValueError(f"PAM depth {depth} does not fit its tuple type")
    return {"width": width, "height": height, "depth": depth, "maxval": maxval, "offset": pos}


def decode_pam(data: bytes) -> np.ndarray:
    """P7 bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them: maxval 1
    reads the rows' first bytes as packed bits (1 = white), maxval above 255
    reads big-endian 16-bit samples as ``v >> 8``, other samples are taken as
    they are (maxval does not scale them); depth 3 lands in cv2's BGR order as
    stored (an RGB file reads with red and blue swapped), depth 1 is grey.
    Tuple types with alpha raise above maxval 1: cv2's pixels for them
    come from memory past its row buffer."""
    hd = pam_header(data)
    W, H, D, maxval, off = hd["width"], hd["height"], hd["depth"], hd["maxval"], hd["offset"]
    size = 2 if maxval > 255 else 1
    rows = _bytes_at(data, off, H * W * D * size, "PAM data").reshape(H, W * D * size)
    if maxval == 1:
        bits = np.unpackbits(rows[:, :(W + 7) // 8], axis=1)[:, :W]
        return np.repeat((bits * np.uint8(255))[..., None], 3, axis=2)
    if D in (2, 4):
        raise ValueError("PAM with alpha (GRAYSCALE_ALPHA, RGB_ALPHA) above maxval 1: OpenCV 5.0's conversion reads "
                         "past its row buffer, so cv2.imread's pixels are not defined; not read")
    samples = (rows[:, 0::2] if size == 2 else rows).reshape(H, W, D)
    if D == 3:
        return np.ascontiguousarray(samples[..., ::-1])
    return np.repeat(samples, 3, axis=2)


# -- PFM ------------------------------------------------------------------------

_INT_PREFIX = re.compile(rb"[+-]?\d+")
_FLOAT_PREFIX = re.compile(rb"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _pfm_token(data: bytes, pos: int):
    """OpenCV's ``read_number``: the bytes up to one white-space byte, which is
    consumed. → (token, pos)."""
    end = pos
    while end < len(data) and data[end] not in _SPACE:
        end += 1
    if end >= len(data):
        raise ValueError("PFM header ends early")
    return data[pos:end], end + 1


def pfm_header(data: bytes) -> dict:
    """OpenCV's ``PFMDecoder::readHeader``: ``PF`` + a line break, then
    width, height and scale, each ended by one white-space byte and read as
    a stream reads a number from the token's start (0 where none)."""
    if data[2:3] != b"\n":
        raise ValueError("PFM: unexpected header format (expected a line break after PF)")
    if data[1:2] == b"f":
        raise ValueError("PFM with one channel (Pf): cv2.imread reads no grey PFM in colour mode")
    tokens, pos = [], 3
    for pattern in (_INT_PREFIX, _INT_PREFIX, _FLOAT_PREFIX):
        tok, pos = _pfm_token(data, pos)
        m = pattern.match(tok)
        tokens.append(float(m.group(0)) if m and pattern is _FLOAT_PREFIX else int(m.group(0)) if m else 0)
    width, height, scale = tokens
    check_size(width, height, "PFM")
    if scale == 0:
        raise ValueError("PFM scale factor 0")
    return {"width": width, "height": height, "scale": scale, "offset": pos}


def decode_pfm(data: bytes) -> np.ndarray:
    """PF bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them: rows
    bottom-up, little-endian where the scale is negative; each sample times
    float32(1 / |scale|), rounded half to even and saturated; NaN, ±inf and
    anything that rounds outside int32 read 0."""
    hd = pfm_header(data)
    W, H = hd["width"], hd["height"]
    raw = _bytes_at(data, hd["offset"], W * H * 12, "PFM data")
    img = raw.view("<f4" if hd["scale"] < 0 else ">f4").astype(np.float32).reshape(H, W, 3)[::-1]
    if abs(hd["scale"]) != 1:
        with np.errstate(over="ignore", invalid="ignore"):
            img = img * np.float32(1.0 / abs(hd["scale"]))
    return saturate_u8(img)


def saturate_u8(values: np.ndarray) -> np.ndarray:
    """OpenCV's ``saturate_cast<uchar>`` of floats: rounded half to even,
    then clamped to 0-255, except that NaN, ±inf and whatever rounds outside
    int32 give 0 (the x86 conversion's out-of-range value, INT_MIN)."""
    with np.errstate(invalid="ignore"):
        r = np.rint(values.astype(np.float64))
        bad = ~np.isfinite(r) | (r >= 2.0 ** 31) | (r < -(2.0 ** 31))
        return np.where(bad, 0, np.clip(np.nan_to_num(r), 0, 255)).astype(np.uint8)


# -- Sun raster -----------------------------------------------------------------

SUN_RASTER_SIGNATURE = b"\x59\xa6\x6a\x95"


def sun_raster_header(data: bytes) -> dict:
    """OpenCV's ``SunRasterDecoder::readHeader``: 1, 8, 24 or 32 bits; the
    old and standard types only (its check of the byte-encoded and RGB
    types compares the wrong field, so cv2 reads neither); no colour map, or
    an equal-RGB one of at most 3 * 2^bits bytes for 1 and 8 bits."""
    if len(data) < 32:
        raise ValueError("Sun raster header is truncated")
    _, width, height, bpp, _, kind, maptype, maplength = struct.unpack(">8i", data[:32])
    palsize = 3 * (1 << bpp) if 0 < bpp <= 8 else 0
    if bpp not in (1, 8, 24, 32):
        raise ValueError(f"Sun raster of {bpp} bits (cv2 reads 1, 8, 24 and 32)")
    check_size(width, height, "Sun raster")
    if kind not in (0, 1):
        raise ValueError(f"Sun raster type {kind} (byte-encoded, RGB or experimental) is not read by cv2, which "
                         f"reads the old and standard types only")
    if not ((maptype == 0 and maplength == 0) or (maptype == 1 and 0 < maplength <= palsize)):
        raise ValueError(f"Sun raster colour map (type {maptype}, {maplength} bytes) is not read by cv2")
    pal = np.zeros((256, 3), np.uint8)
    if maplength:
        m = _bytes_at(data, 32, maplength, "Sun raster colour map")
        n = maplength // 3
        pal[:n] = m[:3 * n].reshape(3, n).T
    elif bpp <= 8:
        pal[:1 << bpp] = np.repeat(np.linspace(0, 255, 1 << bpp).astype(np.uint8)[:, None], 3, axis=1)
    return {"width": width, "height": height, "bpp": bpp, "palette": pal, "offset": 32 + maplength}


def decode_sun_raster(data: bytes) -> np.ndarray:
    """Sun raster bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them:
    rows padded to 16 bits; 1 and 8 bits through the colour map (grey ramp
    without one: 1 = white); 24 bits B, G, R; 32 bits X, B, G, R."""
    hd = sun_raster_header(data)
    W, H, bpp = hd["width"], hd["height"], hd["bpp"]
    pitch = ((W * bpp + 7) // 8 + 1) & -2
    rows = _bytes_at(data, hd["offset"], H * pitch, "Sun raster data").reshape(H, pitch)
    if bpp == 1:
        return hd["palette"][np.unpackbits(rows, axis=1)[:, :W]]
    if bpp == 8:
        return hd["palette"][rows[:, :W]]
    px = rows[:, :bpp // 8 * W].reshape(H, W, bpp // 8)
    return np.ascontiguousarray(px[..., 2::-1] if bpp == 24 else px[..., 3:0:-1])


DECODERS = {"jpeg": jpeg.decode_jpeg, "png": decode_png, "bmp": decode_bmp, "pnm": decode_pnm, "pam": decode_pam,
            "pfm": decode_pfm, "sun": decode_sun_raster, "tiff": tiff.decode_tiff, "gif": gif.decode_gif,
            "webp": webp.decode_webp, "jp2": jp2.decode_jp2, "hdr": hdr.decode_hdr}
