"""TIFF as OpenCV 5.0's ``cv2.imread`` reads it (``grfmt_tiff.cpp`` on
libtiff 4.7's ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``), without cv2.

The first IFD of a classic (``II*\\0``, ``MM\\0*``) or BigTIFF (``II+\\0``,
``MM\\0+``) file, in strips or tiles, planar configuration 1 or 2:

* compression 1 (none), 5 (LZW), 8 and 32946 (Deflate, ``zlib``), 32773
  (PackBits), 7 (JPEG with ``JPEGTables``, each strip or tile through
  ``data/jpeg.py``: YCbCr files converted to RGB by the decoder, as libtiff
  asks libjpeg to, RGB and grey files taken as they are); predictor 2 after
  LZW and Deflate (libtiff ignores the tag after PackBits and none);
* what ``TIFFRGBAImage`` makes of the samples: grey (MinIsBlack,
  MinIsWhite) at 1, 8 and 16 bits as ``v * 255 // max`` (16 bits by their
  high byte), palette at 1, 4 and 8 bits (a colormap with any entry above
  255 taken as ``v >> 8``), RGB at 8 and 16 bits (16 bits as
  ``(v + 128) // 257``) with unassociated alpha premultiplied as
  ``(v * a + 127) // 255`` and any other alpha ignored, grey alpha ignored;
* the Orientation tag 1-4 applied. OpenCV's ``imread`` fails on 5-8, whose
  image it would have to transpose, and so does this reader.

The LZW and PackBits loops are ``csrc/imgcodecs.cpp``'s. Anything else
(CCITT, LZMA and ZSTD, which this cv2 build lacks too, old-style JPEG,
2-bit samples, float samples, CMYK, ...) raises ``ValueError`` naming it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from feartracker_tpu_torch.data import jpeg

TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
TYPE_FORMATS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q", 18: "Q"}
COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG", 32766: "NeXT",
                32771: "CCITT RLEW", 32809: "ThunderScan", 32909: "PixarLog", 34661: "JBIG", 34676: "SGILog",
                34677: "SGILog24", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
                50002: "JPEG XL"}
PHOTOMETRICS = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette", 4: "Mask", 5: "Separated (CMYK)",
                6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
PREDICTED = (5, 8, 32946)  # the codecs after which libtiff undoes a predictor


def is_tiff(data: bytes) -> bool:
    return data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def read_ifd(data: bytes) -> dict:
    """The first IFD's tags: {tag: list of numbers, or bytes for ASCII and
    UNDEFINED}; ``"<"`` or ``">"`` under key ``"order"``."""
    end = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"\x00+", b"+\x00")
    try:
        if big:
            bytesize, _, ifd = struct.unpack(end + "HHQ", data[4:16])
            if bytesize != 8:
                raise ValueError(f"BigTIFF offset size {bytesize}")
            (n,) = struct.unpack(end + "Q", data[ifd:ifd + 8])
            at, entry, inline = ifd + 8, 20, 8
        else:
            (ifd,) = struct.unpack(end + "I", data[4:8])
            (n,) = struct.unpack(end + "H", data[ifd:ifd + 2])
            at, entry, inline = ifd + 2, 12, 4
        tags = {"order": end}
        for i in range(n):
            e = at + entry * i
            if big:
                tag, typ, count = struct.unpack(end + "HHQ", data[e:e + 12])
                field = data[e + 12:e + 20]
            else:
                tag, typ, count = struct.unpack(end + "HHI", data[e:e + 8])
                field = data[e + 8:e + 12]
            size = TYPE_SIZES.get(typ)
            if size is None:
                continue
            nbytes = size * count
            if nbytes <= inline:
                raw = field[:nbytes]
            else:
                (off,) = struct.unpack(end + ("Q" if big else "I"), field)
                raw = data[off:off + nbytes]
            if len(raw) != nbytes:
                raise ValueError(f"TIFF tag {tag} runs past the end of the file")
            if typ in (2, 7):  # ASCII, UNDEFINED (JPEGTables)
                tags[tag] = bytes(raw)
            elif typ in TYPE_FORMATS:
                tags[tag] = list(struct.unpack(end + TYPE_FORMATS[typ] * count, raw))
            elif typ in (5, 10):
                v = struct.unpack(end + ("I" if typ == 5 else "i") * 2 * count, raw)
                tags[tag] = [a / b if b else 0.0 for a, b in zip(v[::2], v[1::2])]
        return tags
    except struct.error as e:
        raise ValueError("TIFF header or IFD is truncated") from e


def _one(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def tiff_header(data: bytes) -> dict:
    """The first IFD's layout, checked as OpenCV and ``TIFFRGBAImageOK``
    check it: ``ValueError`` naming what ``cv2.imread`` refuses or what this
    reader does not handle."""
    tags = read_ifd(data)
    W, H = _one(tags, 256, 0), _one(tags, 257, 0)
    if W <= 0 or H <= 0:
        raise ValueError(f"TIFF of size {W}x{H}")
    spp = _one(tags, 277, 1)
    bits_all = tags.get(258, [1])
    bits = bits_all[0]
    comp = _one(tags, 259, 1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    if 262 not in tags:
        raise ValueError("TIFF without a Photometric tag")
    photo = _one(tags, 262)
    fmt = _one(tags, 339, 1)
    if comp in COMPRESSIONS:
        raise ValueError(f"TIFF compression {comp} ({COMPRESSIONS[comp]}) is not read")
    if comp not in (1, 5, 7, 8, 32946, 32773):
        raise ValueError(f"TIFF compression {comp} is unknown")
    if fmt == 3:
        raise ValueError(f"TIFF of {bits}-bit float samples is not read")
    if fmt != 1:
        raise ValueError(f"TIFF sample format {fmt} (signed or complex) is not read")
    if any(b != bits for b in bits_all):
        raise ValueError("TIFF samples of different bit depths")
    if bits not in (1, 8, 16) and not (bits == 4 and photo == 3):
        raise ValueError(f"TIFF of {bits}-bit samples (OpenCV reads 1, 8 and 16; 4 with a palette)")
    if _one(tags, 266, 1) != 1:
        raise ValueError("TIFF FillOrder 2 is not read")
    if photo not in (0, 1, 2, 3, 6):
        raise ValueError(f"TIFF photometric {photo} ({PHOTOMETRICS.get(photo, 'unknown')}) is not read")
    extra = tags.get(338, [])
    colour = 3 if photo in (2, 6) else 1
    if spp - len(extra) < colour or spp < colour:
        raise ValueError(f"TIFF {PHOTOMETRICS[photo]} with {spp} samples a pixel")
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar}")
    separate = planar == 2 and spp > 1
    if photo in (0, 1, 3) and not separate and spp != 1 and bits < 8:
        raise ValueError(f"TIFF contiguous {bits}-bit data with {spp} samples a pixel")
    if photo in (2, 6) and bits not in (8, 16) or photo == 3 and bits == 16:
        raise ValueError(f"TIFF {PHOTOMETRICS[photo]} of {bits}-bit samples")
    if photo == 6 and (comp != 7 or separate):
        raise ValueError("TIFF YCbCr without JPEG compression is not read")
    if comp == 7 and (bits != 8 or separate or spp != colour):
        raise ValueError("TIFF JPEG other than 8-bit contiguous grey, RGB or YCbCr is not read")
    if predictor == 2 and comp in PREDICTED and bits not in (8, 16):
        raise ValueError(f"TIFF predictor 2 on {bits}-bit samples")
    if predictor not in (1, 2) and comp in PREDICTED:
        raise ValueError(f"TIFF predictor {predictor} is not read")
    if photo == 3 and 320 not in tags:
        raise ValueError("TIFF palette image without a ColorMap")
    orientation = _one(tags, 274, 1)
    if orientation in (5, 6, 7, 8):
        raise ValueError(f"TIFF orientation {orientation}: cv2.imread fails on a transposed TIFF")
    tiled = 322 in tags
    if tiled:
        tw, th = _one(tags, 322, 0), _one(tags, 323, 0)
        if tw <= 0 or th <= 0 or 324 not in tags or 325 not in tags:
            raise ValueError("TIFF tiles without a size, offsets or byte counts")
        offsets, counts = tags[324], tags[325]
    else:
        tw, th = W, min(_one(tags, 278, H) or H, H)
        if 273 not in tags or 279 not in tags:
            raise ValueError("TIFF strips without offsets or byte counts")
        offsets, counts = tags[273], tags[279]
    per_plane = -(-H // th) * (-(-W // tw) if tiled else 1)
    if len(offsets) < per_plane * (spp if separate else 1) or len(counts) < len(offsets):
        raise ValueError("TIFF has fewer strips or tiles than its size needs")
    return {"width": W, "height": H, "spp": spp, "bits": bits, "compression": comp, "photometric": photo,
            "separate": separate, "predictor": predictor if comp in PREDICTED else 1, "extra": extra,
            "orientation": orientation if orientation in (1, 2, 3, 4) else 1, "tiled": tiled, "tile": (th, tw),
            "offsets": offsets, "counts": counts, "tags": tags}


def _segment(lib, hd, data, k, occ, rows, cols):
    """Strip or tile k decoded to ``occ`` bytes (JPEG: to pixels)."""
    off, n = hd["offsets"][k], hd["counts"][k]
    raw = data[off:off + n]
    if len(raw) != n:
        raise ValueError("TIFF strip or tile runs past the end of the file")
    comp = hd["compression"]
    if comp == 1:
        if n < occ:
            raise ValueError("TIFF strip or tile shorter than its size")
        return np.frombuffer(raw, np.uint8, occ)
    if comp in (8, 32946):
        d = zlib.decompressobj()
        try:
            out = d.decompress(raw, occ)
        except zlib.error as e:
            raise ValueError(f"TIFF Deflate data: {e}") from e
        if len(out) < occ:
            raise ValueError("TIFF Deflate: not enough data for the strip or tile")
        return np.frombuffer(out, np.uint8)
    if comp == 7:
        return _jpeg_segment(hd, raw, rows, cols)
    out = np.empty(occ, np.uint8)
    err = ctypes.create_string_buffer(128)
    fn = lib.tiff_lzw if comp == 5 else lib.tiff_packbits
    if fn(raw, n, out.ctypes.data, occ, err, len(err)):
        raise ValueError(f"TIFF {err.value.decode()}")
    return out


def _jpeg_segment(hd, raw, rows, cols):
    tables = hd["tags"].get(347)
    if tables:
        tables = bytes(tables)  # UNDEFINED as the tag should be, or BYTE
        if tables[:2] != b"\xff\xd8" or raw[:2] != b"\xff\xd8":
            raise ValueError("TIFF JPEGTables or JPEG strip without an SOI marker")
        body = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
        raw = body + raw[2:]
    photo = hd["photometric"]
    img = jpeg.decode_tiff_jpeg(raw, ycbcr=photo == 6)
    if img.shape[0] < rows or img.shape[1] < cols:
        raise ValueError(f"TIFF JPEG strip or tile of {img.shape[1]}x{img.shape[0]}, smaller than {cols}x{rows}")
    return img[:rows, :cols] if photo in (2, 6) else img[:rows, :cols, :1]


def _samples(buf: np.ndarray, rows: int, cols: int, n: int, bits: int, order: str) -> np.ndarray:
    """Decoded bytes → (rows, cols, n) sample values."""
    if bits == 16:
        return buf[:rows * cols * n * 2].view(order + "u2").reshape(rows, cols, n)
    pitch = -(-cols * n * bits // 8)
    b = buf[:rows * pitch].reshape(rows, pitch)
    if bits == 8:
        return b[:, :cols * n].reshape(rows, cols, n)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = (b[:, :, None] >> shifts) & np.uint8(2 ** bits - 1)
    return v.reshape(rows, -1)[:, :cols * n].reshape(rows, cols, n)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    from feartracker_tpu_torch.data.imread import load_library

    hd = tiff_header(data)
    W, H, spp, bits = hd["width"], hd["height"], hd["spp"], hd["bits"]
    th, tw = hd["tile"]
    order = hd["tags"]["order"]
    planes = spp if hd["separate"] else 1
    per = spp if planes == 1 else 1
    lib = load_library() if hd["compression"] in (5, 32773) else None
    dtype = np.uint16 if bits == 16 else np.uint8
    jpeg_px = hd["compression"] == 7
    out = np.zeros((H, W, 3 if jpeg_px and hd["photometric"] in (2, 6) else spp), dtype)
    k = 0
    for p in range(planes):
        for y in range(0, H, th):
            for x in range(0, W, tw) if hd["tiled"] else (0,):
                rows = th if hd["tiled"] else min(th, H - y)
                cols = tw
                occ = rows * (-(-cols * per * bits // 8))
                seg = _segment(lib, hd, data, k, occ, rows, cols)
                k += 1
                s = seg if jpeg_px else _samples(seg, rows, cols, per, bits, order)
                if hd["predictor"] == 2:  # horizontal differences along each row, modulo the sample's range
                    s = np.cumsum(s, axis=1, dtype=s.dtype)
                h, w = min(rows, H - y), min(cols, W - x)
                out[y:y + h, x:x + w, p:p + s.shape[2]] = s[:h, :w]
    return jpeg.apply_orientation(_to_rgb(hd, out), hd["orientation"])


def _to_rgb(hd: dict, s: np.ndarray) -> np.ndarray:
    """``TIFFRGBAImage``'s put routines, alpha dropped as OpenCV drops it."""
    photo, bits, extra = hd["photometric"], hd["bits"], hd["extra"]
    if hd["compression"] == 7 and photo in (2, 6):
        return np.ascontiguousarray(s[..., :3])
    if photo in (0, 1):
        rng = 255 if bits == 16 else 2 ** bits - 1
        v = s[..., 0].astype(np.int32)
        if bits == 16:
            v >>= 8
        g = ((rng - v) if photo == 0 else v) * 255 // rng
        return np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)
    if photo == 3:
        cmap = np.asarray(hd["tags"][320], np.int64).reshape(3, -1).T
        n = 2 ** bits
        if cmap.shape[0] < n:
            raise ValueError("TIFF ColorMap shorter than the palette")
        cmap = cmap[:n]
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.astype(np.uint8)[s[..., 0]]
    rgb = s[..., :3].astype(np.int32)
    alpha = s[..., 3].astype(np.int32) if s.shape[2] > 3 else None
    if bits == 16:
        rgb = (rgb + 128) // 257
        alpha = None if alpha is None else (alpha + 128) // 257
    if extra and extra[0] == 2 and alpha is not None:
        rgb = (rgb * alpha[..., None] + 127) // 255
    return rgb.astype(np.uint8)
