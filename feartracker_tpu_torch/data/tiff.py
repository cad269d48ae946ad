"""TIFF as OpenCV 5.0's ``cv2.imread`` reads it (``grfmt_tiff.cpp`` on
libtiff 4.7's ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``), without cv2.

The first IFD of a classic (``II*\\0``, ``MM\\0*``) or BigTIFF (``II+\\0``,
``MM\\0+``) file, in strips or tiles, planar configuration 1 or 2:

* compression 1 (none), 5 (LZW), 8 and 32946 (Deflate, ``zlib``), 32773
  (PackBits), 7 (JPEG with ``JPEGTables``, each strip or tile through
  ``data/jpeg.py``: YCbCr files converted to RGB by the decoder, as libtiff
  asks libjpeg to, other colour spaces' components taken as they are, one
  component a strip in planar files); 2 (CCITT Modified Huffman), 32771
  (CCITT RLEW), 3 (CCITT Group 3, 1-D and 2-D) and 4 (Group 4) on 1-bit
  samples; predictor 2 after LZW and Deflate (libtiff ignores the tag after
  PackBits and none); FillOrder 2 (the bits of each raw strip reversed before
  any codec but JPEG, which ignores the tag; the fax decoders read it);
* what ``TIFFRGBAImage`` makes of the samples: grey (MinIsBlack,
  MinIsWhite) at 1, 8 and 16 bits as ``v * 255 // max`` (16 bits by their
  high byte), palette at 1, 4 and 8 bits (a colormap with any entry above
  255 taken as ``v >> 8``), RGB at 8 and 16 bits (16 bits as
  ``(v + 128) // 257``) with unassociated alpha premultiplied as
  ``(v * a + 127) // 255`` and any other alpha ignored, grey alpha ignored;
  8-bit CMYK (InkSet 1, four samples, contiguous or planar) as
  ``k = 255 - K``, ``R = k * (255 - C) // 255``; CIELab at 8 and
  16 bits, contiguous, through ``TIFFCIELabToRGB`` (display sRGB, the
  WhitePoint tag or D50) in ``csrc/imgcodecs.cpp:tiff_cielab``; 8-bit YCbCr
  without JPEG (YCbCrSubsampling 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4 in
  packed blocks, 1x1 planar) through ``TIFFYCbCrToRGB``'s fixed-point
  tables from YCbCrCoefficients and ReferenceBlackWhite; signed samples
  (SampleFormat 2) as unsigned ones; a tile cut by the right edge, of grey
  or palette pixels over a byte, read with libtiff's row step there;
* the Orientation tag 1-4 applied. OpenCV's ``imread`` fails on 5-8, whose
  image it would have to transpose, and so does this reader.

The LZW, PackBits and CCITT loops are ``csrc/imgcodecs.cpp``'s. Modified
Huffman and Group 4 data that ends early leaves the rows not reached zero
bits, as cv2's read does (libtiff's decoder fails, OpenCV reads on); Group 3
data that ends early raises (cv2 decodes the missing rows from a re-read of
the strip in libtiff's no-EOL mode: rows that are not the file's). What
both readers refuse raises ``ValueError`` naming it: sizes past cv2's
limits (sides of 2^20, 2^30 pixels, 1 GiB of RGBA a strip or tile, a
strip's height its RowsPerStrip), RowsPerStrip 0, 16-bit CMYK and YCbCr,
another InkSet, float samples, ICCLab, ITULab, planar CIELab, 2-bit samples
and 4-bit grey, YCbCr subsampling other than those above, LZMA and ZSTD
(which this cv2 build lacks); so do, not probed for want of a writer,
old-style JPEG, NeXT, ThunderScan, PixarLog, SGILog, JBIG and LERC.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from feartracker_tpu_torch.data import jpeg

TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
TYPE_FORMATS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q", 18: "Q"}
COMPRESSIONS = {6: "old-style JPEG", 32766: "NeXT", 32809: "ThunderScan", 32909: "PixarLog", 34661: "JBIG",
                34676: "SGILog", 34677: "SGILog24", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA", 50000: "ZSTD",
                50001: "WebP", 50002: "JPEG XL"}
PHOTOMETRICS = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette", 4: "Mask", 5: "Separated (CMYK)",
                6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
PREDICTED = (5, 8, 32946)  # the codecs after which libtiff undoes a predictor
FAX = (2, 3, 4, 32771)  # CCITT Modified Huffman, Group 3, Group 4, RLEW
READ_COMPRESSIONS = (1, 5, 7, 8, 32946, 32773) + FAX
YCBCR_SUBSAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))  # libtiff's put routines
LUMA = (0.299, 0.587, 0.114)  # YCbCrCoefficients' default


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
            elif typ in (5, 10):  # as libtiff reads a rational into a float: (float) a / (float) b
                v = np.frombuffer(raw, end + ("u4" if typ == 5 else "i4")).astype(np.float32)
                tags[tag] = [float(a / b) if b else 0.0 for a, b in zip(v[::2], v[1::2])]
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
    from feartracker_tpu_torch.data.imread import check_size

    tags = read_ifd(data)
    W, H = _one(tags, 256, 0), _one(tags, 257, 0)
    if W <= 0 or H <= 0:
        raise ValueError(f"TIFF of size {W}x{H}")
    check_size(W, H, "TIFF")
    spp = _one(tags, 277, 1)
    bits_all = tags.get(258, [1])
    bits = bits_all[0]
    comp = _one(tags, 259, 1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    if 262 not in tags:
        raise ValueError("TIFF without a Photometric tag")
    photo = _one(tags, 262)
    fmts = tags.get(339, [1])
    fmt = fmts[0]
    if comp in COMPRESSIONS:
        raise ValueError(f"TIFF compression {comp} ({COMPRESSIONS[comp]}) is not read")
    if comp not in READ_COMPRESSIONS:
        raise ValueError(f"TIFF compression {comp} is unknown")
    if any(f != fmt for f in fmts):
        raise ValueError(f"TIFF sample formats {fmts} differing between samples")
    if fmt == 3:
        raise ValueError(f"TIFF of {bits}-bit float samples is not read")
    if fmt not in (1, 2):  # libtiff's RGBA reader takes signed integers' bits as unsigned ones
        raise ValueError(f"TIFF sample format {fmt} (complex or undefined) is not read")
    if any(b != bits for b in bits_all):
        raise ValueError("TIFF samples of different bit depths")
    if comp in FAX and bits != 1:
        raise ValueError(f"TIFF CCITT compression {comp} of {bits}-bit samples (libtiff decodes 1-bit ones)")
    if bits not in (1, 8, 16) and not (bits == 4 and photo == 3):
        raise ValueError(f"TIFF of {bits}-bit samples (OpenCV reads 1, 8 and 16; 4 with a palette)")
    fill_order = _one(tags, 266, 1)
    if fill_order not in (1, 2):
        raise ValueError(f"TIFF FillOrder {fill_order} is not read")
    if photo not in (0, 1, 2, 3, 5, 6, 8):
        raise ValueError(f"TIFF photometric {photo} ({PHOTOMETRICS.get(photo, 'unknown')}) is not read")
    extra = tags.get(338, [])
    colour = {2: 3, 5: 4, 6: 3, 8: 3}.get(photo, 1)
    if spp < colour or (photo != 5 and spp - len(extra) < colour):
        raise ValueError(f"TIFF {PHOTOMETRICS[photo]} with {spp} samples a pixel")
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar}")
    separate = planar == 2 and spp > 1
    if photo in (0, 1, 3) and not separate and spp != 1 and bits < 8:
        raise ValueError(f"TIFF contiguous {bits}-bit data with {spp} samples a pixel")
    if photo in (2, 8) and bits not in (8, 16) or photo in (5, 6) and bits != 8 or photo == 3 and bits == 16:
        raise ValueError(f"TIFF {PHOTOMETRICS[photo]} of {bits}-bit samples")
    if photo == 5 and _one(tags, 332, 1) != 1:
        raise ValueError(f"TIFF separated image with InkSet {_one(tags, 332)} (only CMYK, InkSet 1, is read)")
    if photo == 5 and spp != 4:  # OpenCV reads at most 4 channels; libtiff's planar CMYK takes 4 planes
        raise ValueError(f"TIFF CMYK with {spp} samples a pixel")
    if photo == 8 and (spp != 3 or separate):
        raise ValueError(f"TIFF CIELab {'planar' if separate else f'with {spp} samples a pixel'}")
    white = tags.get(318)
    if photo == 8 and white is not None and (len(white) < 2 or white[1] == 0):
        raise ValueError(f"TIFF CIELab WhitePoint {white}")
    sub = None
    if photo == 6 and (comp != 7 or separate):  # YCbCr that libtiff's put routines convert
        sub = tuple(tags.get(530, [2, 2])[:2])
        if spp != 3:
            raise ValueError(f"TIFF YCbCr with {spp} samples a pixel")
        if sub not in YCBCR_SUBSAMPLING or separate and sub != (1, 1):
            raise ValueError(f"TIFF {'planar ' if separate else ''}YCbCr subsampling {sub[0]}x{sub[1]}")
        luma = tags.get(529, list(LUMA))
        if len(luma) < 3 or luma[1] == 0:
            raise ValueError(f"TIFF YCbCrCoefficients {luma}")
        if sub == (1, 1):
            sub = None  # pixel-interleaved: read as other samples are
    if comp == 7 and (bits != 8 or not separate and spp != colour):
        raise ValueError(f"TIFF JPEG of {bits}-bit samples, {spp} a pixel: only 8-bit, one JPEG component a colour "
                         "sample (contiguous) or a strip or tile a plane (planar), is read")
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
        tile_bytes = th * -(-tw * (1 if separate else spp) * bits // 8)
        if comp == 1 and fill_order == 2 and tile_bytes % 1024:
            # libtiff reads these tiles through its unmapped path, as cv2.imdecode does, which fails on them
            raise ValueError(f"TIFF FillOrder 2 uncompressed tiles of {tile_bytes} bytes (not a multiple of 1024)")
        offsets, counts = tags[324], tags[325]
    else:
        if _one(tags, 278) == 0:
            raise ValueError("TIFF RowsPerStrip 0")  # libtiff's directory reader refuses it
        tw, th = W, min(_one(tags, 278, H), H)
        if 273 not in tags or 279 not in tags:
            raise ValueError("TIFF strips without offsets or byte counts")
        offsets, counts = tags[273], tags[279]
    # OpenCV's tile buffer: each side at most 2^24 and 4 bytes a pixel under 1 GiB (a strip's side is its
    # RowsPerStrip, not cut to the image)
    side = th if tiled else _one(tags, 278, 0) if _one(tags, 278, 0) not in (0, 2 ** 32 - 1) else H
    if not (0 < side <= 1 << 24 and 0 < tw <= 1 << 24 and 4 * side * tw < 1 << 30):
        raise ValueError(f"TIFF {'tiles' if tiled else 'strips'} of {tw}x{side}: over cv2's 1 GiB tile buffer")
    per_plane = -(-H // th) * (-(-W // tw) if tiled else 1)
    if len(offsets) < per_plane * (spp if separate else 1) or len(counts) < len(offsets):
        raise ValueError("TIFF has fewer strips or tiles than its size needs")
    return {"width": W, "height": H, "spp": spp, "bits": bits, "compression": comp, "photometric": photo,
            "separate": separate, "predictor": predictor if comp in PREDICTED else 1, "extra": extra,
            "orientation": orientation if orientation in (1, 2, 3, 4) else 1, "tiled": tiled, "tile": (th, tw),
            "offsets": offsets, "counts": counts, "tags": tags, "fill_order": fill_order, "subsampling": sub}


REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _ycbcr_sizes(hd: dict, rows: int, cols: int):
    """Packed YCbCr blocks: (the bytes libtiff decodes for a strip or tile of
    ``rows`` x ``cols``, the row size its predictor steps by). A strip's
    read stops at whole scanlines (``TIFFScanlineSize``, a block row over
    the vertical subsampling, rounded down), as ``gtStripContig`` asks."""
    hs, vs = hd["subsampling"]
    row_size = -(-cols // hs) * (hs * vs + 2)
    size = -(-rows // vs) * row_size
    if hd["tiled"]:
        return size, cols * 3
    scanline = row_size // vs
    return min(size, -(-rows // vs) * vs * scanline), scanline


def _segment(lib, hd, data, k, occ, rows, cols, per, runs):
    """Strip or tile k decoded to ``occ`` bytes (JPEG: to pixels). ``runs``:
    the CCITT decoder's run arrays, which libtiff keeps from one strip or
    tile of the image to the next."""
    off, n = hd["offsets"][k], hd["counts"][k]
    raw = data[off:off + n]
    if len(raw) != n:
        raise ValueError("TIFF strip or tile runs past the end of the file")
    comp = hd["compression"]
    if hd["fill_order"] == 2 and comp not in FAX + (7,):  # libtiff reverses the raw bits; JPEG and fax read them
        raw = raw.translate(REVERSED_BITS)
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
        return _jpeg_segment(hd, raw, rows, cols, per)
    out = np.zeros(occ, np.uint8)
    err = ctypes.create_string_buffer(128)
    if comp in FAX:
        t4 = _one(hd["tags"], 292, 0) if comp == 3 else 0
        # 1: libtiff's decoder failed (data that ends early); the rows it did not fill stay zero, as libtiff
        # leaves its strip buffer to cv2's read (which goes on)
        if lib.tiff_fax(raw, n, comp, t4 & 1, hd["fill_order"] == 2, off & 1, cols, rows, out.ctypes.data,
                        -(-cols * per // 8), runs.ctypes.data, len(runs), err, len(err)) == 2:
            raise ValueError(f"TIFF {err.value.decode()} (strip or tile {k})")
        return out
    fn = lib.tiff_lzw if comp == 5 else lib.tiff_packbits
    if fn(raw, n, out.ctypes.data, occ, err, len(err)):
        raise ValueError(f"TIFF {err.value.decode()}")
    return out


def _jpeg_segment(hd, raw, rows, cols, per):
    tables = hd["tags"].get(347)
    if tables:
        tables = bytes(tables)  # UNDEFINED as the tag should be, or BYTE
        if tables[:2] != b"\xff\xd8" or raw[:2] != b"\xff\xd8":
            raise ValueError("TIFF JPEGTables or JPEG strip without an SOI marker")
        body = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
        raw = body + raw[2:]
    ycbcr = hd["photometric"] == 6 and not hd["separate"]
    img = jpeg.decode_tiff_jpeg(raw, ycbcr=ycbcr, components=per)
    if img.shape[0] < rows or img.shape[1] < cols:
        raise ValueError(f"TIFF JPEG strip or tile of {img.shape[1]}x{img.shape[0]}, smaller than {cols}x{rows}")
    return img[:rows, :cols, :3 if ycbcr else per]


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


def _ycbcr_blocks(buf: np.ndarray, rows: int, cols: int, sub, width: int) -> np.ndarray:
    """Packed YCbCr blocks (hs x vs luma samples row by row, then Cb, Cr) of
    a strip or tile ``cols`` wide, of which the image takes ``width`` →
    (rows, width, 3) Y, Cb, Cr a pixel, as libtiff's putcontig8bitYCbCr*tile
    routines take them. A tile cut by the image's right edge steps from one
    row of blocks to the next by the blocks read plus the skipped ones; the
    4x4 routine counts a skipped block as 10 samples, not 18."""
    hs, vs = sub
    size = hs * vs + 2
    bh, bv = -(-width // hs), -(-rows // vs)
    skipped = (cols - width) // hs * (10 if sub == (4, 4) else size)
    stride = bh * size + skipped
    full = np.zeros((bv - 1) * stride + bh * size, np.uint8)
    full[:min(len(buf), len(full))] = buf[:len(full)]
    at = (np.arange(bv) * stride)[:, None] + np.arange(bh * size)[None]
    blocks = full[at].reshape(bv, bh, size)
    y = blocks[..., :hs * vs].reshape(bv, bh, vs, hs).transpose(0, 2, 1, 3).reshape(bv * vs, bh * hs)
    chroma = np.repeat(np.repeat(blocks[..., hs * vs:], vs, axis=0), hs, axis=1)
    return np.concatenate([y[..., None], chroma], axis=2)[:rows, :width]


def _grey_edge_tile(s: np.ndarray, h: int, w: int) -> np.ndarray:
    """The first ``h`` rows and ``w`` pixels of a tile (``s``: (rows, cols,
    n) samples) as libtiff's grey and palette put routines read them from a
    tile cut by the image's right edge: they step from one row to the next
    by the skipped pixels' count in bytes, not in pixels' bytes, so row r
    starts ``r * (w * size + cols - w)`` bytes into the tile (size = a
    pixel's bytes, 16-bit samples in the host's order)."""
    rows, cols, n = s.shape
    size = n * s.itemsize
    buf = np.ascontiguousarray(s, s.dtype.newbyteorder("=")).view(np.uint8).reshape(-1)
    at = np.arange(h)[:, None] * (w * size + cols - w) + np.arange(w * size)[None, :]
    return buf[at].view(s.dtype.newbyteorder("=")).reshape(h, w, n)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → (H, W, 3) uint8 RGB as ``cv2.imread`` gives them."""
    from feartracker_tpu_torch.data.imread import load_library

    hd = tiff_header(data)
    W, H, spp, bits = hd["width"], hd["height"], hd["spp"], hd["bits"]
    th, tw = hd["tile"]
    order = hd["tags"]["order"]
    planes = spp if hd["separate"] else 1
    per = spp if planes == 1 else 1
    comp, sub = hd["compression"], hd["subsampling"]
    lib = load_library() if comp in (5, 32773) + FAX or hd["photometric"] == 8 else None
    dtype = np.uint16 if bits == 16 else np.uint8
    jpeg_px = comp == 7
    out = np.zeros((H, W, 3 if jpeg_px and hd["photometric"] == 6 and planes == 1 else spp), dtype)
    runs = np.zeros(4 * (-(-(tw + 1) // 32) * 32), np.uint32) if comp in FAX else None
    k = 0
    for p in range(planes):
        for y in range(0, H, th):
            for x in range(0, W, tw) if hd["tiled"] else (0,):
                rows = th if hd["tiled"] else min(th, H - y)
                cols = tw
                if sub:
                    occ, step = _ycbcr_sizes(hd, rows, cols)
                else:
                    occ = rows * (-(-cols * per * bits // 8))
                seg = _segment(lib, hd, data, k, occ, rows, cols, per, runs)
                k += 1
                if sub:
                    # libtiff's horAcc8 over its rows. Where a row does not divide the segment (PredictorDecodeTile's
                    # "occ0%rowsize != 0", e.g. 2x1 blocks in a 16x16 tile) or 3 does not divide a row (horAcc8's
                    # "cc%stride!=0"), libtiff fails the predictor, leaves the codec's output undifferenced and cv2
                    # reads on: so the predictor is skipped here (test_ycbcr_codecs_and_predictor's 2x1 tile)
                    if hd["predictor"] == 2 and occ % step == 0 and step % 3 == 0:
                        seg = np.cumsum(seg.reshape(-1, step // 3, 3), axis=1, dtype=np.uint8).reshape(-1)
                    s = _ycbcr_blocks(seg, rows, cols, sub, min(cols, W - x))
                else:
                    s = seg if jpeg_px else _samples(seg, rows, cols, per, bits, order)
                    if hd["predictor"] == 2:  # horizontal differences along each row, modulo the sample's range
                        s = np.cumsum(s, axis=1, dtype=s.dtype)
                h, w = min(rows, H - y), min(cols, W - x)
                if w < cols and hd["tiled"] and not jpeg_px and hd["photometric"] in (0, 1, 3) and per * bits > 8:
                    s = _grey_edge_tile(s, h, w)
                out[y:y + h, x:x + w, p:p + s.shape[2]] = s[:h, :w]
    return jpeg.apply_orientation(_to_rgb(hd, out, lib), hd["orientation"])


def _ycbcr_tables(hd: dict):
    """``TIFFYCbCrToRGBInit``'s tables, in its float and fixed-point steps:
    (Y, Cr→R, Cb→B, Cr→G, Cb→G) each indexed by the 8-bit sample."""
    f32 = np.float32
    luma = [f32(v) for v in hd["tags"].get(529, LUMA)[:3]]
    rbw = [f32(v) for v in hd["tags"].get(532, [0, 255, 128, 255, 128, 255])[:6]]

    def fix(v):  # FIX: (int32_t)(x * 65536 + 0.5), the product a float
        return int(float(f32(v) * f32(65536)) + 0.5)

    def clamp(v, lo, hi):
        return lo if not v >= lo else hi if v > hi else v

    f1 = f32(2) - f32(2) * luma[0]
    f2 = luma[0] * f1 / luma[1]
    f3 = f32(2) - f32(2) * luma[2]
    f4 = luma[2] * f3 / luma[1]
    d1, d2, d3, d4 = (fix(clamp(f1, f32(0), f32(2))), -fix(clamp(f2, f32(0), f32(2))),
                      fix(clamp(f3, f32(0), f32(2))), -fix(clamp(f4, f32(0), f32(2))))

    def code2v(c, rb, rw, cr):  # ((c - (int32_t)RB) * (float)CR) / (float)(RW - RB or 1)
        d = rw - rb
        return f32(f32(c - int(rb)) * f32(cr)) / (d if d != 0 else f32(1))

    def clampw(v):
        return int(clamp(v, f32(-128 * 32), f32(128 * 32)))

    half = 1 << 15
    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127))
        cb = clampw(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127))
        tabs[:, i] = (clampw(code2v(x + 128, rbw[0], rbw[1], 255)), (d1 * cr + half) >> 16, (d3 * cb + half) >> 16,
                      d2 * cr, d4 * cb + half)
    return tabs


def _to_rgb(hd: dict, s: np.ndarray, lib=None) -> np.ndarray:
    """``TIFFRGBAImage``'s put routines, alpha dropped as OpenCV drops it."""
    photo, bits, extra = hd["photometric"], hd["bits"], hd["extra"]
    if hd["compression"] == 7 and photo == 6 and not hd["separate"]:  # libjpeg converted it
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
    if photo == 5:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bittile
        cmyk = s[..., :4].astype(np.int32)
        k = 255 - cmyk[..., 3:]
        return (k * (255 - cmyk[..., :3]) // 255).astype(np.uint8)
    if photo == 8:
        lab = np.ascontiguousarray(s[..., :3].astype(np.uint16 if bits == 16 else np.uint8))
        white = hd["tags"].get(318)
        wp = None if white is None else (ctypes.c_float * 2)(*white[:2])
        out = np.empty(lab.shape[:2] + (3,), np.uint8)
        err = ctypes.create_string_buffer(128)
        if lib.tiff_cielab(lab.ctypes.data, lab.shape[0] * lab.shape[1], bits, wp, out.ctypes.data, err, len(err)):
            raise ValueError(f"TIFF {err.value.decode()}")
        return out
    if photo == 6:  # TIFFYCbCrtoRGB
        y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(hd)
        Y, Cb, Cr = s[..., 0], s[..., 1], s[..., 2]
        rgb = np.stack([y_tab[Y] + cr_r[Cr], y_tab[Y] + ((cb_g[Cb] + cr_g[Cr]) >> 16), y_tab[Y] + cb_b[Cb]], axis=2)
        return np.clip(rgb, 0, 255).astype(np.uint8)
    rgb = s[..., :3].astype(np.int32)
    alpha = s[..., 3].astype(np.int32) if s.shape[2] > 3 else None
    if bits == 16:
        rgb = (rgb + 128) // 257
        alpha = None if alpha is None else (alpha + 128) // 257
    if extra and extra[0] == 2 and alpha is not None:
        rgb = (rgb * alpha[..., None] + 127) // 255
    return rgb.astype(np.uint8)
