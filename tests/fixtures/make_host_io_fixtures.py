"""Write the fixtures of ``chip_smoke.py``'s phases 19-24 with cv2
(OpenCV 5.0), PIL and the encoders PIL bundles (``pillow.libs``), on a
host that has them:

* ``tests/fixtures/jpeg/*.jpg``: small cv2-made JPEGs (progressive,
  restart, 4:4:4, 4:2:2, 4:4:0, gray, odd sizes, EXIF orientation 6);
* ``tests/fixtures/jpeg/manifest.json``: the sha256 of cv2's decode of each
  (RGB bytes) and of cv2's encode of ``chip_smoke.fixture_frame`` at the
  ``ENCODE_CASES``;
* ``tests/fixtures/host_items.json``: the digests of the JAX dataset's
  normal-mode items with each host transform forced on
  (``chip_smoke.forced_item_digests``), cv2 reading and augmenting;
* ``tests/fixtures/images/``: small seeded PNG, BMP, PNM and JPEG files of
  the kinds ``data/imread.py`` reads beside cv2 (every PNG colour type,
  Adam7, ``tRNS``, ``eXIf``; BMP 1-32 bits, RLE4/RLE8, top-down, OS/2;
  P1-P6; CMYK, YCCK, sampling factors up to 4, progressive files with scans
  removed; a PNG named ``.JPEG``), a 1280x720 CMYK JPEG for phase 20a's
  timing, and ``manifest.json`` with the sha256 of ``cv2.imread``'s pixels
  (RGB bytes) of each; phase 21's TIFF, WebP, GIF and JPEG-mode files
  (``manifest_tiff_webp_gif.json``), phase 22's JPEG 2000, PAM, PFM,
  Sun raster and Radiance HDR files (``manifest_jp2_hdr_pam.json``) and
  phase 23's CCITT, FillOrder 2, CMYK, CIELab, YCbCr and signed-sample TIFF
  files (``manifest_tiff_fax_cmyk.json``) and phase 24's VP8 WebP of 2, 4
  and 8 token partitions (libwebp) and JPEG 2000 coding-mode files
  (OpenJPEG's encoder) (``manifest_webp_parts_jp2_modes.json``);
* ``tests/fixtures/jp2_got10k/``: phase 22b's GOT-10k val tree of JPEG 2000
  frames (PIL's OpenJPEG) and ``record.json`` (each file's sha256 and the
  port's OPE result over it on this host's CPU);
* ``tests/fixtures/tiff_ope_record.json``: phase 23b(ii)'s record, the
  sha256 of each frame of phase 19c's tree written as YCbCr 2x2 TIFF and the
  port's OPE result and boxes over them on this host's CPU;
* ``tests/fixtures/webp_parts_got10k/``: phase 24b's tree, phase 19c's val
  sequences written by libwebp with 4 token partitions, and ``record.json``
  (each file's sha256, the port's OPE result and boxes on this host's CPU).

    python tests/fixtures/make_host_io_fixtures.py

The writers below (``png``, ``bmp``, ``pnm``, ``jpeg_baseline``,
``keep_scans``) make files of every kind those fixtures hold; the oracle is
cv2's decode of them, not the writers. ``tests/test_torch_jpeg.py``,
``tests/test_torch_image_formats.py`` and ``tests/test_torch_host_augs.py``
hold the committed files to what cv2 and the port give.
"""

import ctypes
import functools
import io
import json
import os
import struct
import sys
import tempfile
import zlib

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# name: (kind, seed, h, w, quality, cv2 sampling, progressive, restart rows, gray, EXIF orientation)
DECODE_FILES = {
    "baseline_420.jpg": ("baseline 4:2:0", 11, 37, 53, 95, "420", 0, 0, False, 0),
    "progressive_420.jpg": ("progressive 4:2:0", 12, 48, 64, 75, "420", 1, 0, False, 0),
    "restart_420.jpg": ("restart 4:2:0", 13, 40, 72, 90, "420", 0, 2, False, 0),
    "baseline_444.jpg": ("4:4:4", 14, 33, 17, 95, "444", 0, 0, False, 0),
    "baseline_422.jpg": ("4:2:2", 15, 45, 61, 85, "422", 0, 0, False, 0),
    "baseline_440.jpg": ("4:4:0", 16, 30, 50, 80, "440", 0, 0, False, 0),
    "gray.jpg": ("gray", 17, 41, 29, 90, "420", 0, 0, True, 0),
    "gray_progressive.jpg": ("gray progressive", 18, 16, 24, 60, "420", 1, 0, True, 0),
    "one_pixel.jpg": ("1x1", 19, 1, 1, 95, "420", 0, 0, False, 0),
    "exif6.jpg": ("EXIF 6", 20, 21, 13, 90, "420", 0, 0, False, 6),
    "progressive_restart_444.jpg": ("progressive restart 4:4:4", 21, 24, 40, 100, "444", 1, 1, False, 0),
}
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def exif_segment(orientation: int) -> bytes:
    """An APP1 Exif segment holding only the orientation tag (little endian)."""
    tiff = b"II" + struct.pack("<HIH", 42, 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack("<I", 0)
    app1 = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1


def cv2_file(seed, h, w, q, sampling, progressive, restart, gray, orientation) -> bytes:
    img = chip_smoke.fixture_frame(seed, h, w, gray)
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if not gray:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    data = cv2.imencode(".jpg", img, params)[1].tobytes()
    return data[:2] + exif_segment(orientation) + data[2:] if orientation else data


# -- writers of every kind of file phase 20 and the format tests read ----------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(kind: bytes, data: bytes, bad_crc: bool = False) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc ^ int(bad_crc))


def _pack_rows(samples, depth):
    """(h, n) integer samples → (h, bytes) rows at ``depth`` bits a sample."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, -n % per), samples.dtype)], 1).reshape(h, -1, per).astype(np.uint16)
    return (s << (8 - depth * np.arange(1, per + 1, dtype=np.uint16))).sum(-1).astype(np.uint8)


def _png_filter(raw, bpp, filters):
    """Each row prefixed by its filter type (``filters`` in turn) and
    filtered against the raw bytes."""
    h, n = raw.shape
    out = np.zeros((h, n + 1), np.uint8)
    prev = np.zeros(n, np.int32)
    for y in range(h):
        r = raw[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), r])[:n]
        c = np.concatenate([np.zeros(bpp, np.int32), prev])[:n]
        f = filters[y % len(filters)]
        pred = {1: a, 2: prev, 3: (a + prev) // 2}.get(f, 0)  # 5+: an invalid type, unfiltered
        if f == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out[y, 0] = f
        out[y, 1:] = (r - pred) & 255
        prev = r
    return out


def png(samples, color_type, depth, interlace=False, palette=None, trns=None, exif=None, filters=(0, 1, 2, 3, 4),
        extra=(), bad_crc=None, idat_split=1):
    """A PNG of ``samples`` ((H, W) or (H, W, C) integers below 2**depth,
    palette indices for colour type 3), every filter type in turn, with the
    optional PLTE, tRNS, eXIf and ``extra`` (type, payload) chunks; the
    chunk named by ``bad_crc`` gets a wrong CRC."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    H, W, C = samples.shape
    bpp = max(1, C * depth // 8)

    def rows(img):
        h, w, c = img.shape
        if h == 0 or w == 0:
            return b""
        return _png_filter(_pack_rows(img.reshape(h, w * c), depth), bpp, filters).tobytes()

    data = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7) if interlace else rows(samples)
    z = zlib.compress(data)
    out = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, int(interlace)),
                                    bad_crc == b"IHDR")
    chunks = list(extra)
    if exif is not None:
        chunks.append((b"eXIf", exif))
    if palette is not None:
        chunks.append((b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        chunks.append((b"tRNS", trns))
    chunks += [(b"IDAT", z[i * len(z) // idat_split:(i + 1) * len(z) // idat_split]) for i in range(idat_split)]
    for kind, payload in chunks + [(b"IEND", b"")]:
        out += png_chunk(kind, payload, bad_crc == kind)
    return out


def tiff_orientation(orientation, little_endian=True):
    """An EXIF TIFF block holding only the orientation tag."""
    e = "<" if little_endian else ">"
    return ((b"II" if little_endian else b"MM") + struct.pack(e + "HIH", 42, 8, 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def bmp(img=None, bpp=24, top_down=False, palette=None, indices=None, comp=0, masks=None, header=40, rle=None,
        gap=0):
    """A BMP: ``img`` (H, W, 3) RGB at 15 (5-5-5), 16 (5-6-5), 24 or 32 bits
    (the fourth byte a ramp), or ``indices`` (H, W) into ``palette`` (n, 3)
    RGB at 1, 4 or 8 bits; ``rle`` an RLE4/RLE8 stream written as is (with
    ``comp`` 2/1); ``masks`` written after the header, where OpenCV reads
    them; a 12-byte header is OS/2's; ``gap`` bytes between the palette and
    the pixels."""
    H, W = (indices if indices is not None else img).shape[:2]
    if rle is not None:
        pix = rle
    else:
        pitch = ((W * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if bpp <= 8:
            rows = _pack_rows(np.asarray(indices), bpp)
        elif bpp in (15, 16):
            r, g, b = (img.astype(np.uint16) >> 3).transpose(2, 0, 1)
            if bpp == 16:
                g = img[..., 1].astype(np.uint16) >> 2
            t = (r << (11 if bpp == 16 else 10)) | (g << 5) | b
            rows = t.astype("<u2").view(np.uint8).reshape(H, 2 * W)
        else:
            bgr = img[..., ::-1].astype(np.uint8)
            if bpp == 32:
                ramp = np.broadcast_to((np.arange(W) * 37 % 256).astype(np.uint8)[None, :, None], (H, W, 1))
                bgr = np.concatenate([bgr, ramp], -1)
            rows = bgr.reshape(H, -1)
        rows = np.pad(rows, ((0, 0), (0, pitch - rows.shape[1])))
        pix = (rows if top_down else rows[::-1]).tobytes()
    bits = 16 if bpp == 15 else bpp
    entries = [] if palette is None else [bytes(int(v) for v in c[::-1]) for c in palette]
    if header == 12:
        info, pal = struct.pack("<IHHHH", 12, W, H, 1, bits), b"".join(entries)
    else:
        info = struct.pack("<IiiHHIIiiII", header, W, -H if top_down else H, 1, bits, comp, len(pix), 2835, 2835,
                           len(entries), 0) + b"\0" * (header - 40)
        pal = (struct.pack("<III", *masks) if masks else b"") + b"".join(e + b"\0" for e in entries)
    body = info + pal + b"\0" * gap + pix
    return b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, 14 + len(info) + len(pal) + gap) + body


def rle8_encode(indices, literals=True):
    """An RLE8 stream of bottom-up rows: runs of 3 or more, literals of the
    rest (when ``literals``), an end of line per row, an end of bitmap."""
    out = bytearray()
    H, W = indices.shape
    for y in range(H - 1, -1, -1):
        row, x = indices[y], 0
        while x < W:
            run = 1
            while x + run < W and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 3 or W - x < 3 or not literals:
                out += bytes([run, int(row[x])])
                x += run
            else:
                n = min(W - x, 255)
                out += bytes([0, n]) + bytes(row[x:x + n].astype(np.uint8)) + b"\0" * (n % 2)
                x += n
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def pnm(kind, samples, maxval, comment=False):
    """A P1-P6 file of ``samples`` ((H, W) or (H, W, 3) integers)."""
    samples = np.asarray(samples)
    H, W = samples.shape[:2]
    head = b"P%d\n" % kind + (b"# seeded\n" if comment else b"") + b"%d %d\n" % (W, H)
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    if kind in (1, 2, 3):
        body = b"\n".join(b" ".join(b"%d" % v for v in row.reshape(-1)) for row in samples) + b"\n"
    elif kind == 4:
        body = np.packbits(samples.astype(np.uint8), axis=1).tobytes()
    else:
        body = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + body


ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
                   6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                   38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
STD_LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                       14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
                       92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4"
    "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_DCT = np.sqrt(np.where(np.arange(8) == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
    (2 * np.arange(8)[None, :] + 1) * np.arange(8)[:, None] * np.pi / 16)  # (u, x)


def _huffman_codes(bits, vals):
    code, k, out = 0, 0, {}
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _dct_coefs(planes, sampling, precision=8):
    """The size, MCU counts and quantized coefficients (blocks of 8x8,
    natural order) of ``planes`` at ``sampling``, the standard luma table for
    every component; a float DCT."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    H, W = next(p.shape for p, s in zip(planes, sampling) if s == (hmax, vmax))
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    coefs = []
    for p, (h, v) in zip(planes, sampling):
        pad = np.pad(p.astype(np.float64), ((0, mcuy * v * 8 - p.shape[0]), (0, mcux * h * 8 - p.shape[1])),
                     mode="edge") - (1 << (precision - 1))
        blocks = pad.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3)
        coefs.append(np.round(np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT) / STD_LUMA_Q.reshape(8, 8)).astype(int))
    return H, W, mcux, mcuy, coefs


def jpeg_baseline(planes, sampling, adobe=None, jfif=False):
    """A baseline JPEG of ``planes`` (one uint8 plane a component, each at
    its own sampling) with sampling factors ``sampling`` [(h, v), ...]: one
    interleaved scan, the standard luma quantization and Huffman tables for
    every component, an optional JFIF APP0 and Adobe APP14 (``adobe`` = its
    transform). A float DCT: the oracle is cv2's decode, not this writer."""
    H, W, mcux, mcuy, coefs = _dct_coefs(planes, sampling)
    dc, ac = _huffman_codes(DC_BITS, range(12)), _huffman_codes(AC_BITS, AC_VALS)
    bits, preds = [], [0] * len(planes)

    def put(code, n):
        bits.extend((code >> i) & 1 for i in range(n - 1, -1, -1))

    def magnitude(v):
        n = abs(v).bit_length()
        return n, (v if v >= 0 else v - 1 + (1 << n))

    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (h, v) in enumerate(sampling):
                for yy in range(v):
                    for xx in range(h):
                        zz = coefs[ci][my * v + yy, mx * h + xx].reshape(64)[ZIGZAG]
                        n, val = magnitude(int(zz[0]) - preds[ci])
                        preds[ci] = int(zz[0])
                        put(*dc[n])
                        put(val, n)
                        run = 0
                        for k in range(1, 64):
                            if zz[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            n, val = magnitude(int(zz[k]))
                            put(*ac[(run << 4) | n])
                            put(val, n)
                            run = 0
                        if run:
                            put(*ac[0])
    bits.extend([1] * (-len(bits) % 8))
    entropy = np.packbits(np.array(bits, np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    if jfif:
        out += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        out += seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += seg(0xDB, b"\0" + bytes(STD_LUMA_Q[ZIGZAG].astype(np.uint8)))
    out += seg(0xC0, struct.pack(">BHHB", 8, H, W, len(planes))
               + b"".join(bytes([i + 1, (h << 4) | v, 0]) for i, (h, v) in enumerate(sampling)))
    out += seg(0xC4, b"\x00" + bytes(DC_BITS) + bytes(range(12))) + seg(0xC4, b"\x10" + bytes(AC_BITS) + AC_VALS)
    out += seg(0xDA, bytes([len(planes)]) + b"".join(bytes([i + 1, 0]) for i in range(len(planes))) + b"\x00\x3f\x00")
    return out + entropy + b"\xff\xd9"


def sub_planes(img, sampling):
    """(H, W, C) uint8 → one plane a channel at ``sampling`` (box means)."""
    H, W, _ = img.shape
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    out = []
    for c, (h, v) in enumerate(sampling):
        rh, rv, dh, dw = hmax // h, vmax // v, -(-H * v // vmax), -(-W * h // hmax)
        p = np.pad(img[..., c].astype(np.float64), ((0, dh * rv - H), (0, dw * rh - W)), mode="edge")
        out.append(np.round(p.reshape(dh, rv, dw, rh).mean((1, 3))).astype(np.uint8))
    return out


def keep_scans(data, keep):
    """The JPEG with only the scans for which ``keep(i, Ah)`` holds (i the
    scan's index, Ah its successive-approximation high bit)."""
    out, pos, i = [b"\xff\xd8"], 2, 0
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append(data[pos:pos + 2])
            break
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            ah = data[end - 1] >> 4
            while not (data[end] == 0xFF and data[end + 1] != 0 and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1  # the entropy-coded data runs to the next marker
            if keep(i, ah):
                out.append(data[pos:end])
            i += 1
        else:
            out.append(data[pos:end])
        pos = end
    return b"".join(out)


# -- TIFF ---------------------------------------------------------------------------

REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (257 - n, byte), the rest as
    literals of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        r = 1
        while i + r < n and r < 128 and data[i + r] == data[i]:
            r += 1
        if r >= 2:
            out += bytes([257 - r, data[i]])
            i += r
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF's LZW as libtiff writes it: MSB first, Clear 256, EOI 257, the
    width growing when the next code needs it, a Clear at code 4094."""
    bits, nbits, width = 0, 0, 9
    out = bytearray()

    def emit(code):
        nonlocal bits, nbits
        bits = bits << width | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append(bits >> nbits & 255)
        bits &= (1 << nbits) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    emit(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:  # full: libtiff's encoder clears here
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt == 1 << width:
            width += 1
        w = bytes([c])
    if w:
        emit(table[w])
        nxt += 1
        if nxt == 4094:
            emit(256)
            width = 9
        elif nxt == 1 << width:
            width += 1
    emit(257)
    if nbits:
        out.append(bits << (8 - nbits) & 255)
    return bytes(out)


def _ycbcr_block_bytes(b, sub):
    """(h, w, 3) Y, Cb, Cr samples → TIFF's packed YCbCr blocks: each
    hs x vs block's luma row by row, then one Cb and one Cr (the block's
    first pixel's), the blocks of a row left to right."""
    hs, vs = sub
    h, w, _ = b.shape
    bh, bv = -(-w // hs), -(-h // vs)
    p = np.zeros((bv * vs, bh * hs, 3), np.uint8)
    p[:h, :w] = b
    p[h:, :w] = p[h - 1:h, :w]  # edge blocks: the last row and column repeated
    p[:, w:] = p[:, w - 1:w]
    y = p[..., 0].reshape(bv, vs, bh, hs).transpose(0, 2, 1, 3).reshape(bv, bh, hs * vs)
    return np.concatenate([y, p[::vs, ::hs, 1:]], axis=2).reshape(-1)


def _tiff_segments(samples, bits, planar, rows, tile, predictor, end, ycbcr=None):
    """The raw bytes of each strip (``rows`` a strip) or tile (``tile`` =
    (height, width)), plane-major where ``planar`` is 2, with predictor 2's
    horizontal differences taken; ``ycbcr`` = (hs, vs) packs Y, Cb, Cr
    samples into subsampled blocks, differenced (predictor 2) over
    libtiff's rows of them (a scanline: a row of blocks over vs; a tile's
    width times 3), 3 samples apart."""
    H, W, C = samples.shape
    planes = [samples[..., c:c + 1] for c in range(C)] if planar == 2 else [samples]
    segs = []
    for p in planes:
        if tile:
            th, tw = tile
            pad = np.zeros((-(-H // th) * th, -(-W // tw) * tw, p.shape[2]), p.dtype)
            pad[:H, :W] = p
            blocks = [pad[y:y + th, x:x + tw] for y in range(0, H, th) for x in range(0, W, tw)]
        else:
            blocks = [p[y:y + rows] for y in range(0, H, rows)]
        for b in blocks:
            h, w, c = b.shape
            if ycbcr:
                v = _ycbcr_block_bytes(b, ycbcr).astype(np.int64)
                step = tile[1] * 3 if tile else -(-w // ycbcr[0]) * (ycbcr[0] * ycbcr[1] + 2) // ycbcr[1]
                if predictor == 2 and len(v) % step == 0 and step % 3 == 0:
                    r = v.reshape(-1, step // 3, 3)
                    d = r.copy()
                    d[:, 1:] = r[:, 1:] - r[:, :-1]
                    v = (d & 255).reshape(-1)
                segs.append(v.astype(np.uint8).tobytes())
                continue
            v = b.reshape(h, w * c).astype(np.int64)
            if predictor == 2:
                d = v.copy()
                d[:, c:] = v[:, c:] - v[:, :-c]
                v = d & (2 ** bits - 1)
            if bits == 16:
                segs.append(v.astype(end + "u2").tobytes())
            else:
                segs.append(_pack_rows(v, bits).tobytes())
    return segs


def tiff(samples, bits=8, photometric=2, compression=1, predictor=1, planar=1, rows=None, tile=None, extra=None,
         colormap=None, orientation=None, bigtiff=False, big_endian=False, tags=(), segments=None, jpeg_tables=None,
         ycbcr=None, fill_order=None):
    """A TIFF of ``samples`` ((H, W) or (H, W, C) integers below 2**bits),
    one IFD: strips of ``rows`` rows or tiles of ``tile`` = (h, w), planar
    configuration 1 or 2, compression 1 (none), 5 (LZW), 8 / 32946
    (Deflate) or 32773 (PackBits), predictor 1 or 2, ExtraSamples ``extra``,
    a palette ``colormap`` ((2**bits, 3) 16-bit values), the Orientation
    tag, classic or BigTIFF, either byte order; ``tags`` adds (tag, type,
    values) entries (RATIONAL and SRATIONAL values as (numerator,
    denominator) pairs or floats). ``segments`` (compressed strips or tiles)
    and ``jpeg_tables`` replace the samples' own, as for JPEG (compression
    7) and CCITT. ``ycbcr`` = (hs, vs): 8-bit Y, Cb, Cr samples packed in
    subsampled blocks, with the YCbCrSubsampling tag. ``fill_order`` 2:
    each segment's bits reversed, with the FillOrder tag."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    H, W, C = samples.shape
    end = ">" if big_endian else "<"
    rows = rows or H
    if segments is None:
        raw = _tiff_segments(samples, bits, planar, rows, tile, predictor, end, ycbcr)
        enc = {1: lambda b: b, 5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits}[compression]
        segments = [enc(s) for s in raw]
    if fill_order is not None:
        if fill_order == 2:
            segments = [s.translate(REVERSED_BITS) for s in segments]
        tags = list(tags) + [(266, 3, [fill_order])]
    if ycbcr is not None:
        tags = list(tags) + [(530, 3, list(ycbcr))]
    off_type = 16 if bigtiff else 4
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bits] * C), (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [C]), (284, 3, [planar])]
    if tile:
        entries += [(322, 4, [tile[1]]), (323, 4, [tile[0]]), (324, off_type, None), (325, 4, [len(s) for s in segments])]
    else:
        entries += [(273, off_type, None), (278, 4, [rows]), (279, 4, [len(s) for s in segments])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra is not None:
        entries.append((338, 3, list(extra)))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap).T.reshape(-1))))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if jpeg_tables is not None:
        entries.append((347, 7, jpeg_tables))
    entries += list(tags)
    head = 16 if bigtiff else 8
    data = bytearray()
    offsets = []
    for s in segments:
        offsets.append(head + len(data))
        data += s + b"\0" * (len(s) & 1)
    ifd_at = head + len(data)
    entries = sorted((t, ty, offsets if v is None else v) for t, ty, v in entries)
    size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 10: 8, 16: 8}
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 7: "B", 10: "ii", 16: "Q"}

    def pack(ty, x):
        if ty in (5, 10):
            num, den = x if isinstance(x, tuple) else (round(x * 1_000_000), 1_000_000)
            return struct.pack(end + fmt[ty], num, den)
        return struct.pack(end + fmt[ty], x)

    inline = 8 if bigtiff else 4
    n = len(entries)
    after = ifd_at + (8 + 20 * n + 8 if bigtiff else 2 + 12 * n + 4)
    ifd, extra_data = bytearray(), bytearray()
    ifd += struct.pack(end + ("Q" if bigtiff else "H"), n)
    for t, ty, v in entries:
        payload = bytes(v) if ty in (2, 7) and isinstance(v, (bytes, bytearray)) else b"".join(
            pack(ty, x) for x in v)
        count = len(payload) // size[ty]
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\0")
        else:
            field = struct.pack(end + ("Q" if bigtiff else "I"), after + len(extra_data))
            extra_data += payload + b"\0" * (len(payload) & 1)
        ifd += struct.pack(end + ("HHQ" if bigtiff else "HHI"), t, ty, count) + field
    ifd += b"\0" * (8 if bigtiff else 4)
    order = b"MM" if big_endian else b"II"
    header = order + (struct.pack(end + "HHHQ", 43, 8, 0, ifd_at) if bigtiff else struct.pack(end + "HI", 42, ifd_at))
    return bytes(header + data + ifd + extra_data)


def jpeg_segments(data: bytes):
    """A JPEG split at its first SOF or SOS-preceding table run: (tables,
    image) where tables = SOI + every DQT/DHT + EOI (TIFF's JPEGTables) and
    image = SOI + the rest without those tables (an abbreviated stream)."""
    pos, tables, rest = 2, [], []
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            rest.append(data[pos:])
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos:pos + 2 + length]
        (tables if marker in (0xDB, 0xC4) else rest).append(seg)
        pos += 2 + length
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", b"\xff\xd8" + b"".join(rest)


# -- GIF ----------------------------------------------------------------------------

def gif_lzw(indices, min_size: int) -> bytes:
    """GIF's LZW as giflib writes it: LSB first, a Clear first and before
    the table fills, the width growing after the code that fills it; in
    sub-blocks of up to 255 bytes after the minimum code size byte."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width, nxt = min_size + 1, eoi + 1
    bits, nbits, out = 0, 0, bytearray()

    def emit(code):
        nonlocal bits, nbits, width
        bits |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(bits & 255)
            bits >>= 8
            nbits -= 8
        if nxt >= 1 << width and width < 12:
            width += 1

    data = bytes(np.asarray(indices, np.uint8).reshape(-1))
    table = {bytes([i]): i for i in range(clear)}
    emit(clear)
    w = data[:1]
    for c in data[1:]:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if nxt >= 4094:
            emit(clear)
            table = {bytes([i]): i for i in range(clear)}
            width, nxt = min_size + 1, eoi + 1
        else:
            table[wc] = nxt
            nxt += 1
        w = bytes([c])
    if w:
        emit(table[w])
    emit(eoi)
    if nbits:
        out.append(bits & 255)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255]) for i in range(0, len(out), 255))
    return bytes([min_size]) + blocks + b"\0"


def gif(frames, screen, palette=None, background=0, version=b"GIF89a"):
    """A GIF of ``screen`` = (W, H) with a global ``palette`` ((n, 3), n a
    power of two) or none and ``frames``: dicts of ``indices`` (h, w),
    optional ``left``, ``top``, local ``palette``, ``interlace``,
    ``transparent`` index, ``disposal`` and LZW ``min_size``."""
    W, H = screen
    out = bytearray(version + struct.pack("<HH", W, H))
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        size = int(np.log2(len(pal))) - 1
        out += bytes([0x80 | 0x70 | size, background, 0]) + pal.tobytes()
    else:
        out += bytes([0x70, background, 0])
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        h, w = idx.shape
        if f.get("transparent") is not None or f.get("disposal"):
            t = f.get("transparent")
            out += bytes([0x21, 0xF9, 4, (f.get("disposal", 0) << 2) | (t is not None), 10, 0, t or 0, 0])
        flags = 0x40 if f.get("interlace") else 0
        local = f.get("palette")
        if local is not None:
            local = np.asarray(local, np.uint8)
            flags |= 0x80 | (int(np.log2(len(local))) - 1)
        out += b"\x2c" + struct.pack("<HHHH", f.get("left", 0), f.get("top", 0), w, h) + bytes([flags])
        if local is not None:
            out += local.tobytes()
        if f.get("interlace"):
            idx = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        min_size = f.get("min_size", max(2, int(np.ceil(np.log2(max(2, int(idx.max()) + 1))))))
        out += gif_lzw(idx, min_size)
    return bytes(out + b"\x3b")


# -- WebP ---------------------------------------------------------------------------

def webp_chunk(kind: bytes, payload: bytes) -> bytes:
    return kind + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def webp_riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_bitstream(data: bytes):
    """The (fourcc, payload) of a simple WebP file's VP8 or VP8L chunk."""
    pos = 12
    while pos + 8 <= len(data):
        kind, (size,) = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])
        if kind in (b"VP8 ", b"VP8L"):
            return kind, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    raise ValueError("no bitstream")


def webp_extended(size, chunks, flags=0) -> bytes:
    """A VP8X file of canvas ``size`` = (W, H) holding ``chunks``."""
    w, h = size
    vp8x = bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    return webp_riff([webp_chunk(b"VP8X", vp8x)] + list(chunks))


def webp_animation(size, frames, background=(0, 0, 0, 0)) -> bytes:
    """An animated WebP: ``frames`` of (x, y, w, h, bitstream chunk, flags)
    with even offsets."""
    anim = webp_chunk(b"ANIM", bytes(background) + struct.pack("<H", 0))
    anmf = [webp_chunk(b"ANMF", (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                       + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little") + (100).to_bytes(3, "little")
                       + bytes([flags]) + chunk) for x, y, w, h, chunk, flags in frames]
    return webp_extended(size, [anim] + anmf, flags=0x02 | 0x10)


def _c_table(name: str):
    """One of ``csrc/webp.cpp``'s RFC 6386 tables, as a list of ints."""
    import re

    src = open(os.path.join(REPO, "feartracker_tpu_torch", "csrc", "webp.cpp")).read()
    body = re.search(name + r"\[[^\]]*\] = \{([^}]*)\}", src).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


class _BoolDecoder:
    """RFC 6386's boolean decoder, recording each decision as (prob, bit)."""

    def __init__(self, data: bytes):
        self.d, self.pos, self.value, self.range, self.count = data, 2, (data[0] << 8) | data[1], 255, 0
        self.decisions = []

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            b, self.range, self.value = 1, self.range - split, self.value - big
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.d[self.pos] if self.pos < len(self.d) else 0
                self.pos += 1
        self.decisions.append((prob, b))
        return b

    def value_bits(self, n: int) -> int:
        return sum(self.bit(128) << i for i in range(n - 1, -1, -1))


def _bool_encode(decisions) -> bytes:
    """RFC 6386's boolean encoder over (prob, bit) decisions, flushed."""
    out, rng, bottom, count = bytearray(), 255, 0, 24

    def carry():
        i = len(out) - 1
        while i >= 0 and out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, b in decisions:
        split = 1 + (((rng - 1) * prob) >> 8)
        if b:
            bottom, rng = bottom + split, rng - split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if count == 0:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    if bottom & (1 << (32 - count)):
        carry()
    v = (bottom << (count & 7)) & 0xFFFFFFFF
    for _ in range(count >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _bits(n: int, v: int):
    return [(128, (v >> i) & 1) for i in range(n - 1, -1, -1)]


def _signed(n: int, v: int):
    return _bits(n, abs(v)) + [(128, int(v < 0))]


def vp8_reheader(frame: bytes, simple=None, level=None, sharpness=None, lf_deltas=None, segment_deltas=None) -> bytes:
    """A VP8 key frame with its loop-filter header (``simple``, ``level``,
    ``sharpness``, ``lf_deltas`` = (ref_lf_delta[0..3], mode_lf_delta[0..3])
    or None) or its segment data (``segment_deltas`` = (absolute, 4
    quantizers, 4 filter strengths)) replaced: partition 0 decoded decision
    by decision, those fields' decisions swapped, every other decision
    re-encoded as it was; the token partitions untouched. The paths
    libwebp's encoder never writes, for the decoder's tests."""
    bits = frame[0] | frame[1] << 8 | frame[2] << 16
    size0 = bits >> 5
    head, p0, rest = frame[:10], frame[10:10 + size0], frame[10 + size0:]
    br = _BoolDecoder(p0)
    br.value_bits(2)  # colour space, clamping
    seg_at = len(br.decisions)
    use_segment, update_map = br.value_bits(1), 0
    seg_fields = None
    if use_segment:
        update_map = br.value_bits(1)
        if br.value_bits(1):
            absolute = br.value_bits(1)
            q = [(br.value_bits(7) * (-1 if br.value_bits(1) else 1)) if br.value_bits(1) else 0 for _ in range(4)]
            f = [(br.value_bits(6) * (-1 if br.value_bits(1) else 1)) if br.value_bits(1) else 0 for _ in range(4)]
            seg_fields = (absolute, q, f)
        seg_data_end = len(br.decisions)
        seg_probs = [br.value_bits(8) if br.value_bits(1) else 255 for _ in range(3)] if update_map else [255] * 3
    else:
        seg_data_end, seg_probs = len(br.decisions), [255] * 3
    filt_at = len(br.decisions)
    old = [br.value_bits(1), br.value_bits(6), br.value_bits(3)]
    use_delta = br.value_bits(1)
    if use_delta and br.value_bits(1):
        for _ in range(8):
            if br.value_bits(1):
                br.value_bits(7)
    filt_end = len(br.decisions)
    br.value_bits(2)  # partitions
    br.value_bits(7)
    for _ in range(5):
        if br.value_bits(1):
            br.value_bits(5)
    br.value_bits(1)  # refresh entropy probabilities
    update = _c_table("kCoeffsUpdateProba")
    for p in update:
        if br.bit(p):
            br.value_bits(8)
    use_skip = br.value_bits(1)
    skip_p = br.value_bits(8) if use_skip else 0
    bmodes = _c_table("kBModesProba")
    w, h = (head[6] | head[7] << 8) & 0x3FFF, (head[8] | head[9] << 8) & 0x3FFF
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    intra_t = [0] * (4 * mbw)
    for _ in range(mbh):
        intra_l = [0] * 4
        for mx in range(mbw):
            if update_map:
                if not br.bit(seg_probs[0]):
                    br.bit(seg_probs[1])
                else:
                    br.bit(seg_probs[2])
            if use_skip:
                br.bit(skip_p)
            top = intra_t[4 * mx:4 * mx + 4]
            if br.bit(145):  # 16x16
                ymode = (1 if br.bit(128) else 3) if br.bit(156) else (2 if br.bit(163) else 0)
                top, intra_l = [ymode] * 4, [ymode] * 4
            else:
                for y in range(4):
                    ymode = intra_l[y]
                    for x in range(4):
                        p = bmodes[(top[x] * 10 + ymode) * 9:(top[x] * 10 + ymode) * 9 + 9]
                        if not br.bit(p[0]):
                            ymode = 0
                        elif not br.bit(p[1]):
                            ymode = 1
                        elif not br.bit(p[2]):
                            ymode = 2
                        elif not br.bit(p[3]):
                            ymode = 3 if not br.bit(p[4]) else (4 if not br.bit(p[5]) else 5)
                        else:
                            ymode = 6 if not br.bit(p[6]) else (7 if not br.bit(p[7]) else (8 if not br.bit(p[8]) else 9))
                        top[x] = ymode
                    intra_l[y] = ymode
            intra_t[4 * mx:4 * mx + 4] = top
            if br.bit(142) and br.bit(114):
                br.bit(183)
    dec = br.decisions
    filt = (_bits(1, old[0] if simple is None else simple) + _bits(6, old[1] if level is None else level)
            + _bits(3, old[2] if sharpness is None else sharpness))
    if lf_deltas is None:
        filt += dec[filt_at + 10:filt_end]
    else:
        filt += _bits(1, 1) + _bits(1, 1)
        for v in list(lf_deltas[0]) + list(lf_deltas[1]):
            filt += _bits(1, 1) + _signed(6, v)
    seg = dec[seg_at:seg_data_end]
    if segment_deltas is not None:
        assert use_segment, "a frame without segments"
        absolute, q, f = segment_deltas
        seg = _bits(1, 1) + _bits(1, update_map) + _bits(1, 1) + _bits(1, absolute)
        seg += [d for v in q for d in _bits(1, 1) + _signed(7, v)] + [d for v in f for d in _bits(1, 1) + _signed(6, v)]
    new = dec[:seg_at] + seg + dec[seg_data_end:filt_at] + filt + dec[filt_end:]
    p0 = _bool_encode(new)
    tag = (bits & 0x1F) | (len(p0) << 5)
    return bytes([tag & 255, tag >> 8 & 255, tag >> 16]) + head[3:] + p0 + rest


# -- JPEG modes beyond baseline and progressive Huffman -------------------------------

def _jseg(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _stuff(bits):
    bits = list(bits) + [1] * (-len(bits) % 8)
    return np.packbits(np.array(bits, np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")


def jpeg_lossless(planes, predictor=1, pt=0, precision=8, restart=0, jfif=False, ids=None):
    """A lossless JPEG (SOF3, T.81 Annex H) of ``planes`` (one (H, W)
    integer plane a component, all the same size): one interleaved scan with
    selection value ``predictor`` (1-7) and point transform ``pt``, a DC-style
    Huffman table of 17 categories at 5 bits each, restart markers every
    ``restart`` rows' worth of samples."""
    planes = [np.asarray(p, np.int64) >> pt for p in planes]
    H, W = planes[0].shape
    n = len(planes)
    lengths = [0] * 16
    lengths[4] = 17  # 5-bit codes for SSSS 0-16
    codes = _huffman_codes(lengths, range(17))
    bits, chunks = [], []
    mcus = W * restart if restart else 0
    count = 0
    for y in range(H):
        for x in range(W):
            if restart and count and count % mcus == 0:
                chunks.append(_stuff(bits) + bytes([0xFF, 0xD0 + (count // mcus - 1) % 8]))
                bits = []
            first_row = restart and (count // mcus) * mcus // W == y if restart else y == 0
            for c in range(n):
                p = planes[c]
                if first_row and x == 0:
                    pred = 1 << (precision - pt - 1)
                elif first_row:
                    pred = p[y, x - 1]
                elif x == 0:
                    pred = p[y - 1, x]
                else:
                    ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                            7: (ra + rb) >> 1}[predictor]
                diff = int(p[y, x] - pred) & 0xFFFF
                if diff >= 0x8000:
                    diff -= 0x10000
                s = 16 if diff == -0x8000 else abs(diff).bit_length()
                code, length = codes[s]
                bits.extend((code >> i) & 1 for i in range(length - 1, -1, -1))
                if 0 < s < 16:
                    v = diff if diff >= 0 else diff - 1 + (1 << s)
                    bits.extend((v >> i) & 1 for i in range(s - 1, -1, -1))
            count += 1
    chunks.append(_stuff(bits))
    out = b"\xff\xd8" + (_jseg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0") if jfif else b"")
    ids = ids or list(range(1, n + 1))
    out += _jseg(0xC3, struct.pack(">BHHB", precision, H, W, n) + b"".join(bytes([i, 0x11, 0]) for i in ids))
    out += _jseg(0xC4, b"\x00" + bytes(lengths) + bytes(range(17)))
    if restart:
        out += _jseg(0xDD, struct.pack(">H", mcus))
    out += _jseg(0xDA, bytes([n]) + b"".join(bytes([i, 0]) for i in ids) + bytes([predictor, 0, pt]))
    return out + b"".join(chunks) + b"\xff\xd9"


# T.81 Table D.2 as libjpeg packs it: (Qe << 16) | (Next_Index_MPS << 8) | (Switch_MPS << 7) | Next_Index_LPS
ARITAB = (0x5a1d0181, 0x2586020e, 0x11140310, 0x80b0412, 0x3d80514, 0x1da0617, 0xe50719, 0x6f081c, 0x36091e, 0x1a0a21,
          0xd0b23, 0x60c09, 0x30d0a, 0x10d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a,
          0xcef152b, 0x9a1162d, 0x72f172e, 0x55c1830, 0x4061931, 0x3031a33, 0x2401b34, 0x1b11c36, 0x1441d38, 0xf51e39,
          0xb71f3b, 0x8a203c, 0x68213e, 0x4e223f, 0x3b2320, 0x2c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843,
          0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48, 0x11772d49, 0xe742e4a, 0xbfb2f4b, 0x9f8304d, 0x861314e,
          0x706324f, 0x5cd3330, 0x4de3432, 0x40f3532, 0x3633633, 0x2d43734, 0x25c3835, 0x1f83936, 0x1a43a37,
          0x1603b38, 0x1253c39, 0xf63d3a, 0xcb3e3b, 0xab3f3d, 0x8f203d, 0x5b1241c1, 0x4d044250, 0x412c4351,
          0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a,
          0xf6b4d4a, 0xd514e4b, 0xbb64f4d, 0xa40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a, 0x34ee555b,
          0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63,
          0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a,
          0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
          0x59eb6ff0, 0x5a1d7171)


class QMEncoder:
    """T.81 Annex D's arithmetic encoder, as libjpeg's jcarith.c codes it
    (carry propagation through stacked 0xFF bytes, stuffing, the final
    flush)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        """Code ``val`` with the statistics bin ``st[i]`` (adapted in place)."""
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._release()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _release(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_zeros()
            self._emit(self.buffer)
        if self.sc:
            self._flush_zeros()
            for _ in range(self.sc):
                self._emit(0xFF)
                self._emit(0)
            self.sc = 0

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._release()
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _arith_dc(enc, stats, ctx, ci, diff, L, U):
    """F.1.4.1: one DC difference; updates ctx[ci]."""
    st, s0 = stats, ctx[ci]
    if diff == 0:
        enc.encode(st, s0, 0)
        ctx[ci] = 0
        return
    enc.encode(st, s0, 1)
    if diff > 0:
        enc.encode(st, s0 + 1, 0)
        i, ctx[ci] = s0 + 2, 4
    else:
        diff = -diff
        enc.encode(st, s0 + 1, 1)
        i, ctx[ci] = s0 + 3, 8
    m, v = 0, diff - 1
    if v:
        enc.encode(st, i, 1)
        m, v2, i = 1, v, 20
        while v2 >> 1:
            v2 >>= 1
            enc.encode(st, i, 1)
            m <<= 1
            i += 1
    enc.encode(st, i, 0)
    if m < (1 << L) >> 1:
        ctx[ci] = 0
    elif m > (1 << U) >> 1:
        ctx[ci] += 8
    i += 14
    while m > 1:
        m >>= 1
        enc.encode(st, i, int(bool(m & v)))


def _arith_magnitude(enc, st, i, v, k, K, fixed):
    """F.1.4.2's magnitude category and bits of an AC value v >= 1 at bin i."""
    m, v = 0, v - 1
    if v:
        enc.encode(st, i, 1)
        m, v2 = 1, v
        if v2 >> 1:
            v2 >>= 1
            enc.encode(st, i, 1)
            m <<= 1
            i = 189 if k <= K else 217
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
    enc.encode(st, i, 0)
    i += 14
    while m > 1:
        m >>= 1
        enc.encode(st, i, int(bool(m & v)))


def _pt(v, al):
    """A coefficient's point transform: |v| >> al, the sign kept."""
    return (v >> al) if v >= 0 else -((-v) >> al)


def jpeg_arithmetic(planes, sampling, scans=None, restart=0, dac=None, jfif=True):
    """An arithmetic-coded JPEG (T.81 Annex D and F, G): SOF9 with one
    interleaved scan, or SOF10 with ``scans`` = [(component indices, Ss, Se,
    Ah, Al), ...]; a DAC segment from ``dac`` = (L, U, Kx) (T.81's defaults
    0, 1, 5 when None); restart markers every ``restart`` MCUs; the bins
    coded as libjpeg's jcarith.c codes them."""
    H, W, mcux, mcuy, coefs = _dct_coefs(planes, sampling)
    n = len(planes)
    L, U, K = dac or (0, 1, 5)
    progressive = scans is not None
    scans = scans or [(tuple(range(n)), 0, 63, 0, 0)]
    out = b"\xff\xd8" + (_jseg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0") if jfif else b"")
    out += _jseg(0xDB, b"\0" + bytes(STD_LUMA_Q[ZIGZAG].astype(np.uint8)))
    out += _jseg(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, H, W, n)
                 + b"".join(bytes([i + 1, (h << 4) | v, 0]) for i, (h, v) in enumerate(sampling)))
    if dac is not None:
        out += _jseg(0xCC, bytes([0x00, L | (U << 4), 0x10, K]))
    if restart:
        out += _jseg(0xDD, struct.pack(">H", restart))
    for comps, ss, se, ah, al in scans:
        out += _jseg(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps) + bytes([ss, se, ah << 4 | al]))
        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            bw = -(-(-(-W * h // max(x for x, _ in sampling))) // 8)
            bh = -(-(-(-H * v // max(y for _, y in sampling))) // 8)
            units = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
        else:
            units = [[(c, my * sampling[c][1] + yy, mx * sampling[c][0] + xx) for c in comps
                      for yy in range(sampling[c][1]) for xx in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        data = b""
        enc, dc_st, ac_st, fixed = QMEncoder(), [0] * 64, [0] * 256, [113]
        preds, ctx = [0] * n, [0] * n
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                data += enc.finish() + bytes([0xFF, 0xD0 + (u // restart - 1) % 8])
                enc, preds, ctx = QMEncoder(), [0] * n, [0] * n
                if not progressive or (ss == 0 and ah == 0):
                    dc_st = [0] * 64
                if not progressive or ss:
                    ac_st = [0] * 256
            for c, by, bx in unit:
                zz = [int(x) for x in coefs[c][by, bx].reshape(64)[ZIGZAG]]
                if ss == 0 and ah == 0:  # DC first (or sequential)
                    dcv = zz[0] >> al
                    _arith_dc(enc, dc_st, ctx, c, dcv - preds[c], L, U)
                    preds[c] = dcv
                elif ss == 0:  # DC refinement
                    enc.encode(fixed, 0, (zz[0] >> al) & 1)
                if se == 0:
                    continue
                lo = max(ss, 1)
                vals = [_pt(zz[k], al) for k in range(64)]
                ke = next((k for k in range(se, 0, -1) if vals[k]), 0)
                if ah == 0:
                    k = lo
                    while k <= ke:
                        enc.encode(ac_st, 3 * (k - 1), 0)
                        while vals[k] == 0:
                            enc.encode(ac_st, 3 * (k - 1) + 1, 0)
                            k += 1
                        enc.encode(ac_st, 3 * (k - 1) + 1, 1)
                        enc.encode(fixed, 0, int(vals[k] < 0))
                        _arith_magnitude(enc, ac_st, 3 * (k - 1) + 2, abs(vals[k]), k, K, fixed)
                        k += 1
                else:  # AC refinement (G.1.3.3)
                    prev = [_pt(zz[k], ah) for k in range(64)]
                    kex = next((k for k in range(ke, 0, -1) if prev[k]), 0)
                    k = lo
                    while k <= ke:
                        if k > kex:
                            enc.encode(ac_st, 3 * (k - 1), 0)
                        while True:
                            a = abs(vals[k])
                            if a:
                                if a >> 1:
                                    enc.encode(ac_st, 3 * (k - 1) + 2, a & 1)
                                else:
                                    enc.encode(ac_st, 3 * (k - 1) + 1, 1)
                                    enc.encode(fixed, 0, int(vals[k] < 0))
                                break
                            enc.encode(ac_st, 3 * (k - 1) + 1, 0)
                            k += 1
                        k += 1
                if k <= se:
                    enc.encode(ac_st, 3 * (k - 1), 1)
        out += data + enc.finish()
    return out + b"\xff\xd9"


def jpeg_12bit(plane, quality_scale=1):
    """A 12-bit sequential Huffman JPEG (SOF1) of one (H, W) plane of values
    below 4096: 16 DC categories at 5 bits, 226 AC symbols at 8 bits."""
    H, W, mcux, mcuy, (coef,) = _dct_coefs([plane], [(1, 1)], precision=12)
    dcl, acl = [0] * 16, [0] * 16
    dcl[4], acl[7] = 16, 226
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 15)]
    dc, ac = _huffman_codes(dcl, range(16)), _huffman_codes(acl, ac_syms)
    bits, pred = [], 0

    def put(code, n):
        bits.extend((code >> i) & 1 for i in range(n - 1, -1, -1))

    for by in range(mcuy):
        for bx in range(mcux):
            zz = coef[by, bx].reshape(64)[ZIGZAG]
            d = int(zz[0]) - pred
            pred = int(zz[0])
            n = abs(d).bit_length()
            put(*dc[n])
            put(d if d >= 0 else d - 1 + (1 << n), n)
            run = 0
            for k in range(1, 64):
                if zz[k] == 0:
                    run += 1
                    continue
                while run > 15:
                    put(*ac[0xF0])
                    run -= 16
                n = abs(int(zz[k])).bit_length()
                put(*ac[(run << 4) | n])
                put(int(zz[k]) if zz[k] >= 0 else int(zz[k]) - 1 + (1 << n), n)
                run = 0
            if run:
                put(*ac[0])
    out = b"\xff\xd8" + _jseg(0xDB, b"\0" + bytes(STD_LUMA_Q[ZIGZAG].astype(np.uint8)))
    out += _jseg(0xC1, struct.pack(">BHHB", 12, H, W, 1) + bytes([1, 0x11, 0]))
    out += _jseg(0xC4, b"\x00" + bytes(dcl) + bytes(range(16)) + b"\x10" + bytes(acl) + bytes(ac_syms))
    out += _jseg(0xDA, bytes([1, 1, 0, 0, 63, 0]))
    return out + _stuff(bits) + b"\xff\xd9"


def jpeg_hierarchical(data: bytes) -> bytes:
    """A baseline JPEG made a one-frame hierarchical file: a DHP segment of
    its size before the frame, SOF0 turned into SOF5 (T.81 Annex J)."""
    i = data.index(b"\xff\xc0")
    (length,) = struct.unpack(">H", data[i + 2:i + 4])
    sof = data[i + 4:i + 2 + length]
    return data[:i] + _jseg(0xDE, sof) + b"\xff\xc5" + data[i + 2:]


def jpeg_dnl(data: bytes) -> bytes:
    """A baseline JPEG whose frame height is 0, set by a DNL segment after
    its first scan (T.81 B.2.5)."""
    i = data.index(b"\xff\xc0")
    (h,) = struct.unpack(">H", data[i + 5:i + 7])
    out = data[:i + 5] + b"\0\0" + data[i + 7:]
    assert out.endswith(b"\xff\xd9")
    return out[:-2] + _jseg(0xDC, struct.pack(">H", h)) + b"\xff\xd9"


# -- phase 20's image fixtures -----------------------------------------------

IMAGES_DIR = ("tests", "fixtures", "images")


def _img(seed, h, w, c=3, noise=10):
    """Smooth seeded colour (8-pixel cells, bilinear) plus noise."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, c)).astype(np.uint8)
    img = np.stack([cv2.resize(base[..., i], (w, h), interpolation=cv2.INTER_LINEAR) for i in range(c)], -1)
    return np.clip(img.astype(int) + rng.randint(-noise, noise + 1, (h, w, c)), 0, 255).astype(np.uint8)


def _pil_cmyk(img, quality, progressive=False):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=quality, progressive=progressive)
    return buf.getvalue()


def _cv2_progressive(img, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, quality=80):
    return cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])[1].tobytes()


def _sampled(img, sampling, **kw):
    return jpeg_baseline(sub_planes(img, sampling), sampling, **kw)


def _idx(seed, h, w, n):
    return np.random.RandomState(seed).randint(0, n, (h, w))


def _pal(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n, 3))


def _cmyk_1280x720():
    """phase 20a's timing file: 16-pixel CMYK cells with a little noise, q75"""
    rng = np.random.RandomState(0)
    cells = rng.randint(0, 256, (720 // 16 + 1, 1280 // 16 + 1, 4))
    img = np.repeat(np.repeat(cells, 16, 0), 16, 1)[:720, :1280]
    return _pil_cmyk(np.clip(img + rng.randint(-2, 3, img.shape), 0, 255).astype(np.uint8), 75)


# name: (kind, the function that makes the file's bytes)
IMAGE_FILES = {
    "gray1_adam7.png": ("PNG grey 1-bit Adam7", lambda: png(_idx(1, 19, 23, 2), 0, 1, interlace=True)),
    "gray4_trns.png": ("PNG grey 4-bit tRNS", lambda: png(_idx(2, 13, 17, 16), 0, 4, trns=b"\0\5")),
    "gray16.png": ("PNG grey 16-bit", lambda: png(_idx(3, 11, 21, 65536), 0, 16)),
    "rgb8_filters.png": ("PNG RGB 8-bit, all five filters", lambda: png(_img(4, 24, 40), 2, 8)),
    "rgb16_adam7.png": ("PNG RGB 16-bit Adam7", lambda: png(_idx(5, 17, 15, 65536).reshape(17, 5, 3), 2, 16,
                                                            interlace=True)),
    "palette2_trns.png": ("PNG palette 2-bit tRNS", lambda: png(_idx(6, 15, 29, 4), 3, 2, palette=_pal(6, 4),
                                                               trns=b"\0\x80")),
    "palette8_short.png": ("PNG palette 8-bit, indices past the palette", lambda: png(
        _idx(7, 16, 16, 256), 3, 8, palette=_pal(7, 200))),
    "ga8_adam7.png": ("PNG grey+alpha 8-bit Adam7", lambda: png(_idx(8, 9, 33, 256).reshape(9, 33, 1).repeat(2, 2),
                                                               4, 8, interlace=True)),
    "rgba16.png": ("PNG RGBA 16-bit", lambda: png(_idx(9, 10, 24, 65536).reshape(10, 6, 4), 6, 16)),
    "exif6.png": ("PNG eXIf orientation 6", lambda: png(_img(10, 14, 22), 2, 8, exif=tiff_orientation(6, False))),
    "bmp1.bmp": ("BMP 1-bit", lambda: bmp(None, 1, palette=_pal(11, 2), indices=_idx(11, 13, 37, 2))),
    "bmp4.bmp": ("BMP 4-bit", lambda: bmp(None, 4, palette=_pal(12, 16), indices=_idx(12, 11, 19, 16))),
    "bmp8_topdown.bmp": ("BMP 8-bit top-down, 200 colours", lambda: bmp(
        None, 8, top_down=True, palette=_pal(13, 200), indices=_idx(13, 12, 21, 200))),
    "rle4.bmp": ("BMP RLE4", lambda: bmp(None, 4, palette=_pal(14, 16), indices=np.zeros((6, 10), np.uint8), comp=2,
                                         rle=bytes([4, 0x3A, 0, 3, 0x12, 0x30, 3, 0x5F, 0, 0, 0, 2, 3, 0, 7, 0x81])
                                         + b"\0\0" * 4 + b"\0\1")),
    "rle8.bmp": ("BMP RLE8", lambda: bmp(None, 8, palette=_pal(15, 256), indices=_idx(15, 9, 27, 3), comp=1,
                                         rle=rle8_encode(_idx(15, 9, 27, 3)))),
    "bmp555.bmp": ("BMP 16-bit 5-5-5", lambda: bmp(_img(16, 10, 15), 15)),
    "bmp565.bmp": ("BMP 16-bit 5-6-5 BITFIELDS", lambda: bmp(_img(17, 12, 13), 16, comp=3,
                                                              masks=(0xF800, 0x7E0, 0x1F))),
    "bmp24_topdown.bmp": ("BMP 24-bit top-down", lambda: bmp(_img(18, 15, 22), 24, top_down=True)),
    "bmp32.bmp": ("BMP 32-bit", lambda: bmp(_img(19, 11, 17), 32)),
    "os2_8.bmp": ("BMP OS/2 8-bit", lambda: bmp(None, 8, palette=_pal(20, 256), indices=_idx(20, 9, 14, 256),
                                                header=12)),
    "p1.pbm": ("PNM P1", lambda: pnm(1, _idx(21, 7, 13, 2), 1)),
    "p2.pgm": ("PNM P2 maxval 200", lambda: pnm(2, _idx(22, 6, 9, 201), 200, comment=True)),
    "p3.ppm": ("PNM P3 maxval 1000", lambda: pnm(3, _idx(23, 5, 7, 1001).reshape(5, 7, 1).repeat(3, 2), 1000)),
    "p4.pbm": ("PNM P4", lambda: pnm(4, _idx(24, 9, 19, 2), 1)),
    "p5_16.pgm": ("PNM P5 16-bit", lambda: pnm(5, _idx(25, 8, 11, 65536), 65535)),
    "p6.ppm": ("PNM P6", lambda: pnm(6, _img(26, 10, 12), 255)),
    "cmyk.jpg": ("JPEG CMYK (Adobe, PIL)", lambda: _pil_cmyk(_img(27, 40, 48, 4), 90)),
    "cmyk_progressive.jpg": ("JPEG CMYK progressive", lambda: _pil_cmyk(_img(28, 33, 45, 4), 80, True)),
    "ycck.jpg": ("JPEG YCCK (Adobe transform 2)", lambda: _sampled(_img(29, 35, 41, 4), [(2, 2), (1, 1), (1, 1), (2, 2)],
                                                                  adobe=2)),
    "s411.jpg": ("JPEG 4:1:1", lambda: _sampled(_img(30, 37, 70), [(4, 1), (1, 1), (1, 1)], jfif=True)),
    "s440_v4.jpg": ("JPEG 1x4 luma", lambda: _sampled(_img(31, 69, 30), [(1, 4), (1, 1), (1, 1)], jfif=True)),
    "h3v2.jpg": ("JPEG 3x2 luma", lambda: _sampled(_img(32, 35, 53), [(3, 2), (1, 1), (1, 1)], jfif=True)),
    "smooth_norefine.jpg": ("JPEG progressive, refinement scans removed", lambda: keep_scans(
        _cv2_progressive(_img(33, 45, 61)), lambda i, ah: ah == 0)),
    "smooth_dc_only.jpg": ("JPEG progressive, DC scan only", lambda: keep_scans(
        _cv2_progressive(_img(34, 37, 29)), lambda i, ah: i == 0)),
    "png_named.JPEG": ("PNG named .JPEG", lambda: png(_img(35, 20, 26), 2, 8)),
    "cmyk_1280x720.jpg": ("JPEG CMYK 1280x720 (20a timing)", _cmyk_1280x720),
}


# -- the TIFF, WebP, GIF and JPEG-mode fixtures of phase 21 -----------------------------

def _smooth(seed, h, w, cell=48):
    """A smooth seeded frame: flat colour cells of ``cell`` pixels, no
    noise (so that each 1280x720 timing file stays under 200 KB)."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, (h // cell + 1, w // cell + 1, 3)).astype(np.uint8)
    return np.ascontiguousarray(np.repeat(np.repeat(cells, cell, 0), cell, 1)[:h, :w])


def _pil_webp(img, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _cv2_webp(img, quality):
    return cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()


def _cv2_tiff(img, *params):
    return cv2.imencode(".tif", img if img.ndim == 2 else img[..., ::-1], list(params))[1].tobytes()


def tiff_ycbcr_jpeg(img, rows=16, quality=90):
    """A YCbCr TIFF of JPEG strips (4:2:0, cv2's encoder) sharing one
    JPEGTables."""
    segs, tables = [], None
    for y in range(0, img.shape[0], rows):
        data = cv2.imencode(".jpg", np.ascontiguousarray(img[y:y + rows, :, ::-1]),
                            [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
        t, s = jpeg_segments(data)
        tables = tables or t
        segs.append(s)
    return tiff(img, photometric=6, compression=7, rows=rows, segments=segs, jpeg_tables=tables,
                tags=[(530, 3, [2, 2])])


def _quantized(img):
    """``img`` cut to 3-3-2 bits: (indices, the 256-colour table)."""
    idx = (img[..., 0] & 0xE0) | ((img[..., 1] >> 3) & 0x1C) | (img[..., 2] >> 6)
    i = np.arange(256)
    table = np.stack([(i & 0xE0) * 255 // 0xE0, ((i & 0x1C) << 3) * 255 // 0xE0, (i & 3) * 85], 1)
    return idx, table


def _gif_of(img, **kw):
    idx, table = _quantized(img)
    return gif([dict(indices=idx, **kw)], (img.shape[1], img.shape[0]), table)


def _anim_offset():
    kind, payload = webp_bitstream(_cv2_webp(_img(60, 20, 24), 80))
    return webp_animation((40, 30), [(6, 4, 24, 20, webp_chunk(kind, payload), 0)])


def _exif6():
    kind, payload = webp_bitstream(_cv2_webp(_img(61, 21, 34), 85))
    return webp_extended((34, 21), [webp_chunk(b"EXIF", tiff_orientation(6)), webp_chunk(kind, payload)], flags=0x08)


_SC = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
       ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
_S420 = [(2, 2), (1, 1), (1, 1)]

# name: (kind, the function that makes the file's bytes)
FORMAT_FILES = {
    "tiff_lzw_pred2.tif": ("TIFF LZW predictor 2, strips of 8", lambda: tiff(_img(40, 37, 45), compression=5, predictor=2,
                                                                             rows=8)),
    "tiff_deflate_planar.tif": ("TIFF Deflate planar predictor 2", lambda: tiff(_img(41, 30, 41), compression=8,
                                                                                 predictor=2, planar=2, rows=7)),
    "tiff_packbits_tiled.tif": ("TIFF PackBits tiles 16x32", lambda: tiff(_img(42, 40, 50), compression=32773,
                                                                          tile=(16, 32))),
    "tiff_bigtiff_mm.tif": ("BigTIFF big-endian LZW tiles", lambda: tiff(_img(43, 33, 35), compression=5, tile=(16, 16),
                                                                         bigtiff=True, big_endian=True)),
    "tiff_rgb16_pred2.tif": ("TIFF RGB 16-bit LZW predictor 2", lambda: tiff(
        np.random.RandomState(44).randint(0, 65536, (21, 29, 3)), bits=16, compression=5, predictor=2, rows=5)),
    "tiff_rgba_unassoc.tif": ("TIFF RGBA unassociated alpha", lambda: tiff(_img(45, 25, 31, 4), extra=[2],
                                                                           compression=8)),
    "tiff_gray1_miniswhite.tif": ("TIFF 1-bit MinIsWhite", lambda: tiff(_idx(46, 19, 45, 2), bits=1, photometric=0)),
    "tiff_gray16.tif": ("TIFF grey 16-bit big-endian", lambda: tiff(_idx(47, 17, 23, 65536), bits=16, photometric=1,
                                                                    big_endian=True)),
    "tiff_palette4.tif": ("TIFF palette 4-bit", lambda: tiff(_idx(48, 22, 27, 16), bits=4, photometric=3,
                                                             colormap=_idx(49, 16, 3, 65536), compression=5)),
    "tiff_palette8_8bitmap.tif": ("TIFF palette 8-bit, 8-bit ColorMap", lambda: tiff(
        _idx(50, 20, 30, 256), photometric=3, colormap=_idx(51, 256, 3, 256), compression=32773)),
    "tiff_jpeg_ycbcr.tif": ("TIFF JPEG YCbCr 4:2:0, JPEGTables", lambda: tiff_ycbcr_jpeg(_img(52, 45, 61))),
    "tiff_jpeg_rgb.tif": ("TIFF JPEG RGB (cv2)", lambda: _cv2_tiff(_img(53, 37, 50), cv2.IMWRITE_TIFF_COMPRESSION, 7,
                                                                   cv2.IMWRITE_TIFF_ROWSPERSTRIP, 16)),
    "tiff_orientation3.tif": ("TIFF orientation 3", lambda: tiff(_img(54, 19, 26), orientation=3, rows=4)),
    "gif_interlaced.gif": ("GIF interlaced, 256 colours", lambda: _gif_of(_img(55, 45, 63), interlace=True)),
    "gif_local_transparent.gif": ("GIF local table, transparency, offset in a larger screen", lambda: gif(
        [dict(indices=_idx(56, 20, 25, 16), palette=_pal(57, 16), transparent=3, left=7, top=5)], (40, 31),
        _pal(58, 8), background=6)),
    "gif87a_min2.gif": ("GIF87a, 4 colours, LZW minimum code size 2", lambda: gif(
        [dict(indices=_idx(59, 33, 47, 4))], (47, 33), _pal(60, 4), version=b"GIF87a")),
    "webp_lossy_q90.webp": ("WebP lossy q90 (cv2)", lambda: _cv2_webp(_img(62, 45, 61), 90)),
    "webp_lossy_q20.webp": ("WebP lossy q20 (cv2)", lambda: _cv2_webp(_img(63, 50, 70), 20)),
    "webp_lossless.webp": ("WebP lossless (cv2)", lambda: _cv2_webp(_img(64, 41, 53), 101)),
    "webp_lossless_palette.webp": ("WebP lossless, 4 colours (bundled)", lambda: _pil_webp(
        _pal(65, 4).astype(np.uint8)[_idx(66, 30, 41, 4)], lossless=True)),
    "webp_alpha_lossy.webp": ("WebP lossy with ALPH (VP8X)", lambda: _pil_webp(_img(67, 30, 40, 4), quality=80)),
    "webp_animated_offset.webp": ("WebP animation, first frame at an offset", _anim_offset),
    "webp_exif6.webp": ("WebP VP8X with EXIF orientation 6", _exif6),
    "jpeg_arith.jpg": ("JPEG arithmetic sequential 4:2:0", lambda: jpeg_arithmetic(sub_planes(_img(68, 37, 45), _S420),
                                                                                   _S420)),
    "jpeg_arith_progressive.jpg": ("JPEG arithmetic progressive, successive approximation", lambda: jpeg_arithmetic(
        sub_planes(_img(69, 33, 41), _S420), _S420, scans=_SC)),
    "jpeg_arith_restart_dac.jpg": ("JPEG arithmetic, DAC and restarts", lambda: jpeg_arithmetic(
        sub_planes(_img(70, 30, 50), [(1, 1)] * 3), [(1, 1)] * 3, dac=(2, 5, 20), restart=3)),
    "jpeg_lossless_pred7.jpg": ("JPEG lossless RGB predictor 7", lambda: jpeg_lossless(
        [_img(71, 23, 31)[..., c] for c in range(3)], predictor=7)),
    "jpeg_lossless_pt2_restart.jpg": ("JPEG lossless predictor 5, point transform 2, restarts", lambda: jpeg_lossless(
        [_img(72, 20, 27)[..., c] for c in range(3)], predictor=5, pt=2, restart=4)),
}
# phase 21a's decode timings: one 1280x720 file a kind, from one smooth frame
TIMING_FILES = {
    "timing_tiff_lzw_pred2.tif": ("TIFF LZW predictor 2", lambda: tiff(_smooth(0, 720, 1280), compression=5,
                                                                       predictor=2, rows=16)),
    "timing_tiff_jpeg.tif": ("TIFF JPEG YCbCr", lambda: tiff_ycbcr_jpeg(_smooth(0, 720, 1280), rows=16)),
    "timing_webp_q90.webp": ("WebP lossy q90", lambda: _cv2_webp(_smooth(0, 720, 1280), 90)),
    "timing_webp_lossless.webp": ("WebP lossless", lambda: _cv2_webp(_smooth(0, 720, 1280), 101)),
    "timing_gif.gif": ("GIF 3-3-2 colours", lambda: _gif_of(_smooth(0, 720, 1280))),
}
FORMAT_MANIFEST = "manifest_tiff_webp_gif.json"


# -- JPEG 2000, PAM, PFM, Sun raster and Radiance HDR (phase 22) ---------------

def jp2_pil(img, **kw) -> bytes:
    """A JPEG 2000 file (JP2, or a raw codestream with ``no_jp2=True``) of
    an (H, W), (H, W, 3) or (H, W, 4) uint8 or (H, W) uint16 frame, written
    by PIL's OpenJPEG with its keyword options."""
    from PIL import Image

    if img.dtype == np.uint16:
        im = Image.fromarray(img).convert("I;16")
    else:
        im = Image.fromarray(img, "L" if img.ndim == 2 else {2: "LA", 3: "RGB", 4: "RGBA"}[img.shape[2]])
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_top_boxes(data: bytes):
    """(type, whole box bytes) of each top-level box of a JP2 file."""
    pos, out = 0, []
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        size = size or len(data) - pos
        out.append((kind, data[pos:pos + size]))
        pos += size
    return out


def jp2_header_boxes(data: bytes, boxes) -> bytes:
    """The JP2 file with its header box holding its ihdr and then
    ``boxes`` (whole boxes: colr, pclr, cmap, cdef, ...) in their place."""
    out = b""
    for kind, whole in jp2_top_boxes(data):
        if kind == b"jp2h":
            kids = jp2_top_boxes(whole[8:])
            whole = jp2_box(b"jp2h", b"".join(k for t, k in kids if t == b"ihdr") + b"".join(boxes))
        out += whole
    return out


def colr(enumcs: int) -> bytes:
    return jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def jp2_palette(indices, palette, bits: int) -> bytes:
    """A JP2 of one 8-bit index component mapped through ``palette``
    ((n, 3) values below 2**bits) by pclr and cmap boxes, sRGB."""
    n = len(palette)
    k = (bits + 7) // 8
    body = struct.pack(">HB", n, 3) + bytes([bits - 1] * 3) + b"".join(
        int(v).to_bytes(k, "big") for v in np.asarray(palette).ravel())
    cmap = b"".join(struct.pack(">HBB", 0, 1, i) for i in range(3))
    return jp2_header_boxes(jp2_pil(indices.astype(np.uint8)),
                            [colr(16), jp2_box(b"pclr", body), jp2_box(b"cmap", cmap)])


def jp2_cdef(img, channels) -> bytes:
    """An RGB JP2 with a cdef box of (channel, type, association) entries."""
    body = struct.pack(">H", len(channels)) + b"".join(struct.pack(">HHH", *c) for c in channels)
    return jp2_header_boxes(jp2_pil(img), [colr(16), jp2_box(b"cdef", body)])


def jp2_siz(data: bytes, precision=None, sampling=None) -> bytes:
    """The file with its SIZ segment edited: every component's precision
    (bits), or component c's sub-sampling ``sampling[c]`` = (dx, dy)."""
    b = bytearray(data)
    at = data.index(b"\xff\x4f\xff\x51")
    (n,) = struct.unpack(">H", b[at + 40:at + 42])
    for c in range(n):
        if precision is not None:
            b[at + 42 + 3 * c] = precision - 1
        if sampling and c in sampling:
            b[at + 43 + 3 * c], b[at + 44 + 3 * c] = sampling[c]
    return bytes(b)


def pam(samples, maxval: int, tupltype=None) -> bytes:
    """A PAM (P7) of (H, W, depth) integer samples, 16-bit big-endian above
    maxval 255."""
    h, w, d = samples.shape
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {d}\nMAXVAL {maxval}\n"
    head += f"TUPLTYPE {tupltype}\n" if tupltype else ""
    body = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return (head + "ENDHDR\n").encode() + body


def pfm(values, scale: float = -1.0) -> bytes:
    """A PFM of (H, W, 3) (``PF``) or (H, W) (``Pf``) floats, rows
    bottom-up, little-endian for a negative scale."""
    h, w = values.shape[:2]
    kind = "PF" if values.ndim == 3 else "Pf"
    order = "<f4" if scale < 0 else ">f4"
    return f"{kind}\n{w} {h}\n{scale}\n".encode() + np.ascontiguousarray(values[::-1]).astype(order).tobytes()


def sun_raster(rows, w: int, h: int, bpp: int, kind: int = 1, cmap: bytes = b"", maptype=None) -> bytes:
    """A Sun raster of ``rows`` ((h, bytes a row) uint8, unpadded), each row
    padded to 16 bits; ``cmap`` an equal-RGB colour map (all reds, greens,
    then blues)."""
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    body = np.zeros((h, pitch), np.uint8)
    body[:, :rows.shape[1]] = rows
    maptype = (1 if cmap else 0) if maptype is None else maptype
    return struct.pack(">8I", 0x59A66A95, w, h, bpp, h * pitch, kind, maptype, len(cmap)) + cmap + body.tobytes()


def hdr(values, rle=True) -> bytes:
    """cv2's Radiance writer (run-length scanlines or flat) of (H, W, 3)
    RGB floats."""
    mode = cv2.IMWRITE_HDR_COMPRESSION_RLE if rle else cv2.IMWRITE_HDR_COMPRESSION_NONE
    return cv2.imencode(".hdr", np.ascontiguousarray(values[..., ::-1]).astype(np.float32),
                        [cv2.IMWRITE_HDR_COMPRESSION, mode])[1].tobytes()


def _floats(seed, h, w, c=3, top=2.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w, c) * top).astype(np.float32)


def _special_floats(seed, h, w):
    """Floats around 0-255 with halves, NaN, ±inf and values past int32."""
    v = _floats(seed, h, w, top=300.0) - 20
    v[0, :8, 0] = [np.nan, np.inf, -np.inf, 3e9, 2.5, 254.5, 255.5, 0.5]
    return v


JP2_FILES = {
    "jp2_53_rgb.jp2": ("JPEG 2000 5/3 RGB + RCT", lambda: jp2_pil(_img(60, 37, 45), mct=1)),
    "jp2_97_rgb.jp2": ("JPEG 2000 9/7 RGB + ICT", lambda: jp2_pil(_img(61, 41, 53), irreversible=True, mct=1)),
    "jp2_97_layers_pcrl.jp2": ("JPEG 2000 9/7, 3 layers, PCRL, precincts 32, 4 resolutions", lambda: jp2_pil(
        _img(62, 70, 66), irreversible=True, mct=1, quality_mode="rates", quality_layers=[30, 10, 4],
        progression="PCRL", precinct_size=(32, 32), num_resolutions=4, codeblock_size=(16, 16))),
    "jp2_53_rlcp.jp2": ("JPEG 2000 5/3 RLCP, 2 layers", lambda: jp2_pil(_img(63, 33, 47), progression="RLCP",
                                                                        quality_layers=[20, 1])),
    "jp2_97_rpcl_tiles.jp2": ("JPEG 2000 9/7 RPCL, 24x17 tiles, precincts 16", lambda: jp2_pil(
        _img(64, 50, 56), irreversible=True, mct=1, tile_size=(24, 17), progression="RPCL",
        precinct_size=(16, 16), num_resolutions=3)),
    "jp2_53_cprl.jp2": ("JPEG 2000 5/3 CPRL, precincts 32", lambda: jp2_pil(_img(65, 50, 61), progression="CPRL",
                                                                            precinct_size=(32, 32))),
    "jp2_97_cblk_4x64.jp2": ("JPEG 2000 9/7 code-blocks 4x64", lambda: jp2_pil(
        _img(66, 45, 70), irreversible=True, codeblock_size=(4, 64))),
    "jp2_53_res1.jp2": ("JPEG 2000 5/3, one resolution", lambda: jp2_pil(_img(67, 23, 31), num_resolutions=1)),
    "jp2_97_res6.jp2": ("JPEG 2000 9/7, 6 resolutions", lambda: jp2_pil(_img(68, 48, 56), irreversible=True,
                                                                        num_resolutions=6)),
    "jp2_grey.jp2": ("JPEG 2000 grey", lambda: jp2_pil(_img(69, 40, 52)[..., 0], irreversible=True)),
    "jp2_grey16.jp2": ("JPEG 2000 16-bit grey", lambda: jp2_pil(
        (_img(70, 30, 38)[..., 0].astype(np.uint16) * 256 + _idx(70, 30, 38, 256).astype(np.uint16)))),
    "jp2_rgba.jp2": ("JPEG 2000 RGBA (alpha dropped)", lambda: jp2_pil(_img(71, 29, 35, c=4))),
    "jp2_97_mct0.jp2": ("JPEG 2000 9/7 RGB without MCT", lambda: jp2_pil(_img(72, 38, 44), irreversible=True)),
    "jp2_97_plt.jp2": ("JPEG 2000 9/7 with PLT markers", lambda: jp2_pil(_img(73, 44, 39), irreversible=True, mct=1,
                                                                         plt=True)),
    "jp2_raw.j2k": ("JPEG 2000 raw codestream", lambda: jp2_pil(_img(74, 35, 42), irreversible=True, mct=1,
                                                                no_jp2=True)),
    "jp2_sycc.jp2": ("JPEG 2000 sYCC", lambda: jp2_header_boxes(jp2_pil(_img(75, 31, 37)), [colr(18)])),
    "jp2_palette12.jp2": ("JPEG 2000 palette, 12-bit entries", lambda: jp2_palette(
        _idx(76, 27, 33, 256), _pal(76, 256).astype(np.int64) * 16 + 5, 12)),
    "jp2_cdef_bgr.jp2": ("JPEG 2000 cdef blue-first", lambda: jp2_cdef(_img(77, 26, 30), [(0, 0, 3), (1, 0, 2),
                                                                                          (2, 0, 1)])),
    "jp2_la_grey.jp2": ("JPEG 2000 grey + alpha", lambda: jp2_pil(_img(78, 24, 28, c=2))),
    "jp2_12bit.jp2": ("JPEG 2000 12-bit (SIZ edited)", lambda: jp2_siz(jp2_pil(_img(79, 25, 27), mct=1), 12)),
}
PAM_PFM_SUN_HDR_FILES = {
    "pam_rgb.pam": ("PAM RGB, no TUPLTYPE (cv2's writer)", lambda: cv2.imencode(".pam", _img(80, 23, 29))[1].tobytes()),
    "pam_rgb16.pam": ("PAM RGB maxval 65535", lambda: pam(_idx(81, 19, 21, 65536).reshape(19, 7, 3), 65535, "RGB")),
    "pam_grey100.pam": ("PAM GRAYSCALE maxval 100", lambda: pam(_idx(82, 17, 25, 101)[..., None], 100, "GRAYSCALE")),
    "pam_bw.pam": ("PAM BLACKANDWHITE maxval 1 (packed bits)", lambda: pam(_idx(83, 13, 22, 2)[..., None], 1,
                                                                          "BLACKANDWHITE")),
    "pam_grey_alpha_bits.pam": ("PAM GRAYSCALE_ALPHA maxval 1", lambda: pam(_idx(84, 9, 17, 2).reshape(9, 17, 1)
                                                                            .repeat(2, 2), 1, "GRAYSCALE_ALPHA")),
    "pfm_le.pfm": ("PFM little-endian", lambda: pfm(_special_floats(85, 15, 19))),
    "pfm_be_scale3.pfm": ("PFM big-endian, scale 3", lambda: pfm(_special_floats(86, 14, 18), 3.0)),
    "sun_24.ras": ("Sun raster 24-bit (cv2's writer)", lambda: cv2.imencode(".ras", _img(87, 21, 27))[1].tobytes()),
    "sun_32_old.ras": ("Sun raster 32-bit, old type", lambda: sun_raster(
        _img(88, 11, 13, c=4).reshape(11, 52), 13, 11, 32, kind=0)),
    "sun_8_map.ras": ("Sun raster 8-bit, colour map of 40", lambda: sun_raster(
        _idx(89, 15, 21, 48).astype(np.uint8), 21, 15, 8, cmap=_pal(89, 40).astype(np.uint8).T.tobytes())),
    "sun_8_grey.ras": ("Sun raster 8-bit, no map", lambda: sun_raster(_idx(90, 12, 17, 256).astype(np.uint8), 17, 12,
                                                                      8)),
    "sun_1.ras": ("Sun raster 1-bit", lambda: sun_raster(np.packbits(_idx(91, 10, 21, 2).astype(np.uint8), axis=1),
                                                         21, 10, 1)),
    "sun_1_map.ras": ("Sun raster 1-bit, colour map", lambda: sun_raster(
        np.packbits(_idx(92, 9, 14, 2).astype(np.uint8), axis=1), 14, 9, 1, cmap=_pal(92, 2).astype(np.uint8).T.tobytes())),
    "hdr_rle.hdr": ("Radiance HDR run-length (cv2's writer)", lambda: hdr(_floats(93, 21, 33))),
    "hdr_flat.hdr": ("Radiance HDR flat", lambda: hdr(_floats(94, 13, 19), rle=False)),
    "hdr_narrow.hdr": ("Radiance HDR 5 wide (flat by width)", lambda: hdr(_floats(95, 9, 5))),
    "hdr_header.hdr": ("Radiance HDR #?RGBE, header lines", lambda: b"#?RGBE\n# made here\nEXPOSURE=2.0\n"
                       b"FORMAT=32-bit_rle_rgbe\nGAMMA=2.2\n\n-Y 7 +X 12\n" + hdr(_floats(96, 7, 12)).split(
                           b"+X 12\n", 1)[1]),
}
JP2_TIMING_FILES = {
    "timing_jp2_97.jp2": ("JPEG 2000 9/7 rate 40", lambda: jp2_pil(_img(97, 720, 1280), irreversible=True, mct=1,
                                                                   quality_mode="rates", quality_layers=[40])),
    "timing_jp2_53.jp2": ("JPEG 2000 5/3", lambda: jp2_pil(_smooth(0, 720, 1280), mct=1)),
    "timing_hdr_rle.hdr": ("Radiance HDR run-length", lambda: hdr(_smooth(0, 720, 1280).astype(np.float32) / 255)),
}
JP2_FORMAT_FILES = {**JP2_FILES, **PAM_PFM_SUN_HDR_FILES}
JP2_MANIFEST = "manifest_jp2_hdr_pam.json"
# phase 22b's tree: make_synthetic_dataset's 2 val sequences of 12 frames at a GOT-10k frame's size, each frame
# written by PIL's OpenJPEG irreversible (ICT) at this rate under its .jpg name
JP2_TREE_SEED, JP2_TREE_RATE, JP2_TREE_HW = 22, 80, (720, 1280)


def write_jp2_fixtures(images_dir: str) -> None:
    """Phase 22a's files (``JP2_FORMAT_FILES``, ``JP2_TIMING_FILES``) and
    their manifest of cv2's pixels."""
    files = {**JP2_FORMAT_FILES, **JP2_TIMING_FILES}
    for name, (_kind, make) in files.items():
        with open(os.path.join(images_dir, name), "wb") as fh:
            fh.write(make())
    with open(os.path.join(images_dir, JP2_MANIFEST), "w") as fh:
        json.dump(image_manifest(images_dir, files), fh, indent=1)


def tree_files(root: str) -> dict:
    """{path relative to root: sha256} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            if os.path.relpath(path, root) != chip_smoke.JP2_TREE_RECORD:
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root).replace(os.sep, "/")] = chip_smoke._sha(fh.read())
    return dict(sorted(out.items()))


def write_jp2_tree(root: str) -> dict:
    """Phase 22b's GOT-10k val tree under ``root`` and its record: the
    files' sha256s, the rate, the frame size, the bytes, and the port's OPE
    result over it on this host's CPU (``FEARTracker`` FEAR-XS, float32)."""
    import shutil

    import torch

    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
    from feartracker_tpu_torch.tools.make_synthetic_dataset import generate

    shutil.rmtree(root, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        generate(tmp, tracks=0, frames=12, val_sequences=2, seed=JP2_TREE_SEED, size=JP2_TREE_HW)
        src = os.path.join(tmp, "got10k", "val")
        for d, _, files in os.walk(src):
            out = os.path.join(root, "val", os.path.relpath(d, src))
            os.makedirs(out, exist_ok=True)
            for f in files:
                if f.endswith(".npy"):
                    data = jp2_pil(np.load(os.path.join(d, f)), irreversible=True, mct=1, quality_mode="rates",
                                   quality_layers=[JP2_TREE_RATE])
                    with open(os.path.join(out, f[:-4] + ".jpg"), "wb") as fh:
                        fh.write(data)
                else:
                    shutil.copyfile(os.path.join(d, f), os.path.join(out, f))
    files = tree_files(root)
    ds = GOT10kDataset(root, "val")
    with torch.inference_mode():
        ao = evaluate_tracker(chip_smoke._fear_tracker("cpu", torch.float32), ds)
    size = sum(os.path.getsize(os.path.join(root, f)) for f in files)
    record = {"seed": JP2_TREE_SEED, "rate": JP2_TREE_RATE, "frame_hw": list(JP2_TREE_HW), "bytes": size,
              "lengths": [len(ds[i][0]) for i in range(len(ds))], "files": files, "ope_cpu": ao}
    with open(os.path.join(root, chip_smoke.JP2_TREE_RECORD), "w") as fh:
        json.dump(record, fh, indent=1)
    return record


# -- CCITT, FillOrder 2, CMYK, CIELab, YCbCr and signed TIFF (phase 23) ----------

PIL_FAX = {2: "tiff_ccitt", 3: "group3", 4: "group4", 32771: "tiff_raw_16"}  # PIL's names of libtiff's codecs


def ccitt_segments(bits, compression, rows=None, tile=None, t4=0):
    """libtiff's CCITT coding (through PIL) of each strip (``rows`` rows) or
    tile (``tile`` = (h, w), padded with zero bits) of the (H, W) 0/1 array
    ``bits``: each block saved as a one-strip image and its strip taken.
    A set bit is a black run's (the fax coders' 1)."""
    from PIL import Image

    bits = np.asarray(bits, bool)
    H, W = bits.shape
    if tile:
        th, tw = tile
        pad = np.zeros((-(-H // th) * th, -(-W // tw) * tw), bool)
        pad[:H, :W] = bits
        blocks = [pad[y:y + th, x:x + tw] for y in range(0, H, th) for x in range(0, W, tw)]
    else:
        rows = rows or H
        blocks = [bits[y:y + rows] for y in range(0, H, rows)]
    segs = []
    for b in blocks:
        buf = io.BytesIO()
        Image.fromarray(b).save(buf, "TIFF", compression=PIL_FAX[compression], strip_size=1 << 30,
                                **({"tiffinfo": {292: t4}} if compression == 3 else {}))
        (off,), (n,) = Image.open(buf).tag_v2[273], Image.open(buf).tag_v2[279]
        segs.append(buf.getvalue()[off:off + n])
    return segs


def tiff_ccitt(bits, compression, rows=None, tile=None, t4=0, photometric=0, fill_order=None):
    """A bilevel TIFF of the 0/1 array ``bits`` coded by libtiff's CCITT
    encoder: compression 2 (Modified Huffman), 3 (Group 3, ``t4`` its
    T4Options), 4 (Group 4) or 32771 (RLEW); strips or tiles; MinIsWhite
    (0) or MinIsBlack (1); FillOrder 2 reverses each segment's bits."""
    segs = ccitt_segments(bits, compression, rows, tile, t4)
    return tiff(np.asarray(bits, np.uint8), bits=1, photometric=photometric, compression=compression, rows=rows,
                tile=tile, segments=segs, tags=[(292, 4, [t4])] if compression == 3 else [], fill_order=fill_order)


def _bw(seed, h, w):
    """A seeded bilevel frame: ``_img``'s first channel thresholded (blobs
    with noisy edges)."""
    return _img(seed, h, w)[..., 0] > 128


def _pil_mode(img, mode, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


def _pil_samples(img, mode):
    from PIL import Image

    return np.asarray(Image.fromarray(img).convert(mode))


def tiff_planar_jpeg(samples, photometric, rows=16, tags=()):
    """A planar TIFF of 8-bit ``samples``, each plane's strips a one-component
    JPEG (cv2's encoder) sharing one JPEGTables."""
    H, _, C = samples.shape
    segs, tables = [], None
    for c in range(C):
        for y in range(0, H, rows):
            data = cv2.imencode(".jpg", np.ascontiguousarray(samples[y:y + rows, :, c]),
                                [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
            t, seg = jpeg_segments(data)
            tables = tables or t
            segs.append(seg)
    return tiff(samples, photometric=photometric, compression=7, planar=2, rows=rows, segments=segs,
                jpeg_tables=tables, tags=tags)


def _cmyk(seed, h, w):
    return np.concatenate([_img(seed, h, w), _img(seed + 1, h, w)[..., :1]], axis=2)


# name: (kind, the function that makes the file's bytes)
FAX_CMYK_FILES = {
    "tiff_ccitt_mh.tif": ("TIFF CCITT Modified Huffman, strips of 8, MinIsWhite", lambda: tiff_ccitt(
        _bw(80, 37, 45), 2, rows=8)),
    "tiff_ccitt_rlew.tif": ("TIFF CCITT RLEW (word-aligned rows), MinIsBlack", lambda: tiff_ccitt(
        _bw(81, 29, 50), 32771, rows=5, photometric=1)),
    "tiff_g3_1d_fill2.tif": ("TIFF Group 3 1-D, EOLs byte-aligned, FillOrder 2", lambda: tiff_ccitt(
        _bw(82, 40, 61), 3, rows=16, t4=4, fill_order=2)),
    "tiff_g3_2d_tiles.tif": ("TIFF Group 3 2-D, tiles 16x32", lambda: tiff_ccitt(_bw(83, 45, 70), 3, tile=(16, 32),
                                                                                  t4=1)),
    "tiff_g4_strips.tif": ("TIFF Group 4, strips of 10, MinIsBlack", lambda: tiff_ccitt(
        _bw(84, 43, 66), 4, rows=10, photometric=1)),
    "tiff_g4_tiles_fill2.tif": ("TIFF Group 4, tiles 32x16, FillOrder 2", lambda: tiff_ccitt(
        _bw(85, 50, 41), 4, tile=(32, 16), fill_order=2)),
    "tiff_fill2_lzw_pred2.tif": ("TIFF RGB LZW predictor 2, FillOrder 2", lambda: tiff(
        _img(86, 33, 41), compression=5, predictor=2, rows=8, fill_order=2)),
    "tiff_fill2_packbits_1bit.tif": ("TIFF 1-bit PackBits, FillOrder 2", lambda: tiff(
        _bw(87, 30, 45).astype(np.uint8), bits=1, photometric=0, compression=32773, fill_order=2)),
    "tiff_cmyk_lzw_pred2.tif": ("TIFF CMYK LZW predictor 2", lambda: tiff(
        _cmyk(88, 31, 39), photometric=5, compression=5, predictor=2, rows=8)),
    "tiff_cmyk_planar_deflate_tiles.tif": ("TIFF CMYK planar Deflate tiles 16x16", lambda: tiff(
        _cmyk(90, 35, 40), photometric=5, compression=8, planar=2, tile=(16, 16))),
    "tiff_cmyk_packbits.tif": ("TIFF CMYK PackBits", lambda: tiff(_cmyk(92, 27, 33), photometric=5,
                                                                  compression=32773, rows=9)),
    "tiff_cmyk_jpeg.tif": ("TIFF CMYK JPEG (PIL)", lambda: _pil_mode(_img(94, 37, 45), "CMYK", compression="jpeg")),
    "tiff_cmyk_planar_jpeg.tif": ("TIFF CMYK planar JPEG", lambda: tiff_planar_jpeg(_cmyk(95, 33, 41), 5)),
    "tiff_lab8.tif": ("TIFF CIELab 8-bit (PIL)", lambda: _pil_mode(_img(97, 31, 43), "LAB")),
    "tiff_lab16_lzw_be.tif": ("TIFF CIELab 16-bit LZW big-endian", lambda: tiff(
        np.random.RandomState(98).randint(0, 65536, (23, 29, 3)), bits=16, photometric=8, compression=5,
        big_endian=True, rows=6)),
    "tiff_lab_whitepoint_tiles.tif": ("TIFF CIELab WhitePoint D65, tiles 16x16", lambda: tiff(
        _pil_samples(_img(99, 35, 37), "LAB"), photometric=8, tile=(16, 16),
        tags=[(318, 5, [(3127, 10000), (3290, 10000)])])),
    "tiff_lab_jpeg.tif": ("TIFF CIELab JPEG (PIL)", lambda: _pil_mode(_img(100, 37, 45), "LAB", compression="jpeg")),
    "tiff_ycbcr_pil.tif": ("TIFF YCbCr 1x1 with ReferenceBlackWhite (PIL)", lambda: _pil_mode(
        _img(101, 31, 43), "YCbCr")),
    "tiff_ycbcr_22.tif": ("TIFF YCbCr 2x2, strips of 8", lambda: tiff(
        _img(102, 37, 45), photometric=6, ycbcr=(2, 2), rows=8)),
    "tiff_ycbcr_21_lzw_pred2.tif": ("TIFF YCbCr 2x1 LZW predictor 2", lambda: tiff(
        _img(103, 33, 47), photometric=6, ycbcr=(2, 1), compression=5, predictor=2, rows=12)),
    "tiff_ycbcr_12.tif": ("TIFF YCbCr 1x2", lambda: tiff(_img(104, 35, 29), photometric=6, ycbcr=(1, 2), rows=10)),
    "tiff_ycbcr_41_deflate.tif": ("TIFF YCbCr 4x1 Deflate", lambda: tiff(
        _img(105, 26, 45), photometric=6, ycbcr=(4, 1), compression=8)),
    "tiff_ycbcr_42_tiles.tif": ("TIFF YCbCr 4x2 PackBits tiles 16x32", lambda: tiff(
        _img(106, 37, 45), photometric=6, ycbcr=(4, 2), compression=32773, tile=(16, 32))),
    "tiff_ycbcr_44_tiles.tif": ("TIFF YCbCr 4x4 tiles 16x16, cut by the right edge", lambda: tiff(
        _img(107, 37, 45), photometric=6, ycbcr=(4, 4), tile=(16, 16))),
    "tiff_ycbcr_rbw_709.tif": ("TIFF YCbCr 2x2, ReferenceBlackWhite 16-235/240, BT.709 coefficients", lambda: tiff(
        _img(108, 31, 37), photometric=6, ycbcr=(2, 2), compression=5, rows=8,
        tags=[(532, 5, [16, 235, 128, 240, 128, 240]), (529, 5, [(2126, 10000), (7152, 10000), (722, 10000)])])),
    "tiff_ycbcr_planar_11.tif": ("TIFF YCbCr 1x1 planar", lambda: tiff(
        _img(109, 29, 35), photometric=6, planar=2, compression=5, tags=[(530, 3, [1, 1])])),
    "tiff_ycbcr_planar_jpeg.tif": ("TIFF YCbCr 1x1 planar JPEG", lambda: tiff_planar_jpeg(
        _img(110, 33, 41), 6, tags=[(530, 3, [1, 1])])),
    "tiff_grey16_edge_tiles.tif": ("TIFF grey 16-bit tiles 16x32, cut by the right edge", lambda: tiff(
        np.random.RandomState(112).randint(0, 65536, (37, 45)), bits=16, photometric=1, tile=(16, 32),
        compression=5, predictor=2)),
    "tiff_signed_rgb16.tif": ("TIFF RGB 16-bit, SampleFormat 2 (signed)", lambda: tiff(
        np.random.RandomState(111).randint(0, 65536, (19, 23, 3)), bits=16, compression=5, predictor=2,
        tags=[(339, 3, [2, 2, 2])])),
}
_PAGE = (720, 1280)  # phase 23a's timing pages


def _bw_page():
    return _smooth(0, *_PAGE, cell=16).astype(np.int32).sum(axis=2) < 384


FAX_CMYK_TIMING_FILES = {
    "timing_tiff_g4.tif": ("TIFF Group 4 page", lambda: tiff_ccitt(_bw_page(), 4)),
    "timing_tiff_g3_2d.tif": ("TIFF Group 3 2-D page", lambda: tiff_ccitt(_bw_page(), 3, t4=1)),
    "timing_tiff_cmyk_lzw.tif": ("TIFF CMYK LZW", lambda: tiff(
        np.concatenate([255 - _smooth(0, *_PAGE), _smooth(1, *_PAGE)[..., :1] // 4], axis=2), photometric=5,
        compression=5, predictor=2, rows=16)),
    "timing_tiff_lab.tif": ("TIFF CIELab LZW", lambda: tiff(_pil_samples(_smooth(0, *_PAGE), "LAB"), photometric=8,
                                                            compression=5, predictor=2, rows=16)),
    "timing_tiff_ycbcr22.tif": ("TIFF YCbCr 2x2 Deflate", lambda: tiff(
        _pil_samples(_smooth(0, *_PAGE), "YCbCr"), photometric=6, ycbcr=(2, 2), compression=8, rows=16)),
}
FAX_CMYK_MANIFEST = "manifest_tiff_fax_cmyk.json"


def write_fax_cmyk_fixtures(images_dir: str) -> None:
    """Phase 23a's files (``FAX_CMYK_FILES``, ``FAX_CMYK_TIMING_FILES``) and
    their manifest of cv2's pixels."""
    files = {**FAX_CMYK_FILES, **FAX_CMYK_TIMING_FILES}
    for name, (_kind, make) in files.items():
        with open(os.path.join(images_dir, name), "wb") as fh:
            fh.write(make())
    with open(os.path.join(images_dir, FAX_CMYK_MANIFEST), "w") as fh:
        json.dump(image_manifest(images_dir, files), fh, indent=1)


def ope_boxes(tracker, ds):
    """``evaluate_tracker``'s result over ``ds`` and each sequence's boxes
    (``run_sequence``'s, frame 0's the initial box)."""
    from feartracker_tpu_torch.evaluate import got10k_eval as ge

    overlaps, names, precision, boxes = [], [], [], []
    for s in range(len(ds)):
        files, anno, _ = ds[s]
        n = min(len(files), len(anno))
        preds, _ = ge.run_sequence(tracker, files, anno[0], n)
        gt = np.asarray(anno[1:n], np.float64)
        overlaps.append(ge._overlap(preds[1:], gt))
        precision.append(ge.precision_stats(preds[1:], gt))
        names.append(ds.sequence_name(s))
        boxes.append(np.asarray(preds, np.float64).tolist())
    return ge.summarize(overlaps, names, precision), boxes


def write_tiff_ope_record(path: str) -> dict:
    """Phase 23b(ii)'s record: phase 19c's GOT-10k val tree (made here as
    phase 19b makes it: ``make_synthetic_dataset`` seed 19, JPEG frames of a
    GOT-10k frame's size) rewritten by ``chip_smoke.tiff_ycbcr22``: each
    frame's sha256 and the port's OPE result and boxes over it on this
    host's CPU (``FEARTracker`` FEAR-XS, float32)."""
    import torch

    from feartracker_tpu_torch.data.sequence import GOT10kDataset

    torch.set_num_threads(1)  # as the test that holds this record runs
    with tempfile.TemporaryDirectory() as tmp:
        jpeg_root = chip_smoke.host_ope_tree(tmp)
        root = os.path.join(tmp, "ycbcr")
        chip_smoke._rewrite_tree(jpeg_root, root, chip_smoke.tiff_ycbcr22)
        ds = GOT10kDataset(root, "val")
        with torch.inference_mode():
            ao, boxes = ope_boxes(chip_smoke._fear_tracker("cpu", torch.float32), ds)
        record = {"seed": chip_smoke.HOST_OPE_SEED, "frame_hw": list(chip_smoke.HOSTAUG_FRAME_HW),
                  "lengths": [len(ds[i][0]) for i in range(len(ds))], "files": tree_files(root),
                  "ope_cpu": json.loads(json.dumps(ao)), "boxes_cpu": boxes}
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
    return record


# -- multi-partition VP8, the JPEG 2000 coding modes and SOF11 (phase 24) -----------
#
# The writers drive the encoders of the libraries PIL bundles (``pillow.libs``)
# through ctypes: libwebp 1.6 for the options PIL does not pass on (token
# partitions, segments, SNS), OpenJPEG 2.5 for the code-block styles, ROI,
# POC, SOP/EPH and tile-parts, and libjpeg-turbo for lossless JPEG. The
# decoder under test is cv2's, not these encoders'.

def pillow_lib(stem: str, mode: int = ctypes.DEFAULT_MODE) -> ctypes.CDLL:
    """The shared library ``lib<stem>-*.so*`` of ``pillow.libs`` beside PIL."""
    import glob

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    (path,) = glob.glob(os.path.join(libs, f"lib{stem}-*.so*"))
    return ctypes.CDLL(path, mode=mode)


WEBP_ENCODER_ABI = 0x0210  # libwebp 1.5-1.6's WEBP_ENCODER_ABI_VERSION; the library checks its major byte
_WEBP_FIELDS = ("lossless quality method image_hint target_size target_PSNR segments sns_strength filter_strength "
                "filter_sharpness filter_type autofilter alpha_compression alpha_filtering alpha_quality pass "
                "show_compressed preprocessing partitions partition_limit emulate_jpeg_size thread_level low_memory "
                "near_lossless exact use_delta_palette use_sharp_yuv qmin qmax").split()


class WebPConfig(ctypes.Structure):
    """libwebp 1.6's ``WebPConfig`` (encode.h)."""
    _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR") else ctypes.c_int) for f in _WEBP_FIELDS]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


_WEBP_PICTURE_BYTES = 256  # sizeof(WebPPicture) on x86-64; width/height at 8, writer/custom_ptr at 96


@functools.cache
def _libwebp() -> ctypes.CDLL:
    pillow_lib("sharpyuv", ctypes.RTLD_GLOBAL)  # libwebp's undefined SharpYuv* symbols
    lib = pillow_lib("webp")
    if lib.WebPGetEncoderVersion() < 0x10500:
        raise RuntimeError(f"libwebp {lib.WebPGetEncoderVersion():#x}: the writer is laid out for 1.5-1.6")
    lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    return lib


def webp_libwebp(img, quality: float = 75.0, **options) -> bytes:
    """A lossy WebP (RIFF + VP8) of the (H, W, 3) uint8 RGB ``img``, written by
    libwebp's ``WebPEncode`` with ``WebPConfig`` fields ``options``
    (``partitions`` 0-3 = 1, 2, 4 or 8 token partitions, ``segments``,
    ``sns_strength``, ``method``, ...) over the default preset at ``quality``."""
    lib = _libwebp()
    cfg = WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), WEBP_ENCODER_ABI):
        raise RuntimeError("WebPConfigInitInternal refused the ABI version")
    assert (cfg.quality, cfg.method, cfg.segments, cfg.sns_strength, cfg.alpha_quality) == (quality, 4, 4, 50, 100)
    for k, v in options.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the options {options}")
    pic = (ctypes.c_uint8 * _WEBP_PICTURE_BYTES)()
    if not lib.WebPPictureInitInternal(pic, WEBP_ENCODER_ABI):
        raise RuntimeError("WebPPictureInitInternal refused the ABI version")
    h, w = img.shape[:2]
    struct.pack_into("<ii", pic, 8, w, h)
    rgb = np.ascontiguousarray(img, np.uint8)
    writer = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not lib.WebPPictureImportRGB(pic, rgb.ctypes.data_as(ctypes.c_void_p), 3 * w):
            raise RuntimeError("WebPPictureImportRGB failed")
        struct.pack_into("<QQ", pic, 96, ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value,
                         ctypes.addressof(writer))
        if not lib.WebPEncode(ctypes.byref(cfg), pic):
            raise RuntimeError(f"WebPEncode failed: error {struct.unpack_from('<i', pic, 136)[0]}")
        data = ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPMemoryWriterClear(ctypes.byref(writer))
        lib.WebPPictureFree(pic)
    if vp8_header(data)["partitions"] != 1 << cfg.partitions:
        raise ValueError(f"libwebp wrote {vp8_header(data)['partitions']} token partitions, not "
                         f"{1 << cfg.partitions}: it writes one at methods 3-6")
    return data


def vp8_header(data: bytes) -> dict:
    """A WebP file's VP8 key-frame header as far as its token partitions:
    {"segments": segmentation on, "partitions": the count (1, 2, 4 or 8),
    "mb_rows": macroblock rows}."""
    _kind, frame = webp_bitstream(data)
    size0 = (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5
    br = _BoolDecoder(frame[10:10 + size0])
    br.value_bits(2)
    segments = br.value_bits(1)
    if segments:
        update_map = br.value_bits(1)
        if br.value_bits(1):
            br.value_bits(1)
            for n in (7, 7, 7, 7, 6, 6, 6, 6):
                if br.value_bits(1):
                    br.value_bits(n + 1)
        if update_map:
            for _ in range(3):
                if br.value_bits(1):
                    br.value_bits(8)
    br.value_bits(10)  # filter type, level, sharpness
    if br.value_bits(1) and br.value_bits(1):
        for _ in range(8):
            if br.value_bits(1):
                br.value_bits(7)
    h = (frame[8] | frame[9] << 8) & 0x3FFF
    return {"segments": segments, "partitions": 1 << br.value_bits(2), "mb_rows": (h + 15) >> 4}


class _OpjPoc(ctypes.Structure):
    """OpenJPEG 2.5's ``opj_poc_t`` (openjpeg.h)."""
    _fields_ = ([(n, ctypes.c_uint32) for n in "resno0 compno0 layno1 resno1 compno1 layno0 precno0 precno1".split()]
                + [("prg1", ctypes.c_int), ("prg", ctypes.c_int), ("progorder", ctypes.c_char * 5),
                   ("tile", ctypes.c_uint32)] + [(n, ctypes.c_int32) for n in "tx0 tx1 ty0 ty1".split()]
                + [(n, ctypes.c_uint32) for n in ("layS resS compS prcS layE resE compE prcE txS txE tyS tyE dx dy "
                                                  "lay_t res_t comp_t prc_t tx0_t ty0_t").split()])


def _ints(names: str):
    return [(n, ctypes.c_int) for n in names.split()]


class OpjCParameters(ctypes.Structure):
    """OpenJPEG 2.5's ``opj_cparameters_t`` (openjpeg.h, JPWL's 16-entry
    arrays included); :func:`_libopenjp2` holds its size to the bytes
    ``opj_set_default_encoder_parameters`` clears."""
    _fields_ = (_ints("tile_size_on cp_tx0 cp_ty0 cp_tdx cp_tdy cp_disto_alloc cp_fixed_alloc cp_fixed_quality")
                + [("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p), ("csty", ctypes.c_int),
                   ("prog_order", ctypes.c_int), ("POC", _OpjPoc * 32), ("numpocs", ctypes.c_uint32),
                   ("tcp_numlayers", ctypes.c_int), ("tcp_rates", ctypes.c_float * 100),
                   ("tcp_distoratio", ctypes.c_float * 100)]
                + _ints("numresolution cblockw_init cblockh_init mode irreversible roi_compno roi_shift res_spec")
                + [("prcw_init", ctypes.c_int * 33), ("prch_init", ctypes.c_int * 33), ("infile", ctypes.c_char * 4096),
                   ("outfile", ctypes.c_char * 4096), ("index_on", ctypes.c_int), ("index", ctypes.c_char * 4096)]
                + _ints("image_offset_x0 image_offset_y0 subsampling_dx subsampling_dy decod_format cod_format "
                        "jpwl_epc_on jpwl_hprot_MH")
                + [(n, ctypes.c_int * 16) for n in ("jpwl_hprot_TPH_tileno jpwl_hprot_TPH jpwl_pprot_tileno "
                                                    "jpwl_pprot_packno jpwl_pprot").split()]
                + _ints("jpwl_sens_size jpwl_sens_addr jpwl_sens_range jpwl_sens_MH")
                + [("jpwl_sens_TPH_tileno", ctypes.c_int * 16), ("jpwl_sens_TPH", ctypes.c_int * 16)]
                + _ints("cp_cinema max_comp_size cp_rsiz")
                + [("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
                   ("jpip_on", ctypes.c_int), ("mct_data", ctypes.c_void_p), ("max_cs_size", ctypes.c_int),
                   ("rsiz", ctypes.c_uint16)])


class _OpjCmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in "dx dy w h x0 y0 prec bpp sgnd".split()]


class _OpjComp(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in "dx dy w h x0 y0 prec bpp sgnd resno_decoded factor".split()]
                + [("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)])


class _OpjImage(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in "x0 y0 x1 y1 numcomps".split()]
                + [("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_OpjComp)), ("icc", ctypes.c_void_p),
                   ("icc_len", ctypes.c_uint32)])


OPJ_PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


@functools.cache
def _libopenjp2() -> ctypes.CDLL:
    lib = pillow_lib("openjp2")
    # the known-good default: opj_set_default_encoder_parameters clears the
    # whole struct first, so the bytes it touches are sizeof(opj_cparameters_t)
    probe = (ctypes.c_uint8 * 65536)(*([0xAB] * 65536))
    lib.opj_set_default_encoder_parameters(probe)
    size = max(i for i, b in enumerate(bytes(probe)) if b != 0xAB) + 1
    if size != ctypes.sizeof(OpjCParameters):
        raise RuntimeError(f"opj_cparameters_t is {size} bytes in this OpenJPEG, "
                           f"{ctypes.sizeof(OpjCParameters)} in the writer's layout")
    P = ctypes.c_void_p
    lib.opj_image_create.restype = ctypes.POINTER(_OpjImage)
    lib.opj_create_compress.restype = P
    lib.opj_stream_create_default_file_stream.restype = P
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.opj_setup_encoder.argtypes = [P, P, P]
    lib.opj_start_compress.argtypes = [P, P, P]
    lib.opj_encode.argtypes = [P, P]
    lib.opj_end_compress.argtypes = [P, P]
    for f in ("opj_destroy_codec", "opj_stream_destroy", "opj_image_destroy"):
        getattr(lib, f).argtypes = [P]
    return lib


def jp2_openjpeg(img, jp2=True, rates=(0,), irreversible=False, mct=None, tile=None, tp_flag=None, progression="LRCP",
                 poc=(), **params) -> bytes:
    """A JPEG 2000 file (JP2, or a raw codestream with ``jp2=False``) of an
    (H, W) or (H, W, 3) uint8 frame, written by OpenJPEG's encoder:
    ``rates`` one compression ratio a quality layer (0 = lossless),
    ``tile`` = (h, w), ``tp_flag`` "R", "L" or "C" (tile-parts split by
    resolution, layer or component), ``poc`` = (tile, resno0, compno0,
    layno1, resno1, compno1, progression) records, and any other
    ``opj_cparameters_t`` field by name (``mode``: the code-block style bits;
    ``roi_compno``/``roi_shift``; ``csty``: 2 SOP, 4 EPH; ``numresolution``;
    ``cblockw_init``, ...)."""
    lib = _libopenjp2()
    p = OpjCParameters()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    assert (p.numresolution, p.cblockw_init, p.roi_compno, p.subsampling_dx, p.decod_format) == (6, 64, -1, 1, -1)
    p.tcp_numlayers, p.cp_disto_alloc = len(rates), 1
    for i, r in enumerate(rates):
        p.tcp_rates[i] = r
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    p.irreversible = int(irreversible)
    p.tcp_mct = bytes([int(c == 3 if mct is None else mct)])
    p.prog_order = OPJ_PROGRESSIONS[progression]
    if tile:
        p.tile_size_on, p.cp_tdy, p.cp_tdx = 1, tile[0], tile[1]
    if tp_flag:
        p.tp_on, p.tp_flag = b"\x01", tp_flag.encode()
    p.numpocs = len(poc)
    for rec, (t, r0, c0, l1, r1, c1, prg) in zip(p.POC, poc):
        rec.tile, rec.resno0, rec.compno0, rec.layno1, rec.resno1, rec.compno1 = t, r0, c0, l1, r1, c1
        rec.prg1 = OPJ_PROGRESSIONS[prg]
    for k, v in params.items():
        setattr(p, k, v)
    parms = (_OpjCmptParm * c)()
    for q in parms:
        q.dx = q.dy = 1
        q.w, q.h, q.prec = w, h, 8
    image = lib.opj_image_create(c, parms, 1 if c == 3 else 2)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    try:
        im = image.contents
        im.x1, im.y1 = w, h
        for i, plane in enumerate(np.asarray(img).reshape(h, w, c).transpose(2, 0, 1)):
            plane = np.ascontiguousarray(plane, np.int32)
            ctypes.memmove(im.comps[i].data, plane.ctypes.data, plane.nbytes)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out").encode()
            if not lib.opj_setup_encoder(codec, ctypes.byref(p), image):
                raise ValueError(f"OpenJPEG refuses the parameters {params}")
            stream = lib.opj_stream_create_default_file_stream(path, 0)
            ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
                  and lib.opj_end_compress(codec, stream))
            lib.opj_stream_destroy(stream)
            if not ok:
                raise RuntimeError("OpenJPEG's encoder failed")
            with open(path, "rb") as fh:
                return fh.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)


def j2k_markers(data: bytes) -> list:
    """(header, marker, segment body) of every marker segment in the main
    header ("main") and the tile-part headers ("tile"), and ("tile", SOT
    marker, body) for each tile-part, of a JP2 file or raw codestream."""
    pos = data.find(b"\xff\x4f\xff\x51")
    out, pos, where = [], pos + 2, "main"
    while pos + 4 <= len(data):
        marker, length = struct.unpack(">HH", data[pos:pos + 4])
        if marker == 0xFFD9:
            break
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xFF90:  # SOT: Isot, Psot, TPsot, TNsot
            where = "tile"
            out.append((where, marker, body))
            _isot, psot = struct.unpack(">HI", body[:6])
            tile_part_end = pos + psot
            pos += 2 + length
            while True:  # the tile-part header up to SOD
                m, n = struct.unpack(">HH", data[pos:pos + 4])
                if m == 0xFF93:
                    break
                out.append((where, m, data[pos + 4:pos + 2 + n]))
                pos += 2 + n
            pos = tile_part_end
            continue
        out.append((where, marker, body))
        pos += 2 + length
    return out


def libjpeg_lossless(img, predictor: int, pt: int = 0, arith: bool = False, restart_rows: int = 0):
    """libjpeg-turbo's lossless JPEG (``jpeg_enable_lossless``) of an (H, W)
    or (H, W, 3) uint8 frame, in RGB or grey, Huffman (SOF3) or with
    ``arith`` arithmetic coding (SOF11), in a child process: libjpeg's error
    handler exits. → (the file or None, the child's error text)."""
    import subprocess

    img = np.ascontiguousarray(img, np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.npy"), os.path.join(tmp, "out.jpg")
        np.save(src, img)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--libjpeg-lossless", src, out,
                               str(predictor), str(pt), str(int(arith)), str(restart_rows)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode:
            return None, proc.stderr.strip()
        with open(out, "rb") as fh:
            return fh.read(), ""


LIBJPEG_COMPRESS_BYTES = 520  # sizeof(struct jpeg_compress_struct) of libjpeg-turbo's 6.2 ABI on x86-64


def _libjpeg_lossless_child(src, out, predictor, pt, arith, restart_rows) -> None:
    """``libjpeg_lossless``'s child: jpeg_CreateCompress (the library checks
    the struct's size), jpeg_mem_dest, jpeg_set_defaults,
    jpeg_set_colorspace (no colour transform, as lossless needs),
    ``arith_code``, jpeg_enable_lossless, ``restart_in_rows``, one
    jpeg_write_scanlines."""
    img = np.load(src)
    h, w = img.shape[:2]
    comps = 1 if img.ndim == 2 else img.shape[2]
    lib = pillow_lib("jpeg")
    lib.jpeg_std_error.restype = ctypes.c_void_p
    err = (ctypes.c_uint8 * 1024)()
    cinfo = (ctypes.c_uint8 * LIBJPEG_COMPRESS_BYTES)()
    struct.pack_into("<Q", cinfo, 0, lib.jpeg_std_error(err))
    lib.jpeg_CreateCompress(cinfo, 62, ctypes.c_size_t(LIBJPEG_COMPRESS_BYTES))
    buf, size = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_ulong(0)
    lib.jpeg_mem_dest(cinfo, ctypes.byref(buf), ctypes.byref(size))
    space = 2 if comps == 3 else 1  # JCS_RGB, JCS_GRAYSCALE
    struct.pack_into("<IIii", cinfo, 48, w, h, comps, space)  # image_width, image_height, input_components, in_color_space
    lib.jpeg_set_defaults(cinfo)
    assert struct.unpack_from("<ii", cinfo, 72) == (8, comps), "jpeg_compress_struct laid out otherwise"
    lib.jpeg_set_colorspace(cinfo, space)
    struct.pack_into("<i", cinfo, 260, int(arith))  # arith_code
    struct.pack_into("<i", cinfo, 284, restart_rows)  # restart_in_rows
    lib.jpeg_enable_lossless(cinfo, predictor, pt)
    lib.jpeg_start_compress(cinfo, 1)
    rows = (ctypes.POINTER(ctypes.c_uint8) * h)(*[img[y].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                                                 for y in range(h)])
    lib.jpeg_write_scanlines(cinfo, rows, h)
    lib.jpeg_finish_compress(cinfo)
    data = ctypes.string_at(buf, size.value)
    lib.jpeg_destroy_compress(cinfo)
    with open(out, "wb") as fh:
        fh.write(data)


def sof11_frame(data: bytes) -> bytes:
    """A lossless Huffman JPEG's frame relabelled SOF11 (lossless,
    arithmetic) and its DHT dropped: the header a SOF11 file starts with,
    for the readers' refusals (no writer here codes SOF11's arithmetic
    data: libjpeg-turbo's lossless compressor refuses ``arith_code``)."""
    out, pos = data[:2], 2
    while pos < len(data):
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + length]
        if marker == 0xC3:
            out += b"\xff\xcb" + seg[2:]
        elif marker != 0xC4:
            out += seg
        pos += 2 + length
        if marker == 0xDA:
            return out + data[pos:]
    raise ValueError("no SOS")


# libwebp writes one token partition at methods 3-6 (its token loop), so
# these files are written at methods 0-2
WEBP_PARTS_FILES = {
    "webp_parts2_seg1.webp": ("WebP lossy, 2 token partitions, 1 segment, method 2", lambda: webp_libwebp(
        _img(110, 45, 61), 80.0, partitions=1, segments=1, method=2)),
    "webp_parts4.webp": ("WebP lossy, 4 token partitions, 4 segments, method 2", lambda: webp_libwebp(
        _img(111, 67, 53), 75.0, partitions=2, method=2)),
    "webp_parts8_sns90.webp": ("WebP lossy, 8 token partitions, SNS 90, method 1", lambda: webp_libwebp(
        _img(112, 70, 70), 60.0, partitions=3, sns_strength=90, method=1)),
    "webp_parts8_2rows.webp": ("WebP lossy, 8 token partitions over 2 macroblock rows", lambda: webp_libwebp(
        _img(113, 24, 67), 70.0, partitions=3, segments=2, method=2)),
    "webp_parts4_q20_seg3.webp": ("WebP lossy q20, 4 token partitions, 3 segments, SNS 0, method 0", lambda: webp_libwebp(
        _img(114, 50, 39), 20.0, partitions=2, segments=3, sns_strength=0, method=0)),
    "webp_parts2_q95.webp": ("WebP lossy q95, 2 token partitions, method 1", lambda: webp_libwebp(
        _img(115, 33, 47), 95.0, partitions=1, method=1)),
    "webp_parts8_vp8x.webp": ("WebP VP8X-wrapped, 8 token partitions", lambda: webp_extended(
        (41, 36), [webp_chunk(b"VP8 ", webp_bitstream(webp_libwebp(_img(116, 36, 41), 85.0, partitions=3,
                                                                   method=2))[1])])),
    "webp_parts4_sharp.webp": ("WebP lossy, 4 token partitions, sharp YUV, simple filter", lambda: webp_libwebp(
        _img(117, 29, 58), 85.0, partitions=2, use_sharp_yuv=1, filter_type=0, filter_strength=40, method=2)),
}
# the code-block styles (T.800 Table A.19): each bit alone, then all six
JP2_CBLK_STYLES = {1: "bypass", 2: "reset", 4: "termall", 8: "vertically causal", 16: "predictable termination",
                   32: "segmentation symbols"}
JP2_MODE_FILES = {
    **{f"jp2_mode{m}_97.jp2": (f"JPEG 2000 9/7, 3 layers, code-block style {name}", (lambda m: lambda: jp2_openjpeg(
        _img(120 + i, 47, 53), irreversible=True, rates=(40, 12, 3), mode=m))(m))
       for i, (m, name) in enumerate(JP2_CBLK_STYLES.items())},
    "jp2_mode63_97.jp2": ("JPEG 2000 9/7, 3 layers, all six code-block styles", lambda: jp2_openjpeg(
        _img(126, 58, 49), irreversible=True, rates=(30, 8, 2), mode=63)),
    "jp2_mode63_53.jp2": ("JPEG 2000 5/3 lossless, 2 layers, all six code-block styles, 16x16 code-blocks",
                          lambda: jp2_openjpeg(_img(127, 45, 39), rates=(10, 0), mode=63, cblockw_init=16,
                                               cblockh_init=16)),
    "jp2_roi_97.jp2": ("JPEG 2000 9/7, ROI max-shift 7 on component 0", lambda: jp2_openjpeg(
        _img(128, 43, 51), irreversible=True, rates=(25, 5), roi_compno=0, roi_shift=7)),
    "jp2_roi_53.jp2": ("JPEG 2000 5/3, ROI max-shift 4 on component 2", lambda: jp2_openjpeg(
        _img(129, 38, 40), roi_compno=2, roi_shift=4)),
    "jp2_poc.jp2": ("JPEG 2000 5/3, 3 layers, two POC records (RLCP then CPRL)", lambda: jp2_openjpeg(
        _img(130, 52, 44), rates=(20, 5, 0), poc=[(1, 0, 0, 2, 3, 3, "RLCP"), (1, 0, 0, 3, 6, 3, "CPRL")])),
    "jp2_sop_eph.jp2": ("JPEG 2000 9/7, 3 layers, SOP and EPH markers", lambda: jp2_openjpeg(
        _img(131, 41, 57), irreversible=True, rates=(30, 8, 2), csty=6)),
    "jp2_tp_res.jp2": ("JPEG 2000 5/3, 32x32 tiles, tile-parts by resolution", lambda: jp2_openjpeg(
        _img(132, 57, 63), tile=(32, 32), tp_flag="R", numresolution=4)),
    "jp2_tp_layer.jp2": ("JPEG 2000 9/7, 3 layers, 32x32 tiles, tile-parts by layer", lambda: jp2_openjpeg(
        _img(133, 50, 61), irreversible=True, rates=(30, 8, 2), tile=(32, 32), tp_flag="L", numresolution=4)),
    "jp2_tp_comp.jp2": ("JPEG 2000 5/3, 24x40 tiles, tile-parts by component", lambda: jp2_openjpeg(
        _img(134, 53, 66), tile=(24, 40), tp_flag="C", numresolution=3)),
    **{f"jp2_tp_{prog.lower()}.jp2": (f"JPEG 2000 9/7 {prog}, 2 layers, 32x32 tiles, tile-parts by resolution",
                                      (lambda prog, i: lambda: jp2_openjpeg(
                                          _img(135 + i, 61, 67), irreversible=True, rates=(20, 4), tile=(32, 32),
                                          tp_flag="R", numresolution=4, progression=prog))(prog, i))
       for i, prog in enumerate(OPJ_PROGRESSIONS)},
}
WEBP_PARTS_JP2_TIMING_FILES = {
    "timing_webp_parts4.webp": ("WebP lossy q50, 4 token partitions", lambda: webp_libwebp(
        _img(97, 720, 1280), 50.0, partitions=2, method=2)),
    "timing_jp2_mode63.jp2": ("JPEG 2000 9/7 rate 40, all six code-block styles", lambda: jp2_openjpeg(
        _smooth(0, 720, 1280), irreversible=True, rates=(40,), mode=63)),
}
WEBP_PARTS_JP2_MANIFEST = "manifest_webp_parts_jp2_modes.json"


def write_webp_parts_jp2_fixtures(images_dir: str) -> None:
    """Phase 24a's files (``WEBP_PARTS_FILES``, ``JP2_MODE_FILES``,
    ``WEBP_PARTS_JP2_TIMING_FILES``) and their manifest of cv2's pixels."""
    files = {**WEBP_PARTS_FILES, **JP2_MODE_FILES, **WEBP_PARTS_JP2_TIMING_FILES}
    for name, (_kind, make) in files.items():
        with open(os.path.join(images_dir, name), "wb") as fh:
            fh.write(make())
    with open(os.path.join(images_dir, WEBP_PARTS_JP2_MANIFEST), "w") as fh:
        json.dump(image_manifest(images_dir, files), fh, indent=1)


WEBP_TREE_QUALITY, WEBP_TREE_PARTITIONS = 20.0, 2  # phase 24b's frames: libwebp q20, 4 token partitions, method 2


def write_webp_parts_tree(root: str) -> dict:
    """Phase 24b's tree and record: phase 19c's GOT-10k val sequences (made
    here as phase 19b makes them) with each JPEG frame decoded and written
    by libwebp at ``WEBP_TREE_QUALITY`` with 4 token partitions under its
    ``.jpg`` name; ``record.json`` holds each file's sha256 and the port's
    OPE result and boxes over the tree on this host's CPU (``FEARTracker``
    FEAR-XS, float32, one torch thread)."""
    import shutil

    import torch

    from feartracker_tpu_torch.data.sequence import GOT10kDataset

    torch.set_num_threads(1)  # as the test that holds this record runs
    shutil.rmtree(root, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        jpeg_root = chip_smoke.host_ope_tree(tmp)
        chip_smoke._rewrite_tree(jpeg_root, root, lambda img: webp_libwebp(
            img, WEBP_TREE_QUALITY, partitions=WEBP_TREE_PARTITIONS, method=2))
    files = tree_files(root)
    ds = GOT10kDataset(root, "val")
    with torch.inference_mode():
        ao, boxes = ope_boxes(chip_smoke._fear_tracker("cpu", torch.float32), ds)
    record = {"seed": chip_smoke.HOST_OPE_SEED, "frame_hw": list(chip_smoke.HOSTAUG_FRAME_HW),
              "quality": WEBP_TREE_QUALITY, "partitions": 1 << WEBP_TREE_PARTITIONS,
              "bytes": sum(os.path.getsize(os.path.join(root, f)) for f in files),
              "lengths": [len(ds[i][0]) for i in range(len(ds))], "files": files,
              "ope_cpu": json.loads(json.dumps(ao)), "boxes_cpu": boxes}
    with open(os.path.join(root, chip_smoke.WEBP_TREE_RECORD), "w") as fh:
        json.dump(record, fh, indent=1)
    return record


def image_manifest(images_dir: str, files=None) -> dict:
    """cv2's pixels of every file in ``images_dir`` that ``files`` (default
    ``IMAGE_FILES``) names."""
    rows = []
    for name, (kind, _) in (IMAGE_FILES if files is None else files).items():
        img = cv2.imread(os.path.join(images_dir, name))
        assert img is not None, name
        img = np.ascontiguousarray(img[..., ::-1])
        rows.append({"file": name, "kind": kind, "shape": list(img.shape), "sha256": chip_smoke._sha(img.tobytes())})
    return {"decode": rows}


def manifest(jpeg_dir: str) -> dict:
    """cv2's bytes for every fixture: its decodes of the files in
    ``jpeg_dir`` and its encodes of the seeded frames."""
    decode = []
    for name, (kind, *_rest) in DECODE_FILES.items():
        img = cv2.imread(os.path.join(jpeg_dir, name))[..., ::-1]
        decode.append({"file": name, "kind": kind, "shape": list(img.shape),
                       "sha256": chip_smoke._sha(np.ascontiguousarray(img).tobytes())})
    encode = []
    for seed, h, w, q, gray in chip_smoke.ENCODE_CASES:
        img = chip_smoke.fixture_frame(seed, h, w, gray)
        data = cv2.imencode(".jpg", img if gray else img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])[1]
        encode.append({"seed": seed, "h": h, "w": w, "quality": q, "gray": gray, "sha256": chip_smoke._sha(data)})
    return {"decode": decode, "encode": encode}


def jax_item_digests() -> list:
    from feartracker_tpu.data import augmentations
    from feartracker_tpu.data.dataset import SiameseTrackingDataset

    with tempfile.TemporaryDirectory() as root:
        return chip_smoke.forced_item_digests(SiameseTrackingDataset, augmentations, root)


def write_format_fixtures(images_dir: str) -> None:
    """Phase 21's files (``FORMAT_FILES``, ``TIMING_FILES``) and their
    manifest of cv2's pixels."""
    files = {**FORMAT_FILES, **TIMING_FILES}
    for name, (_kind, make) in files.items():
        with open(os.path.join(images_dir, name), "wb") as fh:
            fh.write(make())
    with open(os.path.join(images_dir, FORMAT_MANIFEST), "w") as fh:
        json.dump(image_manifest(images_dir, files), fh, indent=1)


def main():
    jpeg_dir = os.path.join(HERE, *chip_smoke.JPEG_FIXTURES[2:])
    os.makedirs(jpeg_dir, exist_ok=True)
    for name, (_kind, *args) in DECODE_FILES.items():
        with open(os.path.join(jpeg_dir, name), "wb") as fh:
            fh.write(cv2_file(*args))
    with open(os.path.join(jpeg_dir, "manifest.json"), "w") as fh:
        json.dump(manifest(jpeg_dir), fh, indent=1)
    with open(os.path.join(REPO, *chip_smoke.HOST_ITEMS), "w") as fh:
        json.dump({"items": jax_item_digests()}, fh, indent=1)
    images_dir = os.path.join(REPO, *IMAGES_DIR)
    os.makedirs(images_dir, exist_ok=True)
    for name, (_kind, make) in IMAGE_FILES.items():
        with open(os.path.join(images_dir, name), "wb") as fh:
            fh.write(make())
    with open(os.path.join(images_dir, "manifest.json"), "w") as fh:
        json.dump(image_manifest(images_dir), fh, indent=1)
    write_format_fixtures(images_dir)
    write_jp2_fixtures(images_dir)
    write_jp2_tree(os.path.join(REPO, *chip_smoke.JP2_TREE))
    write_fax_cmyk_fixtures(images_dir)
    write_tiff_ope_record(os.path.join(REPO, *chip_smoke.TIFF_OPE_RECORD))
    write_webp_parts_jp2_fixtures(images_dir)
    write_webp_parts_tree(os.path.join(REPO, *chip_smoke.WEBP_TREE))
    print(f"wrote {len(DECODE_FILES)} JPEGs, the manifest, {chip_smoke.HOST_ITEM_COUNT} item digests and "
          f"{len(IMAGE_FILES)} image fixtures")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--libjpeg-lossless"]:
        _libjpeg_lossless_child(sys.argv[2], sys.argv[3], *map(int, sys.argv[4:8]))
    else:
        main()
