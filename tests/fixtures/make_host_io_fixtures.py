"""Write the fixtures of ``chip_smoke.py``'s phases 19 and 20 with cv2
(OpenCV 5.0) and PIL, on a host that has them:

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
  (RGB bytes) of each.

    python tests/fixtures/make_host_io_fixtures.py

The writers below (``png``, ``bmp``, ``pnm``, ``jpeg_baseline``,
``keep_scans``) make files of every kind those fixtures hold; the oracle is
cv2's decode of them, not the writers. ``tests/test_torch_jpeg.py``,
``tests/test_torch_image_formats.py`` and ``tests/test_torch_host_augs.py``
hold the committed files to what cv2 and the port give.
"""

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


def jpeg_baseline(planes, sampling, adobe=None, jfif=False):
    """A baseline JPEG of ``planes`` (one uint8 plane a component, each at
    its own sampling) with sampling factors ``sampling`` [(h, v), ...]: one
    interleaved scan, the standard luma quantization and Huffman tables for
    every component, an optional JFIF APP0 and Adobe APP14 (``adobe`` = its
    transform). A float DCT: the oracle is cv2's decode, not this writer."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    H, W = next(p.shape for p, s in zip(planes, sampling) if s == (hmax, vmax))
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    dc, ac = _huffman_codes(DC_BITS, range(12)), _huffman_codes(AC_BITS, AC_VALS)
    coefs = []
    for p, (h, v) in zip(planes, sampling):
        pad = np.pad(p.astype(np.float64), ((0, mcuy * v * 8 - p.shape[0]), (0, mcux * h * 8 - p.shape[1])),
                     mode="edge") - 128
        blocks = pad.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3)
        coefs.append(np.round(np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT) / STD_LUMA_Q.reshape(8, 8)).astype(int))
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


def image_manifest(images_dir: str) -> dict:
    """cv2's pixels of every file in ``images_dir`` that ``IMAGE_FILES`` names."""
    rows = []
    for name, (kind, _) in IMAGE_FILES.items():
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
    print(f"wrote {len(DECODE_FILES)} JPEGs, the manifest, {chip_smoke.HOST_ITEM_COUNT} item digests and "
          f"{len(IMAGE_FILES)} image fixtures")


if __name__ == "__main__":
    main()
