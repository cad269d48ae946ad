"""The port's frame reader (``data/imread.py`` through
``data/dataset.py:read_img``) against the JAX package's ``read_img``, which
is ``cv2.imread`` (OpenCV 5.0) + BGR→RGB: byte for byte on seeded PNG (every
colour type and bit depth, Adam7, ``tRNS``, ``eXIf``, bad CRCs), BMP (1-32
bits, RLE4/RLE8 with their end-of-line, delta and end-of-bitmap codes,
top-down, OS/2), PNM (P1-P6, maxval above 255) and JPEG (CMYK, YCCK,
sampling factors up to 4, progressive files with scans removed, which
libjpeg block-smooths) files written by the fixture script's writers;
TIFF, WebP and GIF as cv2 and PIL write them; arithmetic-coded and
lossless JPEGs, and real files of the JPEG modes cv2 refuses; formats cv2
reads and the port does not raise ``IOError`` naming them;
``make_annotations.frame_shape`` against JAX's ``_frame_shape``; the
committed fixtures of ``chip_smoke.py`` phase 20a against their manifest."""

import io
import json
import os
import struct
import sys

import numpy as np
import pytest

from feartracker_tpu.data.dataset import read_img as jax_read_img
from feartracker_tpu_torch.data import imread as port_imread
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.tools.make_annotations import frame_shape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests", "fixtures"))
import make_host_io_fixtures as W  # noqa: E402  (the writers; imports cv2 and chip_smoke)

cv2 = W.cv2


def _same(tmp_path, data: bytes, name: str = "frame.img"):
    """The port's and JAX's read of one file: equal arrays, or both raise."""
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    try:
        want = jax_read_img(path)
    except IOError:
        with pytest.raises(IOError):
            read_img(path)
        return None
    got = read_img(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    return got


# -- PNG --------------------------------------------------------------------------

PNG_CASES = [(ct, d, il) for ct, depths in port_imread.PNG_DEPTHS.items() for d in depths for il in (False, True)]


@pytest.mark.parametrize("color_type,depth,interlace", PNG_CASES,
                         ids=[f"type{ct}-{d}bit{'-adam7' if il else ''}" for ct, d, il in PNG_CASES])
def test_png_colour_types_depths_and_adam7(tmp_path, color_type, depth, interlace):
    rng = np.random.RandomState(color_type * 100 + depth + 7 * interlace)
    channels = port_imread.PNG_CHANNELS[color_type]
    for h, w in ((1, 1), (5, 3), (11, 19)):
        s = rng.randint(0, 2 ** depth, (h, w, channels))
        kw = {}
        if color_type == 3:
            kw["palette"] = rng.randint(0, 256, (rng.randint(1, 2 ** depth + 1), 3))  # indices past it read black
            kw["trns"] = bytes(rng.randint(0, 256, len(kw["palette"])).astype(np.uint8))
        elif color_type in (0, 2):
            kw["trns"] = struct.pack(">" + "H" * channels, *map(int, s[0, 0]))
        if rng.rand() < 0.5:
            kw["exif"] = W.tiff_orientation(int(rng.randint(1, 9)), bool(rng.randint(2)))
        _same(tmp_path, W.png(s, color_type, depth, interlace=interlace, idat_split=rng.randint(1, 4), **kw))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation(tmp_path, orientation):
    img = W._img(orientation, 9, 14)
    got = _same(tmp_path, W.png(img, 2, 8, exif=W.tiff_orientation(orientation, orientation % 2 == 0)))
    assert got.shape[:2] == ((14, 9) if orientation >= 5 else (9, 14))


@pytest.mark.parametrize("chunk", [b"IHDR", b"PLTE", b"IDAT", b"IEND", b"eXIf", b"tEXt", b"gAMA"])
def test_png_bad_crc(tmp_path, chunk):
    """A bad CRC on IHDR, PLTE or IDAT fails both readers; one on IEND is
    ignored; one on an ancillary chunk drops the chunk (the eXIf orientation
    then does not apply)."""
    idx = np.random.RandomState(3).randint(0, 4, (6, 7))
    extra = [(b"tEXt", b"k\0v"), (b"gAMA", struct.pack(">I", 45455))]
    data = W.png(idx, 3, 2, palette=W._pal(3, 4), exif=W.tiff_orientation(6), extra=extra, bad_crc=chunk)
    got = _same(tmp_path, data)
    assert (got is None) == (chunk in (b"IHDR", b"PLTE", b"IDAT"))


def test_png_damaged_streams_raise(tmp_path):
    img = W._img(5, 8, 8)
    good = W.png(img, 2, 8)
    at = good.index(b"IDAT")
    (n,) = struct.unpack(">I", good[at - 4:at])
    short = W.png_chunk(b"IDAT", good[at + 4:at + 4 + n][:-20])
    unknown = good[:at - 4] + W.png_chunk(b"ABCD", b"xyz") + good[at - 4:]
    for bad in (good[:at - 4] + short + good[at + 8 + n:], good[:40], good[:-12], unknown,
                W.png(img, 2, 8, filters=(5,))):
        assert _same(tmp_path, bad) is None
    with pytest.raises(ValueError, match="filter"):
        port_imread.imread(W.png(img, 2, 8, filters=(5,)))


# -- BMP ----------------------------------------------------------------------------

BMP_CASES = ["24", "24 top-down", "32", "32 BITFIELDS", "15", "555 BITFIELDS", "565 BITFIELDS", "565 V5 header",
             "1", "4", "8", "4 short palette", "8 short palette", "8 top-down", "OS/2 1", "OS/2 8", "OS/2 24",
             "24 gap before the pixels"]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_variants(tmp_path, case):
    rng = np.random.RandomState(len(case) * 31 + sum(map(ord, case)))
    for h, w in ((1, 1), (5, 3), (9, 17)):
        img = rng.randint(0, 256, (h, w, 3))
        bits = int(case.split()[-1]) if case.startswith("OS/2") else int(case.split()[0])
        if bits <= 8:
            n = 2 ** bits // (2 if "short" in case else 1)
            kw = dict(palette=rng.randint(0, 256, (n, 3)), indices=rng.randint(0, 2 ** bits, (h, w)))
            data = W.bmp(None, bits, top_down="top-down" in case, header=12 if "OS/2" in case else 40, **kw)
        elif bits == 565:
            data = W.bmp(img, 16, comp=3, masks=(0xF800, 0x7E0, 0x1F), header=124 if "V5" in case else 40)
        elif bits == 555:
            data = W.bmp(img, 15, comp=3, masks=(0x7C00, 0x3E0, 0x1F))
        elif bits == 32 and "BITFIELDS" in case:
            data = W.bmp(img, 32, comp=3, masks=(0xFF0000, 0xFF00, 0xFF))
        else:
            data = W.bmp(img, bits, top_down="top-down" in case, header=12 if "OS/2" in case else 40,
                         gap=7 if "gap" in case else 0)
        assert _same(tmp_path, data) is not None


RLE_H, RLE_W = 6, 10
RLE8_CASES = {
    "runs and end of line": b"".join(bytes([4, 3, 6, 5, 0, 0]) for _ in range(RLE_H)) + b"\0\1",
    "end of bitmap early": bytes([4, 3, 6, 5, 0, 0, 2, 7]) + b"\0\1",
    "delta": bytes([2, 7, 0, 2, 3, 2, 4, 8]) + b"\0\1",
    "delta past the line end": bytes([2, 7, 0, 2, 9, 1, 4, 8]) + b"\0\1",
    "blank lines": b"\0\0" + bytes([10, 4]) + b"\0\0" + bytes([10, 5]) + b"\0\1",
    "literals": bytes([0, 5, 1, 2, 3, 4, 5, 0, 5, 6]) + b"\0\0" + bytes([0, 10]) + bytes(range(10, 20)) + b"\0\1",
    "full rows without end of line": b"".join(bytes([10, 3 + i]) for i in range(RLE_H)) + b"\0\1",
    "full rows with end of line": b"".join(bytes([10, 3 + i, 0, 0]) for i in range(RLE_H)) + b"\0\1",
    "run past the line (fails)": bytes([11, 3]) + b"\0\1",
    "no end of bitmap (fails)": b"".join(bytes([10, 3]) for _ in range(3)),
}
RLE4_CASES = {
    "runs and end of line": b"".join(bytes([4, 0x3A, 6, 0x5F, 0, 0]) for _ in range(RLE_H)) + b"\0\1",
    "end of bitmap ends its line only": b"".join(bytes([3, 0x9A]) + b"\0\1" for _ in range(RLE_H)),
    "end of bitmap early (fails)": bytes([4, 0x31, 6, 0x52, 0, 0, 2, 0x77]) + b"\0\1",
    "delta moves along the line only": bytes([2, 0x71, 0, 2, 3, 2, 4, 0x82]) + b"\0\0"
    + b"".join(bytes([5, 0x12, 0, 0]) for _ in range(RLE_H - 1)),
    "literals": bytes([0, 5, 0x12, 0x34, 0x50, 0, 5, 0x66]) + b"\0\0" + bytes([0, 10, 0x12, 0x34, 0x56, 0x78, 0x9A, 0])
    + b"\0\0" * 5,
    "full rows without end of line (fails)": b"".join(bytes([10, 0x31 + i]) for i in range(RLE_H)) + b"\0\1",
}


@pytest.mark.parametrize("bits,case", [(8, c) for c in RLE8_CASES] + [(4, c) for c in RLE4_CASES])
def test_bmp_rle(tmp_path, bits, case):
    stream = (RLE8_CASES if bits == 8 else RLE4_CASES)[case]
    for top_down in (False, True):
        data = W.bmp(None, bits, top_down=top_down, palette=W._pal(bits, 2 ** bits),
                     indices=np.zeros((RLE_H, RLE_W), np.uint8), comp=1 if bits == 8 else 2, rle=stream)
        assert (_same(tmp_path, data) is None) == case.endswith("(fails)")


def test_bmp_rle8_encoded_images(tmp_path):
    rng = np.random.RandomState(8)
    for literals in (False, True):
        for _ in range(6):
            idx = rng.randint(0, 4, (rng.randint(1, 10), rng.randint(1, 30))).astype(np.uint8)
            idx[:, :idx.shape[1] // 2] = rng.randint(256)
            pal = rng.randint(0, 256, (256, 3))
            got = _same(tmp_path, W.bmp(None, 8, palette=pal, indices=idx, comp=1, rle=W.rle8_encode(idx, literals)))
            assert np.array_equal(got, pal[idx])


# -- PNM ------------------------------------------------------------------------------

PNM_CASES = [(1, 1), (4, 1)] + [(k, m) for k in (2, 3, 5, 6) for m in (1, 15, 200, 255, 256, 1000, 65535)]


@pytest.mark.parametrize("kind,maxval", PNM_CASES)
def test_pnm(tmp_path, kind, maxval):
    rng = np.random.RandomState(kind * 7 + maxval)
    for h, w in ((1, 1), (3, 5), (7, 13)):
        shape = (h, w, 3) if kind in (3, 6) else (h, w)
        _same(tmp_path, W.pnm(kind, rng.randint(0, maxval + 1, shape), maxval, comment=bool(rng.randint(2))))


@pytest.mark.parametrize("data", [b"P1\n3 2\n010\n1 1 0\n", b"P1\n3 1\n2 0 1\n", b"P2\n3 1\n255\n10 # c\n20 30\n",
                                  b"P2\n3 1\n100\n10 200 30\n", b"P5\n3 1\n100\n\xff\x10\x20",
                                  b"P6\t2\t1\t255\t" + bytes(range(6)), b"P5\n3 2\n255\n\x01\x02\x03\x04",
                                  b"P2\n3 2\n255\n1 2 3 4"],
                         ids=["P1 packed", "P1 digit 2", "P2 comment", "P2 over maxval", "P5 over maxval", "P6 tabs",
                              "P5 truncated", "P2 truncated"])
def test_pnm_edge_cases(tmp_path, data):
    _same(tmp_path, data)


# -- JPEG modes ----------------------------------------------------------------------

def _pil_cmyk(seed, h, w, **kw):
    return W._pil_cmyk(W._img(seed, h, w, 4), kw.pop("quality", 85), **kw)


SAMPLINGS = {"4:1:1": [(4, 1), (1, 1), (1, 1)], "1x4": [(1, 4), (1, 1), (1, 1)], "4x2": [(4, 2), (1, 1), (1, 1)],
             "2x4": [(2, 4), (1, 1), (1, 1)], "3x1": [(3, 1), (1, 1), (1, 1)], "3x2": [(3, 2), (1, 1), (1, 1)],
             "1x3": [(1, 3), (1, 1), (1, 1)], "4x1 2x1 2x1": [(4, 1), (2, 1), (2, 1)],
             "1x4 1x2 1x2": [(1, 4), (1, 2), (1, 2)], "2x2 1x2 1x2": [(2, 2), (1, 2), (1, 2)],
             "3x3 (11 blocks, fails)": [(3, 3), (1, 1), (1, 1)]}


@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_jpeg_sampling_factors_up_to_4(tmp_path, name):
    for h, w in ((8, 8), (19, 37), (45, 50)):
        img = W._img(h + w, h, w)
        got = _same(tmp_path, W.jpeg_baseline(W.sub_planes(img, SAMPLINGS[name]), SAMPLINGS[name], jfif=True))
        assert (got is None) == name.endswith("fails)")


FOUR_COMPONENTS = {"CMYK (PIL)": None, "CMYK progressive (PIL)": None, "YCCK": (2, [(1, 1)] * 4),
                   "YCCK 2x2 1x1 1x1 2x2": (2, [(2, 2), (1, 1), (1, 1), (2, 2)]),
                   "YCCK, Adobe transform 1": (1, [(1, 1)] * 4), "CMYK, Adobe transform 0": (0, [(2, 1)] + [(1, 1)] * 3),
                   "CMYK without an Adobe marker": (None, [(1, 1)] * 4)}


@pytest.mark.parametrize("name", list(FOUR_COMPONENTS))
def test_jpeg_cmyk_and_ycck(tmp_path, name):
    for h, w in ((8, 8), (17, 33), (40, 29)):
        if "PIL" in name:
            data = _pil_cmyk(h * w, h, w, progressive="progressive" in name)
        else:
            adobe, sampling = FOUR_COMPONENTS[name]
            data = W.jpeg_baseline(W.sub_planes(W._img(h * 3 + w, h, w, 4), sampling), sampling, adobe=adobe)
        assert _same(tmp_path, data) is not None


PROGRESSIVE = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
               "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


@pytest.mark.parametrize("sampling", list(PROGRESSIVE) + ["gray"])
@pytest.mark.parametrize("size", [(16, 16), (37, 53), (72, 24)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_block_smoothing(tmp_path, sampling, size):
    """cv2's progressive files with the refinement scans removed, and cut
    after each of their scans: libjpeg smooths every block whose first AC
    coefficients are not all known to full precision."""
    img = W._img(size[0] * size[1], *size)
    params = [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if sampling == "gray":
        data = cv2.imencode(".jpg", img[..., 0], params)[1].tobytes()
    else:
        data = cv2.imencode(".jpg", img, params + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, PROGRESSIVE[sampling]])[1].tobytes()
    n_scans = data.count(b"\xff\xda")
    assert _same(tmp_path, W.keep_scans(data, lambda i, ah: ah == 0)) is not None
    for k in range(1, n_scans):
        assert _same(tmp_path, W.keep_scans(data, lambda i, ah: i < k)) is not None


def test_png_named_jpeg_reads(tmp_path):
    """An ImageNet-style ``.JPEG`` that holds a PNG: both readers go by the
    signature."""
    img = W._img(35, 20, 26)
    got = _same(tmp_path, W.png(img, 2, 8), "n02105855_2933.JPEG")
    assert np.array_equal(got, img)


# -- what is not read --------------------------------------------------------------

def test_other_formats_raise_naming_the_format(tmp_path):
    """TIFF, WebP and GIF, as cv2 and PIL write them, and JPEG 2000, PAM,
    PFM, Radiance HDR and Sun raster, as cv2 writes them, read equal to cv2;
    AVIF, which cv2 reads and the port does not yet, raises ``IOError``
    naming it; bytes of no format name the signatures looked for."""
    img = W._img(1, 16, 16)
    from PIL import Image

    for ext in (".tif", ".webp", ".gif"):
        assert _same(tmp_path, cv2.imencode(ext, img[..., ::-1])[1].tobytes()) is not None
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, {".tif": "TIFF", ".webp": "WEBP", ".gif": "GIF"}[ext])
        assert _same(tmp_path, buf.getvalue()) is not None
    for ext, name in ((".jp2", "JPEG 2000"), (".pam", "PAM"), (".pfm", "PFM"), (".hdr", "Radiance HDR"),
                      (".ras", "Sun raster"), (".avif", "AVIF")):
        data = cv2.imencode(ext, W._img(2, 64, 80).astype(np.float32) / 255 if ext in (".pfm", ".hdr")
                            else W._img(2, 64, 80))[1].tobytes()
        path = tmp_path / f"a{ext}"
        path.write_bytes(data)
        assert jax_read_img(str(path)).shape == (64, 80, 3)  # cv2 reads it
        if name == "AVIF":
            with pytest.raises(IOError, match=name):
                read_img(str(path))
            with pytest.raises(IOError, match=name):
                port_imread.imread(str(path))
        else:
            assert np.array_equal(read_img(str(path)), jax_read_img(str(path))), name
            assert np.array_equal(port_imread.imread(str(path)), jax_read_img(str(path))), name
    for data in (b"not an image", b""):
        with pytest.raises(IOError, match="signature"):
            port_imread.imread(data)


def test_refused_jpeg_modes_raise_naming_the_mode(tmp_path):
    """Real files: arithmetic-coded and lossless JPEGs read equal to cv2;
    the modes cv2 refuses (hierarchical, 12-bit, DNL, 2 components,
    lossless grey) are refused by both, the port naming the mode."""
    img = W._img(2, 17, 33)
    planes = W.sub_planes(img, [(2, 2), (1, 1), (1, 1)])
    assert _same(tmp_path, W.jpeg_arithmetic(planes, [(2, 2), (1, 1), (1, 1)])) is not None
    assert _same(tmp_path, W.jpeg_lossless([img[..., c] for c in range(3)], predictor=4)) is not None
    data = cv2.imencode(".jpg", img)[1].tobytes()
    cases = {"hierarchical": W.jpeg_hierarchical(data), "12-bit": W.jpeg_12bit(img[..., 0].astype(int) * 16),
             "DNL": W.jpeg_dnl(data), "2-component": W.jpeg_baseline([img[..., 0], img[..., 1]], [(1, 1), (1, 1)]),
             "lossless grey": W.jpeg_lossless([img[..., 0]])}
    for mode, bad in cases.items():
        path = tmp_path / "refused.jpg"
        path.write_bytes(bad)
        with pytest.raises(IOError):
            jax_read_img(str(path))  # cv2 reads nothing
        with pytest.raises(ValueError, match=mode):
            port_imread.imread(bad)
        with pytest.raises(IOError, match=mode):
            read_img(str(path))


# -- frame sizes and the chip fixtures ---------------------------------------------

def test_frame_shape_matches_jax_frame_shape(tmp_path):
    sys.path.insert(0, REPO)
    from tools.make_annotations import _frame_shape as jax_frame_shape

    files = {
        "a.bmp": W.bmp(W._img(1, 13, 21), 24), "b.bmp": W.bmp(W._img(2, 9, 7), 24, top_down=True),
        "c.bmp": W.bmp(None, 8, palette=W._pal(3, 256), indices=W._idx(3, 11, 5, 256), header=12),
        "d.bmp": W.bmp(W._img(4, 6, 6), 16, comp=3, masks=(1, 2, 3)),  # masks OpenCV refuses: (0, 0)
        "e.pgm": W.pnm(2, W._idx(5, 4, 9, 100), 99, comment=True), "f.ppm": W.pnm(6, W._img(6, 5, 8), 255),
        "g.pbm": W.pnm(4, W._idx(7, 3, 11, 2), 1), "h.jpg": _pil_cmyk(8, 21, 13),
        "i.png": W.png(W._img(9, 7, 12), 2, 8, exif=W.tiff_orientation(6)),
        "j.png": W.png(W._img(10, 7, 12), 2, 8, exif=W.tiff_orientation(3)),
        "k.jpg": W.png(W._img(11, 5, 9), 2, 8), "l.jpg": b"GIF89a" + bytes(20),
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        assert frame_shape(str(tmp_path / name)) == jax_frame_shape(str(tmp_path / name)), name


def test_chip_fixtures_are_cv2s_pixels():
    """``chip_smoke.py`` phase 20a's fixtures: each committed file decodes,
    by cv2 and by the port, to the sha256 of cv2's pixels in the manifest."""
    images = os.path.join(REPO, *W.IMAGES_DIR)
    with open(os.path.join(images, "manifest.json")) as fh:
        manifest = json.load(fh)["decode"]
    assert [c["file"] for c in manifest] == list(W.IMAGE_FILES)
    total = 0
    for c in manifest:
        path = os.path.join(images, c["file"])
        total += os.path.getsize(path)
        want = np.ascontiguousarray(jax_read_img(path))
        got = read_img(path)
        assert list(want.shape) == list(got.shape) == c["shape"], c["file"]
        assert W.chip_smoke._sha(want.tobytes()) == W.chip_smoke._sha(got.tobytes()) == c["sha256"], c["file"]
    assert total <= 150_000
