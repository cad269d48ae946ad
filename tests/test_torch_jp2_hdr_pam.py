"""The port's JPEG 2000, PAM, PFM, Sun raster and Radiance HDR readers
(``data/jp2.py`` + ``csrc/jp2.cpp``, ``data/imread.py``, ``data/hdr.py``)
against the JAX package's ``read_img``, which is ``cv2.imread`` (OpenCV 5.0,
OpenJPEG 2.5) + BGR->RGB: byte for byte on seeded files written by PIL's
OpenJPEG, cv2 and the fixture script's writers; both readers refuse the same
files, the port raising ``ValueError`` naming the cause;
``make_annotations.frame_shape`` against JAX's ``_frame_shape`` on each
file; the committed files of ``chip_smoke.py`` phase 22 against their
manifest and record; ``chip_smoke``'s own writers of phase 22 against cv2."""

import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from feartracker_tpu.data.dataset import read_img as jax_read_img
from feartracker_tpu_torch.data import imread as port_imread
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.tools.make_annotations import frame_shape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests", "fixtures"))
sys.path.insert(0, REPO)
import make_host_io_fixtures as W  # noqa: E402  (the writers; imports cv2 and chip_smoke)
from tools.make_annotations import _frame_shape as jax_frame_shape  # noqa: E402

cv2 = W.cv2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The OPE over the committed tree runs FEAR-XS on the CPU: one intra-op
    thread, as the other heavy port files pin it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(tmp_path, data: bytes, name: str = "frame.img", header_decides: bool = True):
    """The port's and JAX's read of one file: equal arrays, or both refuse
    (the port with ``ValueError``); equal frame sizes, unless
    ``header_decides`` is False: a file whose header is sound and whose
    data cv2 refuses (the size comes from the header alone). → the port's
    array or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    if header_decides:
        assert frame_shape(path) == jax_frame_shape(path)
    try:
        want = jax_read_img(path)
    except IOError:
        with pytest.raises(ValueError):
            port_imread.imread(data)
        with pytest.raises(IOError):
            read_img(path)
        if header_decides:
            assert frame_shape(path) == (0, 0)
        return None
    got = read_img(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert frame_shape(path) == (want.shape[1], want.shape[0]) != (0, 0)
    return got


def _refused(tmp_path, data: bytes, cause: str, header_decides: bool = True):
    """cv2 reads nothing of the file; the port raises ValueError naming the
    cause; the frame size is (0, 0) in both where the header decides."""
    assert _same(tmp_path, data, "refused.img", header_decides) is None
    with pytest.raises(ValueError, match=cause):
        port_imread.imread(data)


# -- JPEG 2000 ----------------------------------------------------------------------

JP2_OPTIONS = {
    "53": {},
    "53_rct": {"mct": 1},
    "97": {"irreversible": True},
    "97_ict": {"irreversible": True, "mct": 1},
    "layers_rates": {"quality_mode": "rates", "quality_layers": [40, 10, 2]},
    "97_layers_db": {"irreversible": True, "mct": 1, "quality_mode": "dB", "quality_layers": [25, 35, 45]},
    **{f"{p.lower()}_precincts": {"progression": p, "precinct_size": (16, 16), "quality_layers": [30, 6, 1],
                                  "num_resolutions": 3} for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"97_{p.lower()}_tiles": {"progression": p, "irreversible": True, "mct": 1, "tile_size": (24, 17),
                                 "precinct_size": (32, 32), "num_resolutions": 3} for p in ("RPCL", "PCRL", "CPRL")},
    "tiles_16": {"tile_size": (16, 16), "num_resolutions": 2},
    "cblk_4x4": {"irreversible": True, "codeblock_size": (4, 4)},
    "cblk_64x8": {"irreversible": True, "codeblock_size": (64, 8)},
    "cblk_8x64": {"codeblock_size": (8, 64)},
    "res1": {"num_resolutions": 1},
    "97_res2": {"irreversible": True, "num_resolutions": 2},
    "97_res6": {"irreversible": True, "num_resolutions": 6},
    "plt": {"irreversible": True, "plt": True},
    "raw_codestream": {"irreversible": True, "mct": 1, "no_jp2": True},
    "comment": {"comment": "written here"},
}


@pytest.mark.parametrize("colour", ["rgb", "rgba"])
@pytest.mark.parametrize("option", list(JP2_OPTIONS))
def test_jp2_pil_options(tmp_path, option, colour):
    """5/3 and 9/7, with and without the component transform; layers by rate
    and by dB; each progression with precincts; tiles; code-block sizes;
    resolutions; PLT markers; a raw codestream; RGB and RGBA (alpha
    dropped): equal to cv2, 9/7 included."""
    img = W._img(len(option) * 7 + len(colour), 43, 51, c=3 if colour == "rgb" else 4)
    assert _same(tmp_path, W.jp2_pil(img, **JP2_OPTIONS[option])) is not None


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (7, 1), (2, 3), (33, 64), (65, 17)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jp2_odd_sizes(tmp_path, size, irreversible):
    """Images down to one sample a side, where the inverse DWT meets its
    one-sample and two-sample lines."""
    img = W._img(size[0] + size[1], *size)
    assert _same(tmp_path, W.jp2_pil(img, irreversible=irreversible, mct=1,
                                     num_resolutions=min(3, min(size).bit_length()))) is not None


@pytest.mark.parametrize("kind", ["grey", "grey_97", "grey16", "grey_alpha", "grey_raw_colr17"])
def test_jp2_grey(tmp_path, kind):
    """Grey (replicated), 16-bit grey (``v >> 8``), grey + alpha; a raw
    grey codestream given a greyscale colr box."""
    img = W._img(5, 29, 41)
    data = {"grey": lambda: W.jp2_pil(img[..., 0]),
            "grey_97": lambda: W.jp2_pil(img[..., 0], irreversible=True),
            "grey16": lambda: W.jp2_pil(img[..., 0].astype(np.uint16) * 256 + img[..., 1]),
            "grey_alpha": lambda: W.jp2_pil(img[..., :2]),
            "grey_raw_colr17": lambda: W.jp2_header_boxes(W.jp2_pil(img[..., 0]), [W.colr(17)])}[kind]()
    assert _same(tmp_path, data) is not None


@pytest.mark.parametrize("bits", [12, 16, 20, 28])
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_jp2_precision_above_8_bits(tmp_path, bits, irreversible):
    """SIZ edited to 12-28 bits a component: DC shift and clamp at that
    precision, then ``v >> (bits - 8)``; and mixed precisions."""
    data = W.jp2_pil(W._img(bits, 22, 26), irreversible=irreversible, mct=1)
    assert _same(tmp_path, W.jp2_siz(data, bits)) is not None
    mixed = bytearray(data)
    at = data.index(b"\xff\x4f\xff\x51")
    mixed[at + 42 + 3] = bits - 1  # component 1 only
    assert _same(tmp_path, bytes(mixed)) is not None


@pytest.mark.parametrize("enumcs", [16, 17, 18, 99, "icc"])
@pytest.mark.parametrize("channels", [3, 4])
def test_jp2_colour_spaces(tmp_path, enumcs, channels):
    """sRGB, greyscale (component 0 replicated), sYCC (cv2's YUV->BGR), an
    unknown space and an ICC profile (both as sRGB)."""
    box = (W.jp2_box(b"colr", struct.pack(">BBB", 2, 0, 0) + bytes(24)) if enumcs == "icc" else W.colr(enumcs))
    data = W.jp2_header_boxes(W.jp2_pil(W._img(channels, 23, 31, c=channels), irreversible=channels == 4), [box])
    assert _same(tmp_path, data) is not None


@pytest.mark.parametrize("bits", [5, 8, 12, 16])
def test_jp2_palette(tmp_path, bits):
    """pclr + cmap: the index component through the palette; entries wider
    than 8 bits keep their low 8 bits (OpenCV's cast)."""
    pal = np.random.RandomState(bits).randint(0, 1 << bits, (200, 3))
    assert _same(tmp_path, W.jp2_palette(W._idx(bits, 19, 23, 256), pal, bits)) is not None


@pytest.mark.parametrize("cdef", [[(0, 0, 3), (1, 0, 2), (2, 0, 1)], [(0, 0, 2), (1, 0, 1), (2, 0, 3)],
                                  [(2, 0, 1), (0, 0, 2), (1, 0, 3)], [(0, 1, 0), (1, 0, 1), (2, 0, 2)],
                                  [(0, 0, 1), (1, 0, 2), (2, 0, 3)]], ids=lambda c: "-".join(f"{a}{b}{d}" for a, b, d in c))
def test_jp2_channel_definitions(tmp_path, cdef):
    """cdef: colour channels swapped into their association's place, the
    later definitions following each swap."""
    assert _same(tmp_path, W.jp2_cdef(W._img(len(cdef[0]) + cdef[0][2], 21, 25), cdef)) is not None


def _jp2_without(data: bytes, drop: bytes) -> bytes:
    return b"".join(whole for kind, whole in W.jp2_top_boxes(data) if kind != drop)


JP2_REFUSED = {
    "signed": lambda img: W.jp2_pil(img, signed=True),
    "offset": lambda img: W.jp2_pil(img, offset=(3, 5), tile_size=(16, 16), tile_offset=(0, 0)),
    "sub-sampled": lambda img: W.jp2_siz(W.jp2_pil(img), sampling={1: (2, 1)}),
    "precision below 8 bits": lambda img: W.jp2_siz(W.jp2_pil(img), 7),
    "1 components to 3": lambda img: W.jp2_pil(img[..., 0], no_jp2=True),
    "2 components to 3": lambda img: W.jp2_header_boxes(W.jp2_pil(img[..., :2]), [W.colr(16)]),
    "CMYK": lambda img: W.jp2_header_boxes(W.jp2_pil(img), [W.colr(12)]),
    "e-sYCC": lambda img: W.jp2_header_boxes(W.jp2_pil(img), [W.colr(24)]),
    "palette column": lambda img: W.jp2_header_boxes(W.jp2_pil(img[..., 0]), [
        W.colr(16), W.jp2_box(b"pclr", struct.pack(">HBBB", 4, 2, 7, 7) + bytes(range(8))),
        W.jp2_box(b"cmap", struct.pack(">HBBHBBHBB", 0, 1, 1, 0, 0, 0, 0, 1, 0))]),
    "ftyp": lambda img: _jp2_without(W.jp2_pil(img), b"ftyp"),
    "before the header": lambda img: b"".join(
        whole for _, whole in sorted(W.jp2_top_boxes(W.jp2_pil(img)), key=lambda b: b[0] == b"jp2h")),
    "ihdr": lambda img: W.jp2_header_boxes(W.jp2_pil(img), [W.colr(16)]).replace(b"ihdr", b"xhdr"),
    "incomplete channel definitions": lambda img: W.jp2_cdef(img, [(0, 0, 1), (1, 0, 2)]),
}


@pytest.mark.parametrize("cause", list(JP2_REFUSED))
def test_jp2_files_cv2_refuses_are_refused_naming_the_cause(tmp_path, cause):
    """Signed components, an image offset, a sub-sampled component, under 8
    bits, one or two components outside a greyscale colr, CMYK and e-sYCC,
    a palette column mapped to another channel, boxes out of order or
    missing, incomplete channel definitions: cv2 reads nothing, the port
    raises naming the cause."""
    _refused(tmp_path, JP2_REFUSED[cause](W._img(9, 40, 48)), cause)


def test_jp2_truncated_codestream_is_refused(tmp_path):
    data = W.jp2_pil(W._img(3, 40, 48), no_jp2=True)
    _refused(tmp_path, data[:-40], "truncated", header_decides=False)


# -- PAM ------------------------------------------------------------------------------

PAM_CASES = [(t, d, mv) for t, d in (("RGB", 3), (None, 3), ("GRAYSCALE", 1), (None, 1), ("BLACKANDWHITE", 1))
             for mv in (1, 2, 100, 255, 256, 1000, 65535)] + [("GRAYSCALE_ALPHA", 2, 1), ("RGB_ALPHA", 4, 1)]


@pytest.mark.parametrize("tupltype,depth,maxval", PAM_CASES, ids=[f"{t}-{d}-{m}" for t, d, m in PAM_CASES])
def test_pam_tuple_types_and_maxvals(tmp_path, tupltype, depth, maxval):
    """Every tuple type at maxvals 1-65535: samples as stored (no scaling by
    maxval), 16-bit as ``v >> 8``, maxval 1 as packed bits; no TUPLTYPE
    only at depth 1 or 3 up to maxval 255 (cv2 refuses the rest)."""
    samples = W._idx(depth + maxval % 97, 11, 19, maxval + 1)[..., None].repeat(depth, 2)
    samples = (samples + np.arange(depth)) % (maxval + 1)
    _same(tmp_path, W.pam(samples, maxval, tupltype))


PAM_HEADERS = {
    "fields in any order": b"P7\nHEIGHT 2\nWIDTH 3\nMAXVAL 255\nDEPTH 3\nENDHDR\n",
    "spaces and comments": b"P7\n  WIDTH   3\n#c\n\tHEIGHT 2\n\n\nDEPTH 3\nMAXVAL 255\nTUPLTYPE  RGB \nENDHDR\n",
    "value on the next line": b"P7\nWIDTH\n3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "leading zero": b"P7\nWIDTH 03\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "empty TUPLTYPE": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE\nENDHDR\n",
    "two fields a line": b"P7\nWIDTH 3 HEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "no MAXVAL": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nENDHDR\n",
    "a field twice": b"P7\nWIDTH 3\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "lower case": b"P7\nwidth 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "unknown field": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nFOO 1\nENDHDR\n",
    "unknown tuple type": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE rgb\nENDHDR\n",
    "depth against tuple type": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n",
    "maxval 65536": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 65536\nENDHDR\n",
    "not a number": b"P7\nWIDTH 3x\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
    "text after ENDHDR": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR  \n",
    "depth 4 without a tuple type": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 4\nMAXVAL 255\nENDHDR\n",
}


@pytest.mark.parametrize("case", list(PAM_HEADERS))
def test_pam_headers(tmp_path, case):
    """OpenCV's header reader: white space and comments between fields,
    decimal digits only, each field once; what it refuses, the port does."""
    _same(tmp_path, PAM_HEADERS[case] + bytes(np.random.RandomState(1).randint(0, 256, 24).astype(np.uint8)))


@pytest.mark.parametrize("tupltype,depth", [("GRAYSCALE_ALPHA", 2), ("RGB_ALPHA", 4)])
def test_pam_alpha_above_maxval_1_is_refused(tmp_path, tupltype, depth):
    """OpenCV 5.0 converts these rows past its row buffer (its pixels are
    not the file's and vary with memory): the port raises naming alpha
    rather than guess, and the frame size is the header's, as JAX's."""
    data = W.pam(W._idx(depth, 7, 11, 256)[..., None].repeat(depth, 2), 255, tupltype)
    path = tmp_path / "alpha.pam"
    path.write_bytes(data)
    assert cv2.imread(str(path)) is not None
    with pytest.raises(ValueError, match="alpha"):
        port_imread.imread(data)
    assert frame_shape(str(path)) == jax_frame_shape(str(path)) == (11, 7)


# -- PFM ------------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [-1.0, 1.0, 3.0, -7.0, 0.1, -0.001, 123.456])
def test_pfm_byte_orders_and_scales(tmp_path, scale):
    """Little-endian (negative scale) and big-endian, rows bottom-up, times
    float32(1 / |scale|), rounded half to even and saturated; NaN, ±inf and
    values past int32 read 0."""
    assert _same(tmp_path, W.pfm(W._special_floats(int(abs(scale) * 7), 9, 13), scale)) is not None


PFM_HEADERS = {
    "integer scale": b"PF\n4 3\n-1\n", "exponent": b"PF\n4 3\n-2e0\n", "tabs": b"PF\n4\t3\t-1.0\t",
    "one line each": b"PF\n4\n3\n-1.0\n", "leading zero": b"PF\n04 3\n-1.0\n", "trailing text": b"PF\n4 3\n-1.0x\n",
    "space after PF": b"PF 4 3 -1.0\n", "scale 0": b"PF\n4 3\n0\n", "CR LF": b"PF\n4 3\n-1.0\r\n",
}


@pytest.mark.parametrize("case", list(PFM_HEADERS))
def test_pfm_headers(tmp_path, case):
    """Three numbers each ended by one white-space byte, read from each
    token's start; a line break right after ``PF``; scale 0 refused."""
    values = np.random.RandomState(2).rand(3, 4, 3).astype(np.float32) * 255
    _same(tmp_path, PFM_HEADERS[case] + values[::-1].astype("<f4").tobytes() + bytes(4))


def test_pfm_grey_and_truncated_are_refused(tmp_path):
    _refused(tmp_path, W.pfm(W._floats(1, 5, 6)[..., 0] * 100), "one channel")
    _refused(tmp_path, W.pfm(W._floats(2, 5, 6) * 100)[:-8], "truncated", header_decides=False)


# -- Sun raster -----------------------------------------------------------------------

def _sun(seed, bpp, kind, maplength=0, w=13, h=5):
    rng = np.random.RandomState(seed)
    if bpp == 1:
        rows = np.packbits(rng.randint(0, 2, (h, w)).astype(np.uint8), axis=1)
    else:
        rows = rng.randint(0, 256, (h, w * bpp // 8)).astype(np.uint8)
    return W.sun_raster(rows, w, h, bpp, kind, cmap=bytes(rng.randint(0, 256, maplength).astype(np.uint8)))


SUN_CASES = [(bpp, kind, ml) for kind in (0, 1) for bpp, ml in ((1, 0), (1, 6), (1, 3), (8, 0), (8, 768), (8, 30),
                                                                 (8, 31), (24, 0), (32, 0))]


@pytest.mark.parametrize("bpp,kind,maplength", SUN_CASES, ids=[f"{b}bit-type{k}-map{m}" for b, k, m in SUN_CASES])
def test_sun_raster_types_depths_and_maps(tmp_path, bpp, kind, maplength):
    """Old and standard types at 1, 8, 24 and 32 bits, rows padded to 16
    bits, no map (grey ramp) or an equal-RGB map of any length that fits."""
    assert _same(tmp_path, _sun(bpp + kind + maplength, bpp, kind, maplength)) is not None


@pytest.mark.parametrize("width", [1, 2, 7, 8, 17])
def test_sun_raster_widths(tmp_path, width):
    for bpp in (1, 8, 24, 32):
        assert _same(tmp_path, _sun(width, bpp, 1, w=width, h=3)) is not None


SUN_REFUSED = {
    "byte-encoded": lambda: _sun(1, 8, 2), "RGB": lambda: _sun(2, 24, 3), "colour map": lambda: _sun(3, 8, 1, 800),
    "4 bits": lambda: W.sun_raster(np.zeros((5, 7), np.uint8), 13, 5, 4),
    "map type": lambda: W.sun_raster(np.zeros((5, 13), np.uint8), 13, 5, 8, cmap=bytes(30), maptype=2),
    "truncated": lambda: _sun(4, 24, 1)[:-3],
}


@pytest.mark.parametrize("cause", list(SUN_REFUSED))
def test_sun_raster_files_cv2_refuses_are_refused(tmp_path, cause):
    """OpenCV 5.0 compares the type against the wrong field, so it reads no
    byte-encoded (RLE) or RGB-format raster; nor 4 bits, a raw colour map,
    a map too long for the depth, truncated rows."""
    _refused(tmp_path, SUN_REFUSED[cause](), cause.split()[0] if cause != "4 bits" else "4 bits",
             header_decides=cause != "truncated")


# -- Radiance HDR ---------------------------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (3, 5), (1, 8), (6, 20), (2, 300)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("rle", [True, False], ids=["rle", "flat"])
def test_hdr_rle_and_flat(tmp_path, size, rle):
    """cv2's writer, run-length scanlines (flat below 8 wide) or flat;
    values past 255 saturate, those past int32 read 0."""
    values = W._floats(size[0] + size[1], *size)
    values[0, 0] = [0, 1e-30, 1e30]
    assert _same(tmp_path, W.hdr(values, rle=rle)) is not None


HDR_HEADERS = {
    "RGBE signature": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20\n",
    "lines before FORMAT": b"#?RADIANCE\nEXPOSURE=2.0\nGAMMA=2.2\n# c\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20\n",
    "line after FORMAT": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=2.0\n\n-Y 6 +X 20\n",
    "sizes without spaces": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y6+X20\n",
    "text after the size": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20 more\n",
    "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 6 +X 20\n",
    "+Y": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 6 +X 20\n",
    "-X": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 -X 20\n",
    "blank line before FORMAT": b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20\n",
    "CR LF": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 6 +X 20\r\n",
    "wrong scanline width": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 21\n",
    "negative height": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y -6 +X 20\n",
}


@pytest.mark.parametrize("case", list(HDR_HEADERS))
def test_hdr_headers(tmp_path, case):
    """Header lines up to the first blank one, FORMAT among them; the size
    line as ``-Y <h> +X <w>`` only."""
    body = W.hdr(W._floats(7, 6, 20)).split(b"+X 20\n", 1)[1]
    _same(tmp_path, HDR_HEADERS[case] + body, header_decides=case != "wrong scanline width")


def test_hdr_mixed_scanlines_and_truncation(tmp_path):
    """A scanline that does not start 2, 2 is flat from there on; short
    data is refused."""
    values = W._floats(8, 6, 20)
    values[3, 0] = [100.0, 0.5, 0.5]  # the first flat pixel's mantissas do not start 2, 2
    rle = W.hdr(values[:3]).split(b"+X 20\n", 1)[1]
    flat = W.hdr(values[3:], rle=False).split(b"+X 20\n", 1)[1]
    assert _same(tmp_path, b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 20\n" + rle + flat) is not None
    _refused(tmp_path, W.hdr(values)[:-5], "RGBE", header_decides=False)


# -- the committed files, the tree and chip_smoke's writers ----------------------------

def test_phase22_fixtures_are_cv2s_pixels():
    """``chip_smoke.py`` phase 22a's files: each decodes, by cv2 and by the
    port, to the sha256 of cv2's pixels in the manifest; each frame size is
    JAX's; format files at most 8 kB and 70 px a side, timing files 200 kB."""
    images = os.path.join(REPO, *W.IMAGES_DIR)
    with open(os.path.join(images, W.JP2_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    assert [c["file"] for c in manifest] == list(W.JP2_FORMAT_FILES) + list(W.JP2_TIMING_FILES)
    for c in manifest:
        path = os.path.join(images, c["file"])
        want = np.ascontiguousarray(jax_read_img(path))
        got = read_img(path)
        assert list(want.shape) == list(got.shape) == c["shape"], c["file"]
        assert W.chip_smoke._sha(want.tobytes()) == W.chip_smoke._sha(got.tobytes()) == c["sha256"], c["file"]
        assert frame_shape(path) == jax_frame_shape(path) == (c["shape"][1], c["shape"][0])
        assert os.path.getsize(path) < (200_000 if c["file"] in W.JP2_TIMING_FILES else 8_000), c["file"]
        if c["file"] in W.JP2_FORMAT_FILES:
            assert max(c["shape"][:2]) <= 70


def test_phase22_tree_is_its_record_and_its_ope_result():
    """22b's committed GOT-10k val tree: every file at its recorded sha256,
    frames JPEG 2000 under ``.jpg`` names equal to cv2's reading, under
    1 MB in all; the port's OPE over it on the CPU equals the recorded
    result that the card's must equal."""
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker

    root = os.path.join(REPO, *W.chip_smoke.JP2_TREE)
    with open(os.path.join(root, W.chip_smoke.JP2_TREE_RECORD)) as fh:
        record = json.load(fh)
    assert W.tree_files(root) == record["files"]
    assert record["bytes"] == sum(os.path.getsize(os.path.join(root, f)) for f in record["files"]) < 1_000_000
    frames = sorted(f for f in record["files"] if f.endswith(".jpg"))
    assert len(frames) == 24 and record["lengths"] == [12, 12]
    first = os.path.join(root, frames[0])
    with open(first, "rb") as fh:
        assert fh.read(12) == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    assert np.array_equal(read_img(first), jax_read_img(first))
    with torch.inference_mode():
        ao = evaluate_tracker(W.chip_smoke._fear_tracker("cpu", torch.float32), GOT10kDataset(root, "val"))
    assert json.loads(json.dumps(ao)) == record["ope_cpu"]


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (37, 45), (90, 160)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_chip_smoke_writers_read_back(tmp_path, size):
    """Phase 22a/c's writers: cv2 reads each, equal to the port; PAM, PFM
    and Sun raster hold the frame exactly, the flat HDR as rint(v * 255 /
    256)."""
    cs = W.chip_smoke
    img = cs.fixture_frame(size[0] * 5 + size[1], *size)
    for write in (cs.pam_rgb, cs.pfm_rgb, cs.sun_raster):
        assert np.array_equal(_same(tmp_path, write(img)), img)
    assert np.array_equal(_same(tmp_path, cs.hdr_flat(img)), np.rint(img * (255 / 256)).astype(np.uint8))
