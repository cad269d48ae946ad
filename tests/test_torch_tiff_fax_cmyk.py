"""The port's TIFF reader on CCITT fax, FillOrder 2, CMYK, CIELab,
uncompressed YCbCr and signed samples (``data/tiff.py`` +
``csrc/imgcodecs.cpp:tiff_fax`` / ``tiff_cielab``) against the JAX package's
``read_img``, which is ``cv2.imread`` (OpenCV 5.0, libtiff 4.7) + BGR->RGB:
byte for byte on seeded files written by PIL's libtiff and the fixture
script's writers; both readers refuse the same files, the port raising
``ValueError`` naming the layout; ``make_annotations.frame_shape`` against
JAX's ``_frame_shape`` on each file; the committed files of ``chip_smoke.py``
phase 23a against their manifest; ``chip_smoke``'s phase-23 writers against
cv2; the GOT-10k OPE over a CMYK tree against ``.npy`` frames, and over
phase 19c's tree rewritten as YCbCr 2x2 against the record that phase
23b(ii) holds the card to."""

import json
import os
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
cs = W.chip_smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The OPE cases run FEAR-XS on the CPU: one intra-op thread, as the
    other heavy port files pin it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(tmp_path, data: bytes, name: str = "frame.tif", header_decides: bool = True):
    """The port's and JAX's read of one file: equal arrays and frame sizes,
    or both refuse (the port with ``ValueError``, the frame size (0, 0)),
    the sizes compared unless ``header_decides`` is False: a file whose
    header is sound and whose data cv2 cannot decode. → the port's array or
    None."""
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


def _refused(tmp_path, data: bytes, cause: str):
    """cv2 reads nothing of the file; the port raises ValueError naming the
    cause; both frame sizes are (0, 0)."""
    assert _same(tmp_path, data, "refused.tif") is None
    with pytest.raises(ValueError, match=cause):
        port_imread.imread(data)


def _cmyk(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 4))


# -- CCITT ------------------------------------------------------------------------------

FAX_CASES = [(comp, t4, lay) for comp in (2, 32771, 4) for t4 in (0,) for lay in ("strip", "strips7", "tile16x32")] + [
    (3, t4, lay) for t4 in (0, 1, 2, 4, 5) for lay in ("strip", "strips7", "tile32x16")]
LAYOUTS = {"strip": {}, "strips7": {"rows": 7}, "tile16x32": {"tile": (16, 32)}, "tile32x16": {"tile": (32, 16)}}


@pytest.mark.parametrize("comp,t4,layout", FAX_CASES, ids=[f"c{c}-t4_{t}-{lay}" for c, t, lay in FAX_CASES])
@pytest.mark.parametrize("fill_order", [1, 2])
def test_ccitt_codecs_layouts_and_fill_orders(tmp_path, comp, t4, layout, fill_order):
    """Modified Huffman, RLEW, Group 3 (1-D; 2-D; the uncompressed-mode and
    EOL-alignment bits) and Group 4 as libtiff encodes them, in strips and
    tiles, either FillOrder, MinIsWhite and MinIsBlack."""
    bits = W._bw(comp + t4 + len(layout), 45, 61)
    for photometric in (0, 1):
        data = W.tiff_ccitt(bits, comp, t4=t4, photometric=photometric, fill_order=fill_order, **LAYOUTS[layout])
        got = _same(tmp_path, data)
        if comp != 32771:  # libtiff's RLEW writer and reader disagree on word alignment; cv2 is the oracle
            assert np.array_equal(got[..., 0] == 0, bits == (photometric == 0))


@pytest.mark.parametrize("comp", [2, 3, 4])
@pytest.mark.parametrize("size", [(3, 3000), (64, 2600), (1, 1), (2, 9)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["noise", "sparse", "black", "white"])
def test_ccitt_run_lengths(tmp_path, comp, size, kind):
    """Runs of every length up to rows of 3000: make-up codes of each
    colour, the shared ones past 1728, repeated 2560s; lines all black or
    all white."""
    rng = np.random.RandomState(sum(size) + comp)
    bits = {"noise": lambda: rng.rand(*size) > 0.5, "sparse": lambda: rng.rand(*size) > 0.98,
            "black": lambda: np.ones(size, bool), "white": lambda: np.zeros(size, bool)}[kind]()
    assert _same(tmp_path, W.tiff_ccitt(bits, comp, t4=1 if comp == 3 else 0)) is not None


def _mutate(data: bytes, seed: int, n: int = 3) -> bytes:
    rng = np.random.RandomState(seed)
    b = bytearray(data)
    for _ in range(n):
        b[rng.randint(len(b) // 4, 3 * len(b) // 4)] = rng.randint(256)
    return bytes(b)


@pytest.mark.parametrize("comp,t4", [(2, 0), (32771, 0), (3, 0), (3, 1), (4, 0)])
@pytest.mark.parametrize("mutated", [1, 3])
def test_ccitt_bad_codes_as_libtiff_recovers(tmp_path, comp, t4, mutated):
    """Corrupted codes (``mutated`` bytes of each strip, or of the first
    strip's only): libtiff cuts or fills out the row and decodes on from
    where the bits stand (a Group 4 pass past the reference line reads what
    an earlier strip left in the run array); equal to cv2 on every file the
    port reads. Group 3 data whose codes run to the end of the strip raises
    (see the truncation test); a file with one bad byte mostly does not."""
    bits = W._bw(comp + t4, 61, 150)
    segs = W.ccitt_segments(bits, comp, rows=16, t4=t4)
    read = 0
    for seed in range(12):
        bad = [_mutate(s, seed * 7 + k, mutated) if mutated == 3 or k == 0 else s for k, s in enumerate(segs)]
        data = W.tiff(bits.astype(np.uint8), bits=1, photometric=0, compression=comp, rows=16, segments=bad,
                      tags=[(292, 4, [t4])] if comp == 3 else [])
        path = tmp_path / "bad.tif"
        path.write_bytes(data)
        want = jax_read_img(str(path))
        try:
            got = port_imread.imread(data)
        except ValueError as e:
            assert comp == 3 and "ends before the last row" in str(e)
            continue
        assert np.array_equal(got, want)
        read += 1
    assert read >= (0 if comp == 3 and mutated == 3 else 6 if comp == 3 else 12)


@pytest.mark.parametrize("comp", [2, 32771, 3, 4])
@pytest.mark.parametrize("keep", [0.3, 0.7])
def test_ccitt_truncated_strips(tmp_path, comp, keep):
    """Strips cut short. Modified Huffman, RLEW and Group 4: libtiff's
    decoder fails, OpenCV reads on and the rows not reached are zero bits:
    equal to cv2. Group 3: cv2 decodes the missing rows from a re-read of
    the strip in libtiff's no-EOL mode (rows that are not the file's); the
    port raises naming the end of the data."""
    bits = W._bw(comp, 40, 70)
    segs = [s[:max(1, int(len(s) * keep))] for s in W.ccitt_segments(bits, comp, rows=20)]
    data = W.tiff(bits.astype(np.uint8), bits=1, photometric=0, compression=comp, rows=20, segments=segs)
    if comp != 3:
        assert _same(tmp_path, data) is not None
        return
    path = tmp_path / "cut.tif"
    path.write_bytes(data)
    assert cv2.imread(str(path)) is not None
    with pytest.raises(ValueError, match="Group 3: the data ends before the last row"):
        port_imread.imread(data)


# -- FillOrder 2 on the other codecs -----------------------------------------------------

FILL_CASES = [(comp, lay, *kind) for comp in (1, 5, 8, 32773) for lay in ("strips5", "tile16x32", "tile32x32")
              for kind in ((2, 3, 8), (1, 1, 8), (1, 1, 16), (0, 1, 1), (5, 4, 8))]


@pytest.mark.parametrize("comp,layout,photometric,channels,bits", FILL_CASES,
                         ids=[f"c{c}-{lay}-ph{p}x{n}-{b}bit" for c, lay, p, n, b in FILL_CASES])
def test_fill_order_2_reverses_raw_bits(tmp_path, comp, layout, photometric, channels, bits):
    """libtiff reverses each raw strip's or tile's bits before none, LZW,
    Deflate and PackBits. Uncompressed tiles take libtiff's unmapped read
    then, which fails unless a tile holds a multiple of 1024 bytes: both
    refuse the others."""
    kw = {"strips5": {"rows": 5}, "tile16x32": {"tile": (16, 32)}, "tile32x32": {"tile": (32, 32)}}[layout]
    samples = np.random.RandomState(comp + channels + bits).randint(0, 2 ** bits, (37, 45, channels))
    data = W.tiff(samples, bits=bits, photometric=photometric, compression=comp, fill_order=2,
                  predictor=2 if comp in (5, 8) and bits >= 8 else 1, **kw)
    tile_bytes = kw["tile"][0] * -(-kw["tile"][1] * channels * bits // 8) if "tile" in kw else 0
    if comp == 1 and tile_bytes % 1024:
        _refused(tmp_path, data, "FillOrder 2 uncompressed tiles")
    else:
        assert _same(tmp_path, data) is not None


def test_fill_order_2_jpeg_reads_its_bits_as_stored(tmp_path):
    """The JPEG codec ignores FillOrder (libtiff's TIFF_NOBITREV): the tag
    changes nothing; reversed JPEG data reads as nothing in both."""
    img = W._img(3, 37, 45)
    segs, tables = [], None
    for y in range(0, 37, 16):
        t, seg = W.jpeg_segments(cv2.imencode(".jpg", np.ascontiguousarray(img[y:y + 16, :, ::-1]))[1].tobytes())
        tables = tables or t
        segs.append(seg)
    kw = dict(photometric=6, compression=7, rows=16, segments=segs, jpeg_tables=tables, tags=[(530, 3, [2, 2])])
    plain = _same(tmp_path, W.tiff(img, **kw))
    assert np.array_equal(_same(tmp_path, W.tiff(img, **{**kw, "tags": kw["tags"] + [(266, 3, [2])]})), plain)
    assert _same(tmp_path, W.tiff(img, fill_order=2, **kw), header_decides=False) is None


EDGE_CASES = [(bits, ph, c, extra) for bits in (8, 16) for ph, c, extra in (
    (1, 1, None), (0, 1, None), (1, 2, [0]), (1, 2, [2]), (0, 2, [1]), (3, 2, [0])) if not (ph == 3 and bits == 16)]


@pytest.mark.parametrize("bits,photometric,channels,extra", EDGE_CASES,
                         ids=[f"{b}bit-ph{p}x{c}-extra{e}" for b, p, c, e in EDGE_CASES])
@pytest.mark.parametrize("big_endian", [False, True])
def test_grey_and_palette_tiles_cut_by_the_right_edge(tmp_path, bits, photometric, channels, extra, big_endian):
    """Grey and palette pixels of more than a byte (16-bit grey, grey or an
    index with alpha) in tiles the image's right edge cuts: libtiff's put
    routines step between rows by the skipped pixels in bytes, not in
    pixels, so cv2's rows there shift; the port reads them as cv2 does."""
    rng = np.random.RandomState(bits + photometric + channels)
    kw = {"colormap": rng.randint(0, 65536, (256, 3))} if photometric == 3 else {}
    for tile, size in (((16, 32), (37, 45)), ((32, 16), (40, 70)), ((16, 16), (5, 100))):
        s = rng.randint(0, 2 ** bits, size + (channels,))
        assert _same(tmp_path, W.tiff(s, bits=bits, photometric=photometric, tile=tile, extra=extra,
                                      big_endian=big_endian, compression=5, predictor=2, **kw)) is not None


# -- CMYK -------------------------------------------------------------------------------

CMYK_CASES = [(comp, planar, lay) for comp in (1, 5, 8, 32773) for planar in (1, 2) for lay in ("strips7", "tile16")]


@pytest.mark.parametrize("comp,planar,layout", CMYK_CASES, ids=[f"c{c}-pl{p}-{lay}" for c, p, lay in CMYK_CASES])
def test_cmyk_compressions_planes_and_layouts(tmp_path, comp, planar, layout):
    """Seeded random 8-bit CMYK (K anywhere in 0-255) through every codec,
    contiguous and planar, strips and tiles: libtiff's k = 255 - K,
    R = k * (255 - C) // 255."""
    cmyk = _cmyk(comp + planar, 33, 41)
    kw = {"strips7": {"rows": 7}, "tile16": {"tile": (16, 16)}}[layout]
    got = _same(tmp_path, W.tiff(cmyk, photometric=5, compression=comp, planar=planar,
                                 predictor=2 if comp in (5, 8) else 1, **kw))
    k = 255 - cmyk[..., 3:]
    assert np.array_equal(got, k * (255 - cmyk[..., :3]) // 255)


@pytest.mark.parametrize("writer", ["pil-raw", "pil-lzw", "pil-deflate", "pil-packbits", "pil-jpeg", "planar-jpeg",
                                    "inkset-1", "signed"])
def test_cmyk_writers(tmp_path, writer):
    """PIL's CMYK TIFFs (libtiff's writer, JPEG's four components taken as
    they are), planar JPEG (a one-component JPEG a plane), an explicit
    InkSet 1, SampleFormat 2."""
    img = W._img(len(writer), 37, 45)
    data = {"pil-raw": lambda: W._pil_mode(img, "CMYK"),
            "pil-lzw": lambda: W._pil_mode(img, "CMYK", compression="tiff_lzw"),
            "pil-deflate": lambda: W._pil_mode(img, "CMYK", compression="tiff_adobe_deflate"),
            "pil-packbits": lambda: W._pil_mode(img, "CMYK", compression="packbits"),
            "pil-jpeg": lambda: W._pil_mode(img, "CMYK", compression="jpeg"),
            "planar-jpeg": lambda: W.tiff_planar_jpeg(_cmyk(1, 37, 45).astype(np.uint8), 5),
            "inkset-1": lambda: W.tiff(_cmyk(2, 20, 30), photometric=5, tags=[(332, 3, [1])]),
            "signed": lambda: W.tiff(_cmyk(3, 20, 30), photometric=5, tags=[(339, 3, [2] * 4)])}[writer]()
    assert _same(tmp_path, data) is not None


CMYK_REFUSED = {
    "16-bit contiguous": (lambda: W.tiff(np.random.RandomState(0).randint(0, 65536, (9, 11, 4)), bits=16,
                                         photometric=5), "16-bit"),
    "16-bit planar": (lambda: W.tiff(np.random.RandomState(1).randint(0, 65536, (9, 11, 4)), bits=16, photometric=5,
                                     planar=2), "16-bit"),
    "InkSet 2": (lambda: W.tiff(_cmyk(4, 9, 11), photometric=5, tags=[(332, 3, [2])]), "InkSet 2"),
    "5 samples": (lambda: W.tiff(_cmyk(5, 9, 11)[..., [0, 1, 2, 3, 3]], photometric=5, extra=[2]), "5 samples"),
    "5 samples planar": (lambda: W.tiff(_cmyk(6, 9, 11)[..., [0, 1, 2, 3, 3]], photometric=5, extra=[0], planar=2),
                         "5 samples"),
    "3 samples": (lambda: W.tiff(_cmyk(7, 9, 11)[..., :3], photometric=5), "3 samples"),
}


@pytest.mark.parametrize("case", list(CMYK_REFUSED))
def test_cmyk_layouts_both_refuse(tmp_path, case):
    """16-bit CMYK (libtiff has no put routine), another InkSet, more than
    four samples (OpenCV reads at most four channels) or fewer."""
    make, cause = CMYK_REFUSED[case]
    _refused(tmp_path, make(), cause)


# -- CIELab -----------------------------------------------------------------------------

LAB_CASES = [(bits, comp, lay) for bits in (8, 16) for comp in (1, 5, 8, 32773) for lay in ("strips6", "tile16")]


@pytest.mark.parametrize("bits,comp,layout", LAB_CASES, ids=[f"{b}bit-c{c}-{lay}" for b, c, lay in LAB_CASES])
def test_cielab_depths_codecs_and_layouts(tmp_path, bits, comp, layout):
    """Seeded random 8-bit and 16-bit CIELab (signed a, b) through every
    codec: TIFFCIELabToRGB's float steps, byte-equal."""
    lab = np.random.RandomState(bits + comp).randint(0, 2 ** bits, (29, 37, 3))
    kw = {"strips6": {"rows": 6}, "tile16": {"tile": (16, 16)}}[layout]
    assert _same(tmp_path, W.tiff(lab, bits=bits, photometric=8, compression=comp, big_endian=comp == 5,
                                  predictor=2 if comp in (5, 8) else 1, **kw)) is not None


@pytest.mark.parametrize("lightness", [0, 1, 20, 22, 23, 24, 128, 254, 255])
def test_cielab_every_a_and_b(tmp_path, lightness):
    """Every (a, b) byte pair at lightnesses on both sides of the L < 8.856
    branch: 65,536 pixels a file, each equal to cv2's."""
    ab = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    lab = np.concatenate([np.full((256, 256, 1), lightness), ab], axis=2)
    assert _same(tmp_path, W.tiff(lab, photometric=8, rows=64)) is not None


@pytest.mark.parametrize("white", [None, [(3127, 10000), (3290, 10000)], [(1, 3), (1, 3)], [0.2, 0.7]],
                         ids=["D50-default", "D65", "E", "odd"])
def test_cielab_white_points(tmp_path, white):
    """The WhitePoint tag (libtiff's float quotient of each rational) or,
    without one, D50."""
    data = W.tiff(W._pil_samples(W._img(7, 31, 43), "LAB"), photometric=8, tags=[(318, 5, white)] if white else [])
    assert _same(tmp_path, data) is not None


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_adobe_deflate", "packbits", "jpeg"])
def test_cielab_pil_writers(tmp_path, compression):
    """PIL's CIELab TIFFs, JPEG's three components taken as they are."""
    assert _same(tmp_path, W._pil_mode(W._img(8, 31, 43), "LAB", compression=compression)) is not None


LAB_REFUSED = {
    "planar": (lambda lab: W.tiff(lab, photometric=8, planar=2), "CIELab planar"),
    "4 samples": (lambda lab: W.tiff(np.dstack([lab, lab[..., :1]]), photometric=8, extra=[0]), "4 samples"),
    "WhitePoint y = 0": (lambda lab: W.tiff(lab, photometric=8, tags=[(318, 5, [0.5, 0.0])]), "WhitePoint"),
    "ICCLab": (lambda lab: W.tiff(lab, photometric=9), "ICCLab"),
    "ICCLab 16-bit": (lambda lab: W.tiff(lab * 257, bits=16, photometric=9), "ICCLab"),
    "ITULab": (lambda lab: W.tiff(lab, photometric=10), "ITULab"),
    "planar JPEG": (lambda lab: W.tiff_planar_jpeg(lab.astype(np.uint8), 8), "CIELab planar"),
}


@pytest.mark.parametrize("case", list(LAB_REFUSED))
def test_cielab_layouts_both_refuse(tmp_path, case):
    """Planar CIELab (libtiff has no separate-plane routine), extra samples,
    a white point of y = 0, ICCLab and ITULab."""
    make, cause = LAB_REFUSED[case]
    _refused(tmp_path, make(np.random.RandomState(3).randint(0, 256, (13, 17, 3))), cause)


# -- YCbCr without JPEG -------------------------------------------------------------------

YCC_CASES = [(sub, lay) for sub in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
             for lay in ("strip", "strips6", "strips5", "tile16", "tile16x32")]


@pytest.mark.parametrize("sub,layout", YCC_CASES, ids=[f"{s[0]}x{s[1]}-{lay}" for s, lay in YCC_CASES])
@pytest.mark.parametrize("size", [(37, 45), (5, 7), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_ycbcr_subsampling_and_layouts(tmp_path, sub, layout, size):
    """Seeded random Y, Cb, Cr in packed blocks at every subsampling
    libtiff's put routines take, over sizes the blocks do not divide, in
    strips (of a whole number of block rows or not) and tiles: the 4x4
    routine's step over a tile cut by the right edge included."""
    ycc = np.random.RandomState(sub[0] * 10 + sub[1] + size[0]).randint(0, 256, size + (3,))
    kw = {"strip": {}, "strips6": {"rows": 6}, "strips5": {"rows": 5}, "tile16": {"tile": (16, 16)},
          "tile16x32": {"tile": (16, 32)}}[layout]
    assert _same(tmp_path, W.tiff(ycc, photometric=6, ycbcr=sub, **kw)) is not None


@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("sub,tile", [((2, 2), None), ((4, 2), None), ((2, 1), (16, 16)), ((4, 4), (16, 16))])
def test_ycbcr_codecs_and_predictor(tmp_path, comp, predictor, sub, tile):
    """Every codec; predictor 2 after LZW and Deflate, which libtiff undoes
    over its rows of packed blocks (a scanline is a row of blocks over the
    vertical subsampling; a tile's row its width times 3), 3 bytes apart."""
    ycc = np.random.RandomState(comp + predictor).randint(0, 256, (35, 42, 3))
    assert _same(tmp_path, W.tiff(ycc, photometric=6, ycbcr=sub, compression=comp, predictor=predictor, rows=8,
                                  tile=tile)) is not None


YCC_TAGS = {
    "default": [],
    "reference 16-235": [(532, 5, [16, 235, 128, 240, 128, 240])],
    "reference fractional": [(532, 5, [15.5, 235.25, 127.5, 240, 100, 200])],
    "reference flat chroma": [(532, 5, [0, 0, 128, 128, 0, 255])],
    "reference beyond": [(532, 10, [300, 10, -20, 400, 128, 255])],
    "BT.709": [(529, 5, [(2126, 10000), (7152, 10000), (722, 10000)])],
    "odd coefficients": [(529, 10, [2.5, 0.1, -1.0])],
    "both": [(529, 5, [0.5, 0.25, 0.25]), (532, 5, [16, 235, 128, 240, 128, 240])],
}


@pytest.mark.parametrize("case", list(YCC_TAGS))
def test_ycbcr_reference_black_white_and_coefficients(tmp_path, case):
    """ReferenceBlackWhite and YCbCrCoefficients through TIFFYCbCrToRGBInit's
    float and fixed-point steps (each rational as libtiff's float
    quotient), past the usual ranges too."""
    ycc = np.random.RandomState(len(case)).randint(0, 256, (29, 35, 3))
    assert _same(tmp_path, W.tiff(ycc, photometric=6, ycbcr=(2, 2), compression=5, rows=8,
                                  tags=YCC_TAGS[case])) is not None


@pytest.mark.parametrize("writer", ["pil-raw", "pil-lzw", "pil-deflate", "pil-packbits", "planar-1x1",
                                    "planar-jpeg-1x1"])
def test_ycbcr_writers_and_planes(tmp_path, writer):
    """PIL's YCbCr TIFFs (1x1, ReferenceBlackWhite written on some), 1x1
    planar, and planar JPEG (one component a plane, converted by libtiff's
    tables, not by libjpeg)."""
    img = W._img(len(writer), 33, 41)
    data = {"pil-raw": lambda: W._pil_mode(img, "YCbCr"),
            "pil-lzw": lambda: W._pil_mode(img, "YCbCr", compression="tiff_lzw"),
            "pil-deflate": lambda: W._pil_mode(img, "YCbCr", compression="tiff_adobe_deflate"),
            "pil-packbits": lambda: W._pil_mode(img, "YCbCr", compression="packbits"),
            "planar-1x1": lambda: W.tiff(img, photometric=6, planar=2, compression=5, tags=[(530, 3, [1, 1])]),
            "planar-jpeg-1x1": lambda: W.tiff_planar_jpeg(img, 6, tags=[(530, 3, [1, 1])])}[writer]()
    assert _same(tmp_path, data) is not None


YCC_REFUSED = {
    "subsampling 1x4": (lambda y: W.tiff(y, photometric=6, ycbcr=(1, 4)), "1x4"),
    "subsampling 2x4": (lambda y: W.tiff(y, photometric=6, ycbcr=(2, 4)), "2x4"),
    "subsampling 4x3": (lambda y: W.tiff(y, photometric=6, ycbcr=(4, 3)), "4x3"),
    "planar 2x2": (lambda y: W.tiff(y, photometric=6, planar=2, tags=[(530, 3, [2, 2])]), "planar YCbCr"),
    "planar default": (lambda y: W.tiff(y, photometric=6, planar=2), "planar YCbCr"),
    "planar JPEG 2x2": (lambda y: W.tiff_planar_jpeg(y.astype(np.uint8), 6), "planar YCbCr"),
    "16-bit": (lambda y: W.tiff(y * 257, bits=16, photometric=6, tags=[(530, 3, [1, 1])]), "16-bit"),
    "4 samples": (lambda y: W.tiff(np.dstack([y, y[..., :1]]), photometric=6, extra=[0], tags=[(530, 3, [1, 1])]),
                  "4 samples"),
    "luma green 0": (lambda y: W.tiff(y, photometric=6, ycbcr=(2, 1), tags=[(529, 5, [0.299, 0.0, 0.114])]),
                     "YCbCrCoefficients"),
}


@pytest.mark.parametrize("case", list(YCC_REFUSED))
def test_ycbcr_layouts_both_refuse(tmp_path, case):
    """Subsamplings libtiff has no put routine for, planar YCbCr other than
    1x1, 16-bit YCbCr, extra samples, a zero green coefficient."""
    make, cause = YCC_REFUSED[case]
    _refused(tmp_path, make(np.random.RandomState(4).randint(0, 256, (13, 17, 3))), cause)


# -- signed samples --------------------------------------------------------------------------

SIGNED_CASES = [(p, c, b) for p, c in ((0, 1), (1, 1), (2, 3), (3, 1), (5, 4), (6, 3), (8, 3)) for b in (1, 4, 8, 16)
                if not (p in (2, 5, 6, 8) and b < 8) and not (p == 3 and b == 16) and not (p in (0, 1) and b == 4)]


@pytest.mark.parametrize("photometric,channels,bits", SIGNED_CASES,
                         ids=[f"ph{p}-{b}bit" for p, _, b in SIGNED_CASES])
def test_signed_samples_read_as_their_bits(tmp_path, photometric, channels, bits):
    """SampleFormat 2: libtiff's RGBA reader takes a signed sample's bits as
    an unsigned one's (16-bit CMYK and YCbCr stay refused, as unsigned)."""
    rng = np.random.RandomState(photometric * 17 + bits)
    s = rng.randint(0, 2 ** bits, (11, 13, channels))
    kw = {"colormap": rng.randint(0, 65536, (2 ** bits, 3))} if photometric == 3 else {}
    tags = [(339, 3, [2] * channels)] + ([(530, 3, [1, 1])] if photometric == 6 else [])
    got = _same(tmp_path, W.tiff(s, bits=bits, photometric=photometric, compression=5, tags=tags,
                                 predictor=2 if bits >= 8 else 1, **kw))
    assert (got is None) == (bits == 16 and photometric in (5, 6))


@pytest.mark.parametrize("formats,cause", [([2, 1, 1], "differing"), ([3, 3, 3], "float"), ([4, 4, 4], "undefined"),
                                           ([5, 5, 5], "complex")])
def test_sample_formats_both_refuse(tmp_path, formats, cause):
    """Sample formats that differ between samples (libtiff's directory
    reader refuses them), float, undefined and complex samples."""
    _refused(tmp_path, W.tiff(np.random.RandomState(5).randint(0, 256, (9, 11, 3)), tags=[(339, 3, formats)]), cause)


# -- the committed files, chip_smoke's writers and the OPE -----------------------------------

def test_phase23_fixtures_are_cv2s_pixels():
    """``chip_smoke.py`` phase 23a's files: each decodes, by cv2 and by the
    port, to the sha256 of cv2's pixels in the manifest; each frame size is
    JAX's; layout files at most 8 kB and 70 px a side, timing files 200 kB."""
    images = os.path.join(REPO, *W.IMAGES_DIR)
    with open(os.path.join(images, W.FAX_CMYK_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    assert W.FAX_CMYK_MANIFEST == cs.FAX_CMYK_MANIFEST
    assert [c["file"] for c in manifest] == list(W.FAX_CMYK_FILES) + list(W.FAX_CMYK_TIMING_FILES)
    for c in manifest:
        path = os.path.join(images, c["file"])
        want = np.ascontiguousarray(jax_read_img(path))
        got = read_img(path)
        assert list(want.shape) == list(got.shape) == c["shape"], c["file"]
        assert cs._sha(want.tobytes()) == cs._sha(got.tobytes()) == c["sha256"], c["file"]
        assert frame_shape(path) == jax_frame_shape(path) == (c["shape"][1], c["shape"][0])
        timing = c["file"] in W.FAX_CMYK_TIMING_FILES
        assert os.path.getsize(path) < (200_000 if timing else 8_000), c["file"]
        assert timing or max(c["shape"][:2]) <= 70


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (37, 45), (90, 160), (4, 3000)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_chip_smoke_writers_read_back(tmp_path, size):
    """Phase 23's numpy writers: cv2 reads each, equal to the port; the CMYK
    file (K = 0) holds the frame exactly, the fax file its threshold, the
    YCbCr 2x2 file within its shared chroma's error."""
    img = cs.fixture_frame(size[0] * 7 + size[1], *size)
    assert np.array_equal(_same(tmp_path, cs.tiff_cmyk(img)), img)
    assert _same(tmp_path, cs.tiff_lab(img)) is not None
    ycc = _same(tmp_path, cs.tiff_ycbcr22(img)).astype(int)
    assert np.abs(ycc - img).max() <= 48
    bw = _same(tmp_path, cs.tiff_fax_mh(img))
    assert np.array_equal(bw[..., 0] == 0, img.astype(int).sum(axis=2) < 384)


def test_ope_over_cmyk_frames_equals_npy(tmp_path):
    """A short GOT-10k OPE on the CPU (one sequence, five frames): over the
    frames as CMYK TIFF (``chip_smoke.tiff_cmyk``, under their ``.jpg``
    names) equal to the same frames as ``.npy``."""
    from feartracker_tpu_torch.data.sequence import GOT10kDataset
    from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker
    from feartracker_tpu_torch.tools.make_synthetic_dataset import generate

    generate(str(tmp_path / "npy"), tracks=0, frames=5, val_sequences=1, seed=23, size=(180, 240))
    npy_root = str(tmp_path / "npy" / "got10k")
    cmyk_root = str(tmp_path / "cmyk")
    for d, _, files in os.walk(os.path.join(npy_root, "val")):
        out = os.path.join(cmyk_root, os.path.relpath(d, npy_root))
        os.makedirs(out, exist_ok=True)
        for f in files:
            src = os.path.join(d, f)
            if f.endswith(".npy"):
                with open(os.path.join(out, f[:-4] + ".jpg"), "wb") as fh:
                    fh.write(cs.tiff_cmyk(np.load(src)))
            else:
                with open(src, "rb") as a, open(os.path.join(out, f), "wb") as b:
                    b.write(a.read())
    results = {}
    for name, root in (("npy", npy_root), ("cmyk", cmyk_root)):
        ds = GOT10kDataset(root, "val")
        assert all(f.endswith("." + ("npy" if name == "npy" else "jpg")) for f in ds[0][0])
        with torch.inference_mode():
            results[name] = evaluate_tracker(cs._fear_tracker("cpu", torch.float32), ds)
    assert results["cmyk"] == results["npy"] and results["npy"]["num_sequences"] == 1


def test_ycbcr_ope_record_is_the_cpus_result(tmp_path):
    """Phase 23b(ii)'s record: phase 19c's GOT-10k val tree, made here as
    phase 19b makes it and rewritten by ``chip_smoke.tiff_ycbcr22``, holds
    the recorded file digests, and the port's OPE over it on the CPU (FEAR-XS
    float32) gives the recorded result and boxes, which the card's must
    match within 1 px and AO 0.01."""
    from feartracker_tpu_torch.data.sequence import GOT10kDataset

    with open(os.path.join(REPO, *cs.TIFF_OPE_RECORD)) as fh:
        record = json.load(fh)
    jpeg_root = cs.host_ope_tree(str(tmp_path))
    root = str(tmp_path / "ycbcr")
    cs._rewrite_tree(jpeg_root, root, cs.tiff_ycbcr22)
    assert W.tree_files(root) == record["files"]
    ds = GOT10kDataset(root, "val")
    assert [len(ds[i][0]) for i in range(len(ds))] == record["lengths"] == [12, 12]
    with torch.inference_mode():
        ao, boxes = W.ope_boxes(cs._fear_tracker("cpu", torch.float32), ds)
    assert json.loads(json.dumps(ao)) == record["ope_cpu"]
    assert boxes == record["boxes_cpu"]
    assert (cs.YCBCR_OPE_PX, cs.YCBCR_OPE_AO) == (1.0, 0.01)


def _set_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with one SHORT or LONG tag's first value replaced."""
    import struct

    d = bytearray(data)
    (ifd,) = struct.unpack("<I", d[4:8])
    (n,) = struct.unpack("<H", d[ifd:ifd + 2])
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack("<H", d[e:e + 2])[0] == tag:
            typ = struct.unpack("<H", d[e + 2:e + 4])[0]
            d[e + 8:e + 12] = struct.pack("<I", value) if typ == 4 else struct.pack("<HH", value, 0)
    return bytes(d)


@pytest.mark.parametrize("case,value,reads", [("rows a strip", 89478, True), ("rows a strip", 89479, False),
                                              ("rows a strip", 2 ** 32 - 1, True), ("rows a strip", 0, False),
                                              ("tile side", 16384, False)])
def test_strip_and_tile_sizes_cv2s_buffer_takes(tmp_path, case, value, reads):
    """OpenCV's RGBA tile buffer (4 bytes a pixel, under 1 GiB; a strip's
    height its RowsPerStrip, not cut to the image's, all-ones meaning one
    strip) and libtiff's refusal of RowsPerStrip 0: the port refuses what
    cv2 refuses, before it allocates."""
    if case == "tile side":
        data = _set_tag(_set_tag(W.tiff(np.zeros((40, 40), np.uint8), photometric=1, tile=(16, 16)), 322, value),
                        323, value)
    else:
        data = _set_tag(W.tiff(np.random.RandomState(6).randint(0, 256, (100, 3000)), photometric=1), 278, value)
    assert (_same(tmp_path, data) is not None) == reads
    if not reads:
        with pytest.raises(ValueError, match="tile buffer|RowsPerStrip 0"):
            port_imread.imread(data)
