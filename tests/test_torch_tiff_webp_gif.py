"""The port's TIFF, WebP and GIF readers and the JPEG modes beyond baseline
and progressive Huffman (``data/tiff.py``, ``data/webp.py``,
``data/gif.py``, ``csrc/jpeg.cpp``) against the JAX package's ``read_img``,
which is ``cv2.imread`` (OpenCV 5.0) + BGR->RGB: byte for byte on seeded
files of every layout the readers take, written by the fixture script's
writers, cv2 and PIL; both readers refuse the same files, the port naming
what it refuses; ``make_annotations.frame_shape`` against JAX's
``_frame_shape`` on each file; the committed fixtures of ``chip_smoke.py``
phase 21 against their manifest; ``chip_smoke``'s own writers of phase 21b
against cv2."""

import io
import json
import os
import sys

import numpy as np
import pytest

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


def _same(tmp_path, data: bytes, name: str = "frame.img", header_decides: bool = True):
    """The port's and JAX's read of one file (equal arrays, or both raise)
    and their frame sizes (equal, unless ``header_decides`` is False: a file
    whose header is sound and whose pixels cv2 refuses). → the port's array
    or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    if header_decides:
        assert frame_shape(path) == jax_frame_shape(path)
    try:
        want = jax_read_img(path)
    except IOError:
        with pytest.raises(IOError):
            read_img(path)
        return None
    got = read_img(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert frame_shape(path) == (want.shape[1], want.shape[0]) != (0, 0)
    return got


def _pil(img, fmt, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


# -- TIFF ---------------------------------------------------------------------------

TIFF_LAYOUTS = [(comp, pred, planar, lay) for comp in (1, 5, 8, 32946, 32773) for pred in (1, 2) for planar in (1, 2)
                for lay in ("strip", "strips5", "tile16", "tile16x32")]


@pytest.mark.parametrize("comp,pred,planar,layout", TIFF_LAYOUTS, ids=[f"c{c}-p{p}-pl{q}-{lay}" for c, p, q, lay
                                                                         in TIFF_LAYOUTS])
def test_tiff_compressions_predictor_planes_strips_and_tiles(tmp_path, comp, pred, planar, layout):
    """None, LZW, Deflate (both codes), PackBits; predictor 2 (undone only
    after LZW and Deflate, as libtiff does); planar 1 and 2; one strip,
    strips of 5, tiles of 16x16 and 16x32 over an image they do not divide."""
    img = W._img(comp + pred + planar, 37, 29)
    kw = {"strip": {}, "strips5": {"rows": 5}, "tile16": {"tile": (16, 16)}, "tile16x32": {"tile": (16, 32)}}[layout]
    assert _same(tmp_path, W.tiff(img, compression=comp, predictor=pred, planar=planar, **kw)) is not None


@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_tiff_byte_orders_and_bigtiff(tmp_path, bigtiff, big_endian, bits):
    img = np.random.RandomState(bits + 2 * big_endian + bigtiff).randint(0, 2 ** bits, (11, 13, 3))
    got = _same(tmp_path, W.tiff(img, bits=bits, compression=5, predictor=2, rows=3, big_endian=big_endian,
                                 bigtiff=bigtiff))
    assert np.array_equal(got, (img + 128) // 257 if bits == 16 else img)  # 16-bit: rounded, not shifted


@pytest.mark.parametrize("orientation", range(10))
def test_tiff_orientation(tmp_path, orientation):
    """1-4 flip as OpenCV applies them; 5-8 (transposing) make cv2.imread
    return None, and the port refuses them naming the orientation."""
    img = W._img(orientation, 13, 10)
    data = W.tiff(img, orientation=orientation, rows=4)
    got = _same(tmp_path, data)
    assert (got is None) == (orientation in (5, 6, 7, 8))
    if got is None:
        with pytest.raises(ValueError, match="orientation"):
            port_imread.imread(data)


@pytest.mark.parametrize("extra", [None, 0, 1, 2])
@pytest.mark.parametrize("bits,planar", [(8, 1), (8, 2), (16, 1), (16, 2)])
def test_tiff_alpha(tmp_path, extra, bits, planar):
    """Unassociated alpha (2) premultiplied as (v * a + 127) // 255, any
    other alpha dropped, grey alpha dropped."""
    rgba = np.random.RandomState(bits + planar).randint(0, 2 ** bits, (9, 11, 4))
    _same(tmp_path, W.tiff(rgba, bits=bits, extra=None if extra is None else [extra], planar=planar,
                           compression=5, predictor=2 if bits == 16 else 1))
    grey = np.random.RandomState(3).randint(0, 2 ** bits, (9, 11, 2))
    assert _same(tmp_path, W.tiff(grey, bits=bits, photometric=1, extra=[extra or 0])) is not None


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("photometric", [0, 1])
def test_tiff_grey_depths(tmp_path, bits, photometric):
    """MinIsWhite and MinIsBlack at 1, 8, 16 bits; 2 and 4 bits refused by
    OpenCV's reader, and by the port naming the depth."""
    g = np.random.RandomState(bits).randint(0, 2 ** bits, (7, 13))
    data = W.tiff(g, bits=bits, photometric=photometric, compression=5, predictor=2 if bits >= 8 else 1,
                  tile=(16, 16) if bits == 1 else None)
    got = _same(tmp_path, data)
    assert (got is None) == (bits in (2, 4))
    if got is None:
        with pytest.raises(ValueError, match=f"{bits}-bit"):
            port_imread.imread(data)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("wide_map", [False, True])
def test_tiff_palette(tmp_path, bits, wide_map):
    """1, 4 and 8 bits (2 refused by both); a ColorMap with any entry above
    255 taken as v >> 8, else as 8-bit values."""
    rng = np.random.RandomState(bits + 10 * wide_map)
    idx = rng.randint(0, 2 ** bits, (7, 13))
    cmap = rng.randint(0, 65536 if wide_map else 256, (2 ** bits, 3))
    got = _same(tmp_path, W.tiff(idx, bits=bits, photometric=3, colormap=cmap, compression=5, rows=3))
    assert (got is None) == (bits == 2)


@pytest.mark.parametrize("case", ["cv2-rgb", "cv2-rgb-strips", "cv2-grey", "ycbcr-420", "ycbcr-one-strip",
                                  "ycbcr-444", "pil-rgb"])
def test_tiff_jpeg(tmp_path, case):
    """JPEG strips with JPEGTables: RGB and grey taken as they are, YCbCr
    converted by the decoder as libtiff asks libjpeg to."""
    img = W._img(7, 37, 29)
    if case.startswith("cv2"):
        src = img[..., 0] if case == "cv2-grey" else img[..., ::-1]
        params = [cv2.IMWRITE_TIFF_COMPRESSION, 7] + ([cv2.IMWRITE_TIFF_ROWSPERSTRIP, 8] if "strips" in case else [])
        data = cv2.imencode(".tif", np.ascontiguousarray(src), params)[1].tobytes()
    elif case == "pil-rgb":
        data = _pil(img, "TIFF", compression="jpeg")
    else:
        rows = {"ycbcr-420": 16, "ycbcr-one-strip": 37, "ycbcr-444": 8}[case]
        if case == "ycbcr-444":
            segs, tables = [], None
            for y in range(0, 37, rows):
                j = cv2.imencode(".jpg", np.ascontiguousarray(img[y:y + rows, :, ::-1]),
                                 [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1].tobytes()
                t, s = W.jpeg_segments(j)
                tables = tables or t
                segs.append(s)
            data = W.tiff(img, photometric=6, compression=7, rows=rows, segments=segs, jpeg_tables=tables,
                          tags=[(530, 3, [1, 1])])
        else:
            data = W.tiff_ycbcr_jpeg(img, rows=rows)
    assert _same(tmp_path, data) is not None


@pytest.mark.parametrize("compression,name,cv2_reads", [(3, "CCITT Group 3", True), (4, "CCITT Group 4", True),
                                                        (6, "old-style JPEG", None), (34925, "LZMA", False),
                                                        (50000, "ZSTD", False)])
def test_tiff_compressions_not_read_raise_naming_them(tmp_path, compression, name, cv2_reads):
    """Compressions the port does not read raise naming the codec. This cv2
    build lacks LZMA and ZSTD too. CCITT Group 3 and 4, which cv2 reads,
    the port reads since its CCITT decoders came (``csrc/imgcodecs.cpp:
    tiff_fax``): equal to cv2 there."""
    img = (np.random.RandomState(0).rand(20, 32) > 0.5).astype(np.uint8)
    if cv2_reads:
        data = _pil(img.astype(bool), "TIFF", compression={3: "group3", 4: "group4"}[compression])
    else:
        data = W.tiff(img * 255, photometric=1, compression=compression, segments=[bytes(64)])
    path = tmp_path / "codec.tif"
    path.write_bytes(data)
    if cv2_reads is not None:
        assert (cv2.imread(str(path)) is not None) == cv2_reads
    if cv2_reads:
        assert np.array_equal(_same(tmp_path, data), np.repeat(img[..., None] * 255, 3, axis=2))
        return
    with pytest.raises(ValueError, match=name):
        port_imread.imread(data)
    with pytest.raises(IOError, match=name):
        read_img(str(path))
    assert frame_shape(str(path)) == (0, 0)


def test_tiff_from_pil_and_cv2(tmp_path):
    """Files of the two writers users have: PIL (LZW, Deflate, PackBits,
    RGBA, palette, grey, 1-bit) and cv2 (its defaults, 16-bit grey)."""
    img = W._img(3, 31, 43)
    for kw in ({"compression": "tiff_lzw"}, {"compression": "tiff_adobe_deflate"}, {"compression": "packbits"}, {}):
        assert _same(tmp_path, _pil(img, "TIFF", **kw)) is not None
    from PIL import Image

    for mode in ("RGBA", "P", "L", "1"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, "TIFF", compression="tiff_lzw")
        assert _same(tmp_path, buf.getvalue()) is not None
    assert _same(tmp_path, cv2.imencode(".tif", img)[1].tobytes()) is not None
    g16 = np.random.RandomState(4).randint(0, 65536, (19, 21)).astype(np.uint16)
    got = _same(tmp_path, cv2.imencode(".tif", g16)[1].tobytes())
    assert np.array_equal(got[..., 0], (g16 >> 8).astype(np.uint8))  # grey 16-bit: the high byte


# -- GIF ----------------------------------------------------------------------------

GIF_CASES = ["plain", "interlaced", "1x1", "256-colours", "local-table", "local-only", "transparent", "transparent-bg",
             "transparent-no-global", "offset", "offset-transparent", "outside-screen", "two-frames", "min-size-2",
             "min-size-5", "index-past-table", "gif87a", "long-clears"]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif(tmp_path, case):
    """OpenCV's own decoder's first frame: the screen starts as the global
    table's background colour (black without one), transparent pixels keep
    it, an image outside the screen or an index past the table is refused
    by both."""
    rng = np.random.RandomState(GIF_CASES.index(case))
    pal = np.array([[10 * i, 255 - 7 * i, (37 * i) % 256] for i in range(16)])
    idx = rng.randint(0, 16, (9, 12))
    kw, screen, table, bg, version = {}, (12, 9), pal, 0, b"GIF89a"
    if case == "interlaced":
        idx, kw = rng.randint(0, 16, (33, 17)), {"interlace": True}
        screen = (17, 33)
    elif case == "1x1":
        idx, screen = idx[:1, :1], (1, 1)
    elif case == "256-colours":
        idx, table, screen = rng.randint(0, 256, (40, 45)), rng.randint(0, 256, (256, 3)), (45, 40)
    elif case == "local-table":
        kw = {"palette": pal[::-1]}
    elif case == "local-only":
        kw, table = {"palette": pal[::-1]}, None
    elif case in ("transparent", "transparent-bg"):
        kw, bg = {"transparent": 5}, 2 if case == "transparent" else 5
    elif case == "transparent-no-global":
        kw, table, bg = {"transparent": 5, "palette": pal}, None, 2
    elif case in ("offset", "offset-transparent", "outside-screen"):
        kw = {"left": 3 if case != "outside-screen" else 13, "top": 2}
        if case == "offset-transparent":
            kw["transparent"] = 1
        screen, bg = (20, 15), 7
    elif case == "min-size-2":
        idx, kw = rng.randint(0, 4, (9, 12)), {"min_size": 2}
    elif case == "min-size-5":
        kw = {"min_size": 5}
    elif case == "index-past-table":
        table = pal[:8]
    elif case == "gif87a":
        version = b"GIF87a"
    elif case == "long-clears":  # the table fills and clears many times
        idx, table, screen = np.repeat(rng.randint(0, 256, (1, 3000)), 12, 0), rng.randint(0, 256, (256, 3)), (3000, 12)
    frames = [dict(indices=idx, **kw)]
    if case == "two-frames":
        frames.append(dict(indices=idx[::-1]))
    data = W.gif(frames, screen, table, background=bg, version=version)
    got = _same(tmp_path, data, header_decides=case != "index-past-table")
    assert (got is None) == (case in ("outside-screen", "index-past-table"))
    if case == "index-past-table":  # frame_shape reads the header alone: cv2 fails only on the pixels
        assert frame_shape(str(tmp_path / "frame.img")) == screen


def test_gif_from_pil_and_cv2(tmp_path):
    img = W._img(5, 30, 40)
    from PIL import Image

    for kw in ({}, {"interlace": True, "transparency": 3}):
        assert _same(tmp_path, _pil(img, "GIF", **kw)) is not None
    assert _same(tmp_path, _pil(np.asarray(Image.fromarray(img).convert("P").convert("RGB")), "GIF")) is not None
    assert _same(tmp_path, cv2.imencode(".gif", img[..., ::-1])[1].tobytes()) is not None


# -- WebP ---------------------------------------------------------------------------

WEBP_SIZES = [(1, 1), (7, 5), (16, 16), (33, 47), (64, 70)]


@pytest.mark.parametrize("quality", [5, 50, 90, 100, 101])
@pytest.mark.parametrize("size", WEBP_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_webp_cv2_lossy_and_lossless(tmp_path, quality, size):
    """cv2's own writer at qualities 5-100 (lossy) and 101 (lossless)."""
    h, w = size
    img = W._img(h * 100 + w, h, w)
    data = cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
    assert data[12:16] == (b"VP8L" if quality > 100 else b"VP8 ")
    got = _same(tmp_path, data)
    if quality > 100:
        assert np.array_equal(got, img)


@pytest.mark.parametrize("method", range(7))
def test_webp_pil_methods(tmp_path, method):
    """libwebp's encoder at every effort: other segment, filter and
    partition choices; lossless with its transforms."""
    img = W._img(method, 45, 61)
    for q in (0, 75):
        _same(tmp_path, _pil(img, "WEBP", quality=q, method=method))
    assert np.array_equal(_same(tmp_path, _pil(img, "WEBP", lossless=True, method=method, quality=q)), img)


REHEADER = {"simple": dict(simple=1), "simple-level40-sharp2": dict(simple=1, level=40, sharpness=2),
            "sharpness3": dict(sharpness=3), "sharpness6-level50": dict(sharpness=6, level=50),
            "lf-deltas": dict(lf_deltas=((5, -3, 2, 1), (-4, 2, 3, -1))), "level0": dict(level=0),
            "lf-delta-negative": dict(lf_deltas=((-60, 0, 0, 0), (10, 0, 0, 0))),
            "relative-segments": dict(segment_deltas=(0, [3, -5, 7, 0], [10, -20, 5, 0])),
            "absolute-segments-simple": dict(segment_deltas=(1, [10, 40, 80, 127], [0, 20, 40, 63]), simple=1)}


@pytest.mark.parametrize("quality", [20, 90])
@pytest.mark.parametrize("case", list(REHEADER))
def test_webp_loop_filter_and_segment_headers(tmp_path, quality, case):
    """The header paths libwebp's encoder never writes (the simple filter,
    sharpness, loop-filter deltas, relative segment data): cv2's own file
    with its partition 0 re-encoded with those fields (``vp8_reheader``);
    cv2 reads each, the port gives its pixels."""
    img = W._img(quality, 70, 90)
    data = cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
    kind, frame = W.webp_bitstream(data)
    assert _same(tmp_path, W.webp_riff([W.webp_chunk(kind, W.vp8_reheader(frame, **REHEADER[case]))])) is not None


@pytest.mark.parametrize("case", ["alpha-lossy", "alpha-lossless", "alpha-lossless-exact", "palette-2", "palette-4",
                                  "palette-16", "palette-200", "noise-lossless", "noise-lossy"])
def test_webp_alpha_and_lossless_transforms(tmp_path, case):
    """VP8X files with ALPH (the alpha dropped, not applied) and lossless
    files that take the colour-indexing transform (pixel bundling at 2, 4
    and 16 colours) or none."""
    rng = np.random.RandomState(len(case))
    if case.startswith("alpha"):
        img = np.concatenate([W._img(3, 40, 50), rng.randint(0, 256, (40, 50, 1)).astype(np.uint8)], -1)
        img[5:10, 5:10, 3] = 0
        data = _pil(img, "WEBP", lossless="lossless" in case, exact="exact" in case, quality=80)
    elif case.startswith("palette"):
        n = int(case.split("-")[1])
        img = rng.randint(0, 256, (n, 3)).astype(np.uint8)[rng.randint(0, n, (30, 41))]
        data = _pil(img, "WEBP", lossless=True)
    else:
        img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        data = _pil(img, "WEBP", lossless=case.endswith("lossless"), quality=90)
    got = _same(tmp_path, data)
    if case.startswith("palette") or case in ("noise-lossless", "alpha-lossless-exact"):
        assert np.array_equal(got, img[..., :3])


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("case", ["anim-pil", "anim-offset", "anim-offset-background", "vp8x", "exif6-flag",
                                  "exif-no-flag", "exif-after", "size-mismatch", "unknown-chunk", "simple-trailing-exif"])
def test_webp_containers(tmp_path, lossless, case):
    """The first frame of an animation on a transparent black canvas (the
    ANIM background ignored); the VP8X EXIF orientation applied when the
    EXIF flag is set; a bitstream of another size than the canvas refused
    by both."""
    img = W._img(4, 20, 30)
    if case == "anim-pil":
        from PIL import Image

        frames = [Image.fromarray(W._img(s, 20, 30)) for s in range(3)]
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=lossless, quality=80)
        data = buf.getvalue()
    else:
        small = img[:10, :12] if case.startswith("anim") else img
        kind, payload = W.webp_bitstream(_pil(np.ascontiguousarray(small), "WEBP", lossless=lossless, quality=80))
        bs = W.webp_chunk(kind, payload)
        exif = W.webp_chunk(b"EXIF", W.tiff_orientation(6))
        if case.startswith("anim-offset"):
            bg = (255, 10, 20, 255) if case.endswith("background") else (0, 0, 0, 0)
            data = W.webp_animation((30, 20), [(4, 6, 12, 10, bs, 0), (0, 0, 12, 10, bs, 0)], background=bg)
        elif case == "vp8x":
            data = W.webp_extended((30, 20), [bs])
        elif case == "exif6-flag":
            data = W.webp_extended((30, 20), [exif, bs], flags=0x08)
        elif case == "exif-no-flag":
            data = W.webp_extended((30, 20), [exif, bs])
        elif case == "exif-after":
            data = W.webp_extended((30, 20), [bs, W.webp_chunk(b"EXIF", W.tiff_orientation(3))], flags=0x08)
        elif case == "size-mismatch":
            data = W.webp_extended((31, 20), [bs])
        elif case == "unknown-chunk":
            data = W.webp_extended((30, 20), [W.webp_chunk(b"ABCD", b"xyz"), bs])
        else:
            data = W.webp_riff([bs, exif])
    got = _same(tmp_path, data)
    assert (got is None) == (case == "size-mismatch")
    if case == "exif6-flag":
        assert got.shape[:2] == (30, 20)


# -- JPEG modes ---------------------------------------------------------------------

S420 = [(2, 2), (1, 1), (1, 1)]
SCANS = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
         ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
ARITH_CASES = [(s, m) for s in ((8, 8), (37, 45), (17, 64), (1, 1))
               for m in ("seq-420", "seq-444", "seq-422-dac-restart", "prog-420", "prog-444-restart-dac", "grey",
                         "grey-prog")]


@pytest.mark.parametrize("size,mode", ARITH_CASES, ids=[f"{s[0]}x{s[1]}-{m}" for s, m in ARITH_CASES])
def test_jpeg_arithmetic(tmp_path, size, mode):
    """Arithmetic-coded files (SOF9 and SOF10, T.81's QM coder, DAC
    conditioning, restarts) written by the fixture script's jcarith.c
    twin: cv2 reads them, and the port gives its pixels, which equal the
    Huffman-coded file's of the same coefficients."""
    img = W._img(size[0] + size[1], *size)
    samp = {"420": S420, "444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)]}.get((mode.split("-") + [""])[1], [(1, 1)])
    planes = [img[..., 0]] if mode.startswith("grey") else W.sub_planes(img, samp)
    kw = {}
    if "prog" in mode:
        kw["scans"] = SCANS if len(planes) == 3 else [((0,), 0, 0, 0, 0), ((0,), 1, 63, 0, 1), ((0,), 1, 63, 1, 0)]
    if "dac" in mode:
        kw["dac"] = (2, 5, 20) if "seq" in mode else (1, 3, 9)
    if "restart" in mode:
        kw["restart"] = 2 if "seq" in mode else 3
    got = _same(tmp_path, W.jpeg_arithmetic(planes, samp, **kw))
    assert got is not None
    assert np.array_equal(got, _same(tmp_path, W.jpeg_baseline(planes, samp, jfif=True)))


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt,restart", [(0, 0), (2, 0), (0, 3), (3, 2)])
def test_jpeg_lossless(tmp_path, predictor, pt, restart):
    """Lossless RGB (SOF3): every predictor, point transforms and restarts;
    the samples come back as (v >> pt) << pt."""
    rgb = np.random.RandomState(predictor).randint(0, 256, (19, 13, 3))
    got = _same(tmp_path, W.jpeg_lossless([rgb[..., c] for c in range(3)], predictor=predictor, pt=pt,
                                          restart=restart))
    assert np.array_equal(got, (rgb >> pt) << pt)


def test_jpeg_lossless_low_precision_and_cmyk(tmp_path):
    rng = np.random.RandomState(1)
    six = rng.randint(0, 64, (9, 13, 3))
    assert np.array_equal(_same(tmp_path, W.jpeg_lossless([six[..., c] for c in range(3)], precision=6)), six)
    assert _same(tmp_path, W.jpeg_lossless([rng.randint(0, 256, (9, 13)) for _ in range(4)])) is not None


REFUSED_FILES = {
    "lossless grey": lambda img: W.jpeg_lossless([img[..., 0]]),
    "lossless YCbCr": lambda img: W.jpeg_lossless([img[..., c] for c in range(3)], jfif=True),
    "12-bit lossless": lambda img: W.jpeg_lossless([img[..., c].astype(int) * 16 for c in range(3)], precision=12),
    "16-bit lossless": lambda img: W.jpeg_lossless([img[..., c].astype(int) * 257 for c in range(3)], precision=16),
    "12-bit": lambda img: W.jpeg_12bit(img[..., 0].astype(int) * 16),
    "hierarchical": lambda img: W.jpeg_hierarchical(cv2.imencode(".jpg", img)[1].tobytes()),
    "DNL": lambda img: W.jpeg_dnl(cv2.imencode(".jpg", img)[1].tobytes()),
    "2-component": lambda img: W.jpeg_baseline([img[..., 0], img[..., 1]], [(1, 1), (1, 1)]),
}


@pytest.mark.parametrize("mode", list(REFUSED_FILES))
def test_jpeg_modes_cv2_refuses_are_refused_naming_them(tmp_path, mode):
    """Real files of each kind cv2.imread reads nothing of (libjpeg-turbo
    refuses them, or OpenCV's 8-bit path has no conversion for them): both
    readers refuse, the port naming the mode, and the frame size is (0, 0)."""
    data = REFUSED_FILES[mode](W._img(9, 20, 28))
    assert _same(tmp_path, data, "refused.jpg") is None
    with pytest.raises(ValueError, match=mode):
        port_imread.imread(data)
    assert frame_shape(str(tmp_path / "refused.jpg")) == (0, 0)


# -- the other formats, the header text, the committed files and phase 21b's writers ---------

@pytest.mark.parametrize("ext,name", [(".jp2", "jp2"), (".pfm", "pfm"), (".pam", "pam"), (".hdr", "hdr"),
                                      (".ras", "sun"), (".avif", "AVIF")])
def test_formats_still_unread_are_named(tmp_path, ext, name):
    """cv2 reads these. JPEG 2000, PFM, PAM, Radiance HDR and Sun raster, as
    cv2 writes them, the port reads equal to cv2; AVIF, the one still unread
    (ROADMAP Queue 3), it names in its IOError."""
    img = np.random.RandomState(0).randint(0, 256, (64, 80, 3)).astype(np.uint8)
    data = cv2.imencode(ext, img.astype(np.float32) / 255 if ext in (".pfm", ".hdr") else img)[1].tobytes()
    path = tmp_path / f"a{ext}"
    path.write_bytes(data)
    assert cv2.imread(str(path)) is not None
    assert port_imread.format_of(data) == name
    if name == "AVIF":
        with pytest.raises(IOError, match=name):
            read_img(str(path))
    else:
        assert np.array_equal(read_img(str(path)), jax_read_img(str(path)))


def test_phase21_fixtures_are_cv2s_pixels():
    """``chip_smoke.py`` phase 21a's files: each decodes, by cv2 and by the
    port, to the sha256 of cv2's pixels in the manifest; each frame size is
    JAX's."""
    images = os.path.join(REPO, *W.IMAGES_DIR)
    with open(os.path.join(images, W.FORMAT_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    assert [c["file"] for c in manifest] == list(W.FORMAT_FILES) + list(W.TIMING_FILES)
    for c in manifest:
        path = os.path.join(images, c["file"])
        want = np.ascontiguousarray(jax_read_img(path))
        got = read_img(path)
        assert list(want.shape) == list(got.shape) == c["shape"], c["file"]
        assert W.chip_smoke._sha(want.tobytes()) == W.chip_smoke._sha(got.tobytes()) == c["sha256"], c["file"]
        assert frame_shape(path) == jax_frame_shape(path) == (c["shape"][1], c["shape"][0])
        assert os.path.getsize(path) < (200_000 if c["file"] in W.TIMING_FILES else 8_000), c["file"]
        if c["file"] in W.FORMAT_FILES:
            assert max(c["shape"][:2]) <= 70


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (37, 45), (120, 160)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_chip_smoke_writers_read_back(tmp_path, size):
    """Phase 21b/c's writers (literal-code LZW TIFF and GIF, an uncompressed
    lossless WebP): cv2 reads each, equal to the port; TIFF and WebP hold
    the frame exactly."""
    cs = W.chip_smoke
    img = cs.fixture_frame(size[0] * 7 + size[1], *size)
    for write in (cs.tiff_lzw, cs.webp_lossless, cs.gif_332):
        got = _same(tmp_path, write(img))
        if write is not cs.gif_332:
            assert np.array_equal(got, img)
