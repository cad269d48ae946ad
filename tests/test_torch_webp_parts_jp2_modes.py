"""The port's WebP reader on VP8 frames of 2, 4 and 8 token partitions
(``data/webp.py`` + ``csrc/webp.cpp``), its JPEG 2000 reader on the coding
modes (``data/jp2.py`` + ``csrc/jp2.cpp``: the six code-block styles, ROI
max-shift, POC, SOP/EPH, tile-parts in every progression) and its JPEG
reader on SOF11, against the JAX package's ``read_img``, which is
``cv2.imread`` (OpenCV 5.0: libwebp, OpenJPEG 2.5.3, libjpeg-turbo 3.1) +
BGR->RGB: byte for byte on files written by the encoders PIL bundles
(``pillow.libs``: libwebp 1.6, OpenJPEG 2.5.4, libjpeg-turbo) through the
fixture script's ctypes writers; each file holds what it is named for (its
VP8 header's partition count, its codestream's markers); the committed
files of ``chip_smoke.py`` phase 24a against their manifest and against a
fresh write; the GOT-10k OPE over phase 19c's tree as 4-partition WebP
against the record that phase 24b holds the card to. SOF11: no writer here
codes it (libjpeg-turbo's lossless compressor refuses arithmetic coding),
and both readers refuse an SOF11 frame, the port naming it."""

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

cs = W.chip_smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The OPE case runs FEAR-XS on the CPU: one intra-op thread, as the
    other heavy port files pin it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(tmp_path, data: bytes, name: str):
    """The port's and JAX's read of one file: equal arrays and frame sizes.
    → the port's array."""
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    want = jax_read_img(path)
    got = read_img(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert frame_shape(path) == jax_frame_shape(path) == (want.shape[1], want.shape[0])
    return got


# -- VP8 with 2, 4 and 8 token partitions ----------------------------------------------

WEBP_SIZES = [(1, 1), (16, 16), (24, 70), (37, 45), (130, 18), (70, 70)]


@pytest.mark.parametrize("partitions", [1, 2, 3])
@pytest.mark.parametrize("size", WEBP_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("method", [0, 2])
def test_vp8_token_partitions(tmp_path, partitions, size, method):
    """2, 4 or 8 partitions, macroblock rows fewer than, as many as and more
    than the partitions (rows go to partitions in turn), libwebp's two
    macroblock coders below its token loop."""
    img = W._img(1000 + 7 * size[0] + size[1] + partitions, *size)
    data = W.webp_libwebp(img, 70.0, partitions=partitions, method=method)
    head = W.vp8_header(data)
    assert head["partitions"] == 1 << partitions and head["mb_rows"] == -(-size[0] // 16)
    got = _same(tmp_path, data, "parts.webp")
    assert np.abs(got.astype(int) - img).mean() < 40


@pytest.mark.parametrize("options", [dict(segments=1), dict(segments=4, sns_strength=100), dict(filter_type=0),
                                     dict(filter_strength=0), dict(filter_sharpness=7, filter_strength=100),
                                     dict(use_sharp_yuv=1), dict(preprocessing=2)],
                         ids=["seg1", "seg4-sns100", "simple-filter", "no-filter", "sharpness7", "sharp-yuv", "dither"])
@pytest.mark.parametrize("quality", [5.0, 50.0, 100.0])
def test_vp8_partitions_with_encoder_options(tmp_path, options, quality):
    """8 partitions beside segments, SNS, both loop filters and their
    strengths, sharp YUV and the encoder's pre-processing, at three
    qualities."""
    img = W._img(int(quality) + len(options) * 31 + sum(map(int, options.values())), 53, 67)
    data = W.webp_libwebp(img, quality, partitions=3, method=1, **options)
    assert W.vp8_header(data)["partitions"] == 8
    _same(tmp_path, data, "options.webp")


def test_vp8_partitions_in_vp8x_and_with_alpha(tmp_path):
    """8 partitions in a VP8X file, and under an ALPH chunk (the alpha
    dropped, as cv2.imread drops it)."""
    img = W._img(1101, 41, 36)
    vp8 = W.webp_bitstream(W.webp_libwebp(img, 80.0, partitions=3, method=2))[1]
    _same(tmp_path, W.webp_extended((36, 41), [W.webp_chunk(b"VP8 ", vp8)]), "vp8x.webp")
    alpha = W.webp_extended((36, 41), [W.webp_chunk(b"ALPH", b"\x00" + bytes(range(256)) * 6), W.webp_chunk(b"VP8 ", vp8)],
                            flags=0x10)
    _same(tmp_path, alpha, "alpha.webp")


def test_libwebp_writes_one_partition_at_methods_3_to_6():
    """The reason the committed files are written at methods 0-2: libwebp's
    token loop (methods 3-6) writes one partition whatever ``partitions``
    asks, and the writer refuses to pass that off as more."""
    with pytest.raises(ValueError, match="methods 3-6"):
        W.webp_libwebp(W._img(1102, 30, 30), 75.0, partitions=2, method=4)
    assert W.vp8_header(W.webp_libwebp(W._img(1102, 30, 30), 75.0, partitions=0, method=4))["partitions"] == 1


# -- JPEG 2000 coding modes -------------------------------------------------------------

def _cod(data: bytes) -> dict:
    """The main header's COD: Scod, progression, layers, code-block style."""
    body = next(b for where, m, b in W.j2k_markers(data) if where == "main" and m == 0xFF52)
    scod, prog, layers, _mct, _levels, _xcb, _ycb, style = struct.unpack(">BBHBBBBB", body[:9])
    return {"scod": scod, "progression": prog, "layers": layers, "style": style}


@pytest.mark.parametrize("mode", [1, 2, 4, 8, 16, 32, 5, 9, 12, 48, 63])
@pytest.mark.parametrize("transform", ["53", "97"])
@pytest.mark.parametrize("cblk", [64, 16])
def test_jp2_code_block_styles(tmp_path, mode, transform, cblk):
    """Each code-block style bit alone, pairs and all six, on the 5/3
    (lossless last layer) and 9/7 transforms, at two code-block sizes, in
    three quality layers: the COD carries the style, the pixels are cv2's."""
    img = W._img(1200 + mode + cblk, 49, 57)
    rates = (30, 8, 0) if transform == "53" else (30, 8, 2)
    data = W.jp2_openjpeg(img, rates=rates, irreversible=transform == "97", mode=mode, cblockw_init=cblk,
                          cblockh_init=cblk)
    assert _cod(data)["style"] == mode and _cod(data)["layers"] == 3
    _same(tmp_path, data, "mode.jp2")


@pytest.mark.parametrize("comp,shift", [(0, 7), (1, 3), (2, 12), (0, 1)])
@pytest.mark.parametrize("transform", ["53", "97"])
def test_jp2_roi_max_shift(tmp_path, comp, shift, transform):
    """ROI max-shift on one component: its RGN marker, cv2's pixels."""
    img = W._img(1300 + comp * 13 + shift, 43, 51)
    data = W.jp2_openjpeg(img, rates=(25, 0) if transform == "53" else (25, 4), irreversible=transform == "97",
                          roi_compno=comp, roi_shift=shift)
    rgn = [b for _, m, b in W.j2k_markers(data) if m == 0xFF5E]
    assert [(r[0], r[1], r[2]) for r in rgn] == [(comp, 0, shift)]
    _same(tmp_path, data, "roi.jp2")


@pytest.mark.parametrize("records", [
    [(1, 0, 0, 2, 3, 3, "RLCP"), (1, 0, 0, 3, 6, 3, "CPRL")],
    [(1, 0, 0, 1, 6, 3, "LRCP"), (1, 0, 0, 3, 6, 3, "RPCL")],
    [(1, 0, 0, 3, 6, 1, "PCRL"), (1, 0, 1, 3, 6, 3, "LRCP")],
    [(1, 2, 0, 3, 6, 3, "RLCP"), (1, 0, 0, 3, 2, 3, "RLCP")],
], ids=["rlcp-cprl", "lrcp-rpcl", "comp0-rest", "high-then-low"])
def test_jp2_two_poc_records(tmp_path, records):
    """Two progression-order changes (OpenJPEG writes them in the tile's
    header, one tile-part each): cv2's pixels."""
    img = W._img(1400 + len(str(records)), 52, 44)
    data = W.jp2_openjpeg(img, rates=(20, 5, 0), poc=records)
    markers = W.j2k_markers(data)
    assert sum(m == 0xFF5F for _, m, _ in markers) == 1
    assert sum(m == 0xFF90 for _, m, _ in markers) == 2
    _same(tmp_path, data, "poc.jp2")


@pytest.mark.parametrize("csty", [2, 4, 6])
@pytest.mark.parametrize("progression", ["LRCP", "RPCL"])
def test_jp2_sop_and_eph(tmp_path, csty, progression):
    """SOP before and EPH after every packet header, alone and together:
    one SOP a packet where asked, cv2's pixels."""
    img = W._img(1500 + csty, 41, 57)
    data = W.jp2_openjpeg(img, rates=(30, 8, 2), irreversible=True, csty=csty, progression=progression)
    assert _cod(data)["scod"] & 6 == csty
    assert (data.count(b"\xff\x91") > 0) == bool(csty & 2) and (data.count(b"\xff\x92") > 0) == bool(csty & 4)
    _same(tmp_path, data, "sop.jp2")


@pytest.mark.parametrize("flag", ["R", "L", "C"])
@pytest.mark.parametrize("progression", list(W.OPJ_PROGRESSIONS))
def test_jp2_tile_parts_in_every_progression(tmp_path, flag, progression):
    """Tiles split into tile-parts by resolution, layer or component in
    each of the five progressions: several SOTs a tile, cv2's pixels."""
    img = W._img(1600 + ord(flag) + W.OPJ_PROGRESSIONS[progression], 61, 67)
    data = W.jp2_openjpeg(img, rates=(20, 4), irreversible=True, tile=(32, 32), tp_flag=flag, numresolution=4,
                          progression=progression)
    sots = [struct.unpack(">HIBB", b[:8]) for _, m, b in W.j2k_markers(data) if m == 0xFF90]
    per_tile = {}
    for isot, _psot, tpsot, tnsot in sots:
        per_tile.setdefault(isot, []).append((tpsot, tnsot))
    assert len(per_tile) == 6 and all(len(v) > 1 for v in per_tile.values())
    _same(tmp_path, data, "tp.jp2")


def test_openjpeg_writes_no_coc_qcc_ppm_ppt_or_tile_cod():
    """The markers no writer here makes, which ``ROADMAP.md`` lists as
    unverified: OpenJPEG's encoder writes none of COC, QCC, PPM, PPT, nor a
    COD or QCD in a tile-part header, over every layout the fixtures use."""
    seen = set()
    for _kind, make in W.JP2_MODE_FILES.values():
        seen |= {(where, m) for where, m, _ in W.j2k_markers(make())}
    assert not {m for _, m in seen} & {0xFF53, 0xFF5D, 0xFF60, 0xFF61}
    assert not {m for where, m in seen if where == "tile"} & {0xFF52, 0xFF5C}
    assert ("tile", 0xFF5F) in seen and ("main", 0xFF5E) in seen


# -- SOF11 -----------------------------------------------------------------------------

@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("channels", [3, 1])
def test_sof11_no_writer_here(predictor, channels):
    """libjpeg-turbo's lossless compressor (``jpeg_enable_lossless``) refuses
    arithmetic coding for every predictor and for grey and RGB: no SOF11
    file can be written here, and ``csrc/jpeg.cpp`` keeps refusing it."""
    img = W._img(1700 + predictor, 19, 23)
    data, err = W.libjpeg_lossless(img if channels == 3 else img[..., 0], predictor, predictor % 3, arith=True)
    assert data is None and "arithmetic coding is not implemented" in err


@pytest.mark.parametrize("predictor,pt,restart_rows", [(1, 0, 0), (2, 0, 1), (3, 1, 0), (4, 0, 2), (5, 2, 3),
                                                       (6, 0, 0), (7, 3, 5)])
def test_libjpeg_lossless_huffman_against_cv2(tmp_path, predictor, pt, restart_rows):
    """The same writer in Huffman mode (SOF3) is read by both readers alike:
    RGB equal to cv2's pixels (and the frame, shifted by the point
    transform), grey refused by both."""
    img = W._img(1750 + predictor, 29, 37)
    data, err = W.libjpeg_lossless(img, predictor, pt, restart_rows=restart_rows)
    assert not err and b"\xff\xc3" in data and (b"\xff\xdd" in data) == bool(restart_rows)
    assert np.array_equal(_same(tmp_path, data, "sof3.jpg"), (img >> pt) << pt)
    grey, _ = W.libjpeg_lossless(img[..., 0], predictor, pt, restart_rows=restart_rows)
    path = str(tmp_path / "grey.jpg")
    with open(path, "wb") as fh:
        fh.write(grey)
    with pytest.raises(IOError):
        jax_read_img(path)
    with pytest.raises(ValueError, match="lossless grey"):
        port_imread.imread(grey)


@pytest.mark.parametrize("channels", [3, 4])
def test_sof11_frame_refused_by_both_readers(tmp_path, channels):
    """A lossless JPEG's frame relabelled SOF11: cv2 reads nothing, the
    port raises naming SOF11, and both frame sizes are (0, 0)."""
    rng = np.random.RandomState(17 + channels)
    planes = [rng.randint(0, 256, (21, 27)) for _ in range(channels)]
    data = W.sof11_frame(W.jpeg_lossless(planes, predictor=4))
    assert b"\xff\xcb" in data and b"\xff\xc3" not in data
    path = str(tmp_path / "sof11.jpg")
    with open(path, "wb") as fh:
        fh.write(data)
    with pytest.raises(IOError):
        jax_read_img(path)
    with pytest.raises(ValueError, match="SOF11"):
        port_imread.imread(data)
    assert frame_shape(path) == jax_frame_shape(path) == (0, 0)


# -- the committed files and the OPE ----------------------------------------------------

PHASE24_FILES = {**W.WEBP_PARTS_FILES, **W.JP2_MODE_FILES, **W.WEBP_PARTS_JP2_TIMING_FILES}


def test_phase24_fixtures_are_cv2s_pixels():
    """``chip_smoke.py`` phase 24a's files: each decodes, by cv2 and by the
    port, to the sha256 of cv2's pixels in the manifest; each frame size is
    JAX's; layout files at most 10 kB and 70 px a side, timing files 200 kB;
    each WebP layout file holds 2 to 8 partitions, one of them more
    partitions than macroblock rows."""
    images = os.path.join(REPO, *W.IMAGES_DIR)
    with open(os.path.join(images, W.WEBP_PARTS_JP2_MANIFEST)) as fh:
        manifest = json.load(fh)["decode"]
    assert W.WEBP_PARTS_JP2_MANIFEST == cs.WEBP_PARTS_JP2_MANIFEST
    assert [c["file"] for c in manifest] == list(PHASE24_FILES)
    heads = []
    for c in manifest:
        path = os.path.join(images, c["file"])
        want = np.ascontiguousarray(jax_read_img(path))
        got = read_img(path)
        assert list(want.shape) == list(got.shape) == c["shape"], c["file"]
        assert cs._sha(want.tobytes()) == cs._sha(got.tobytes()) == c["sha256"], c["file"]
        assert frame_shape(path) == jax_frame_shape(path) == (c["shape"][1], c["shape"][0])
        timing = c["file"] in W.WEBP_PARTS_JP2_TIMING_FILES
        assert os.path.getsize(path) < (200_000 if timing else 10_000), c["file"]
        assert timing or max(c["shape"][:2]) <= 70
        if c["file"].endswith(".webp"):
            with open(path, "rb") as fh:
                heads.append(W.vp8_header(fh.read()))
    assert {h["partitions"] for h in heads} == {2, 4, 8}
    assert any(h["mb_rows"] < h["partitions"] for h in heads)


@pytest.mark.parametrize("name", list(PHASE24_FILES))
def test_phase24_writers_rewrite_the_committed_bytes(name):
    """Both encoders are deterministic: writing each committed file again
    gives its bytes."""
    with open(os.path.join(REPO, *W.IMAGES_DIR, name), "rb") as fh:
        assert PHASE24_FILES[name][1]() == fh.read()


def test_webp_ope_record_is_the_cpus_result(tmp_path):
    """Phase 24b's tree and record: phase 19c's GOT-10k val tree, made here
    as phase 19b makes it and written by libwebp with 4 token partitions,
    gives the committed files byte for byte; the port's OPE over the
    committed tree on the CPU (FEAR-XS float32) gives the recorded result
    and boxes, which the card's must match within 1 px and AO 0.01."""
    from feartracker_tpu_torch.data.sequence import GOT10kDataset

    root = os.path.join(REPO, *cs.WEBP_TREE)
    with open(os.path.join(root, cs.WEBP_TREE_RECORD)) as fh:
        record = json.load(fh)
    assert W.tree_files(root) == record["files"]
    jpeg_root = cs.host_ope_tree(str(tmp_path))
    fresh = str(tmp_path / "webp")
    cs._rewrite_tree(jpeg_root, fresh, lambda img: W.webp_libwebp(img, W.WEBP_TREE_QUALITY,
                                                                  partitions=W.WEBP_TREE_PARTITIONS, method=2))
    assert W.tree_files(fresh) == record["files"]
    with open(os.path.join(root, "val", "GOT-10k_Val_000000", "00000000.jpg"), "rb") as fh:
        assert W.vp8_header(fh.read())["partitions"] == record["partitions"] == 4
    ds = GOT10kDataset(root, "val")
    assert [len(ds[i][0]) for i in range(len(ds))] == record["lengths"] == [12, 12]
    with torch.inference_mode():
        ao, boxes = W.ope_boxes(cs._fear_tracker("cpu", torch.float32), ds)
    assert json.loads(json.dumps(ao)) == record["ope_cpu"]
    assert boxes == record["boxes_cpu"]
    assert (cs.WEBP_OPE_PX, cs.WEBP_OPE_AO) == (1.0, 0.01)
