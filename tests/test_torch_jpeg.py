"""The port's JPEG codec (``csrc/jpeg.cpp`` through ``data/jpeg.py``)
against cv2 5.0 (libjpeg-turbo 3.1) on the CPU: decode byte-equal to
``cv2.imdecode`` / ``cv2.imread`` over qualities, chroma samplings,
progressive and restart files, odd sizes and EXIF orientation; encode
byte-equal to ``cv2.imencode``; the round trip of ``ImageCompression``;
unsupported files raise; and the generators' ``--format jpg`` trees equal
the JAX generators' file for file."""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest

from feartracker_tpu_torch.data import jpeg
from feartracker_tpu_torch.data.dataset import read_img

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLINGS = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
}


def _image(h, w, seed, noise=24):
    """Smooth colour with noise: real blocks, not only flat ones."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR).astype(np.int16)
    return np.clip(img + rng.randint(-noise, noise + 1, (h, w, 3)), 0, 255).astype(np.uint8)


# the large frame is a camera's kind of detail, not white noise
IMAGES = {(1, 1): _image(1, 1, 8), (17, 33): _image(17, 33, 152), (721, 1283): _image(721, 1283, 6330, noise=6)}


def _cv2_jpeg(img, q, sampling="420", progressive=False, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


# every quality at the small sizes; the 1283-wide frame at q 50 and 95, to
# keep the run short
DECODE_CASES = [(size, q) for size in IMAGES for q in ((50, 95) if size[0] > 100 else (50, 75, 95, 100))]


@pytest.mark.parametrize("size,q", DECODE_CASES, ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else f"q{v}")
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "gray"])
def test_decode_equals_imdecode(size, q, sampling):
    """Baseline and progressive, with and without restart markers."""
    img = IMAGES[size]
    if sampling == "gray":
        img, sampling = img[..., 0].copy(), "420"
    for progressive in (False, True):
        for restart in (0, 1):
            data = _cv2_jpeg(img, q, sampling, progressive, restart)
            got = jpeg.decode_jpeg(data)
            want = _cv2_decode(data)
            assert got.dtype == np.uint8 and got.shape == want.shape, (progressive, restart)
            assert np.array_equal(got, want), (progressive, restart)


def _with_exif_orientation(data: bytes, orientation: int, little_endian: bool) -> bytes:
    """The JPEG with an APP1 Exif segment holding only the orientation tag."""
    e = "<" if little_endian else ">"
    tiff = (b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
    tiff += struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(e + "HH", orientation, 0) + struct.pack(e + "I", 0)
    app1 = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_imread_applies_it(tmp_path, orientation):
    data = _with_exif_orientation(_cv2_jpeg(IMAGES[(17, 33)], 90), orientation, orientation % 2 == 0)
    path = tmp_path / "o.jpg"
    path.write_bytes(data)
    want = cv2.imread(str(path))[..., ::-1]
    assert np.array_equal(jpeg.decode_jpeg(str(path)), want)
    assert np.array_equal(jpeg.decode_jpeg(data), _cv2_decode(data))
    assert np.array_equal(read_img(str(path)), want)  # the datasets' reader
    assert want.shape[:2] == ((33, 17) if orientation >= 5 else (17, 33))


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("size", [(17, 33), (64, 80)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_equals_imencode(size, gray):
    rgb = _image(*size, seed=3)
    img = rgb[..., 0].copy() if gray else rgb
    for q in range(50, 101):
        want = cv2.imencode(".jpg", img if gray else img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
        assert jpeg.encode_jpeg(img, q) == want, q
    # cv2.imwrite is quality 95
    assert jpeg.encode_jpeg(img) == cv2.imencode(".jpg", img if gray else img[..., ::-1])[1].tobytes()


def test_encode_large_and_flat_images():
    for img in (IMAGES[(721, 1283)], np.full((9, 9, 3), 255, np.uint8), np.zeros((16, 16, 3), np.uint8)):
        for q in (1, 50, 100):
            assert jpeg.encode_jpeg(img, q) == cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()


def test_roundtrip_is_imdecode_of_imencode():
    """``ImageCompression``'s call: cv2 takes channel 0 as blue, so does the
    round trip."""
    rng = np.random.RandomState(4)
    for (h, w) in [(128, 128), (256, 256), (37, 45)]:
        img = _image(h, w, seed=h + w)
        for q in rng.randint(50, 101, 4):
            want = cv2.imdecode(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, int(q)])[1], cv2.IMREAD_COLOR)
            assert np.array_equal(jpeg.jpeg_roundtrip(img, int(q)), want), (h, w, q)


def _patch_sof(data: bytes, **fields) -> bytes:
    """``data`` with its SOF0 marker, precision or first sampling byte replaced."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if "marker" in fields:
        out[i + 1] = fields["marker"]
    if "precision" in fields:
        out[i + 4] = fields["precision"]
    if "sampling" in fields:  # the first component's
        out[i + 11] = fields["sampling"]
    return bytes(out)


def test_unsupported_files_raise_and_name_the_feature():
    data = _cv2_jpeg(IMAGES[(17, 33)], 90)
    cmyk = b"\xff\xd8\xff\xc0" + struct.pack(">HBHHB", 20, 8, 4, 4, 4) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(4)) + b"\xff\xd9"
    cases = {
        "arithmetic": _patch_sof(data, marker=0xC9),
        "lossless": _patch_sof(data, marker=0xC3),
        "hierarchical": _patch_sof(data, marker=0xC5),
        "12-bit": _patch_sof(data, precision=12),
        "CMYK": cmyk,
        "sampling factor above 2": _patch_sof(data, sampling=0x41),
        "no SOI": b"not a jpeg",
        "truncated": data[:60],
    }
    for feature, bad in cases.items():
        with pytest.raises(ValueError, match=feature.split()[0]):
            jpeg.decode_jpeg(bad)
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 2), np.uint8))


def test_read_img_takes_jpeg_and_npy_and_names_the_rest(tmp_path):
    img = IMAGES[(17, 33)]
    (tmp_path / "a.JPEG").write_bytes(_cv2_jpeg(img[..., ::-1], 95))
    np.save(tmp_path / "a.npy", img)
    assert np.array_equal(read_img(str(tmp_path / "a.JPEG")), cv2.imread(str(tmp_path / "a.JPEG"))[..., ::-1])
    assert np.array_equal(read_img(str(tmp_path / "a.npy")), img)
    with pytest.raises(IOError, match=r"\.jpg, \.jpeg and \.npy"):
        read_img(str(tmp_path / "a.png"))
    with pytest.raises(IOError, match="cannot read"):
        read_img(str(tmp_path / "missing.jpg"))


def _tree_hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_generators_write_the_jax_generators_jpeg_trees(tmp_path):
    sys.path.insert(0, REPO)
    from tools import make_class_dataset as j_cls
    from tools import make_synthetic_dataset as j_syn

    from feartracker_tpu_torch.tools import make_class_dataset as p_cls
    from feartracker_tpu_torch.tools import make_synthetic_dataset as p_syn

    kw = dict(tracks=2, frames=3, val_sequences=1, seed=2, scenario="occlusion", size=(48, 64))
    j_syn.generate(str(tmp_path / "js"), **kw)
    p_syn.generate(str(tmp_path / "ps"), fmt="jpg", **kw)
    j_cls.generate_classes(str(tmp_path / "jc"), per_class=1, size=40, seed=1)
    p_cls.generate_classes(str(tmp_path / "pc"), per_class=1, size=40, seed=1, fmt="jpg")
    for a, b in (("js", "ps"), ("jc", "pc")):
        ha, hb = _tree_hashes(tmp_path / a), _tree_hashes(tmp_path / b)
        assert sorted(ha) == sorted(hb) and len(ha) > 5
        assert ha == hb


def test_chip_fixtures_are_cv2s_bytes():
    """``chip_smoke.py`` phase 19a's fixtures: the committed JPEGs decode to
    the sha256s of cv2's pixels, by cv2 and by the port, and the seeded
    frames encode to the sha256s of cv2's files, by cv2 and by the port."""
    sys.path.insert(0, REPO)
    import chip_smoke

    jpeg_dir = os.path.join(REPO, *chip_smoke.JPEG_FIXTURES)
    with open(os.path.join(jpeg_dir, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert len(manifest["decode"]) >= 10 and len(manifest["encode"]) == len(chip_smoke.ENCODE_CASES)
    total = 0
    for c in manifest["decode"]:
        path = os.path.join(jpeg_dir, c["file"])
        total += os.path.getsize(path)
        want = np.ascontiguousarray(cv2.imread(path)[..., ::-1])
        got = jpeg.decode_jpeg(path)
        assert list(want.shape) == list(got.shape) == c["shape"], c["file"]
        assert chip_smoke._sha(want.tobytes()) == chip_smoke._sha(got.tobytes()) == c["sha256"], c["file"]
    assert total <= 60_000
    for c in manifest["encode"]:
        img = chip_smoke.fixture_frame(c["seed"], c["h"], c["w"], c["gray"])
        want = cv2.imencode(".jpg", img if c["gray"] else img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, c["quality"]])[1]
        assert chip_smoke._sha(want) == chip_smoke._sha(jpeg.encode_jpeg(img, c["quality"])) == c["sha256"], c
