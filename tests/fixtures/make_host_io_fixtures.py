"""Write the fixtures of ``chip_smoke.py``'s phase 19 with cv2 (OpenCV 5.0),
on a host that has it:

* ``tests/fixtures/jpeg/*.jpg``: small cv2-made JPEGs (progressive,
  restart, 4:4:4, 4:2:2, 4:4:0, gray, odd sizes, EXIF orientation 6);
* ``tests/fixtures/jpeg/manifest.json``: the sha256 of cv2's decode of each
  (RGB bytes) and of cv2's encode of ``chip_smoke.fixture_frame`` at the
  ``ENCODE_CASES``;
* ``tests/fixtures/host_items.json``: the digests of the JAX dataset's
  normal-mode items with each host transform forced on
  (``chip_smoke.forced_item_digests``), cv2 reading and augmenting.

    python tests/fixtures/make_host_io_fixtures.py

``tests/test_torch_jpeg.py`` and ``tests/test_torch_host_augs.py`` hold the
committed files to what cv2 and the port give.
"""

import json
import os
import struct
import sys
import tempfile

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
    print(f"wrote {len(DECODE_FILES)} JPEGs, the manifest and {chip_smoke.HOST_ITEM_COUNT} item digests")


if __name__ == "__main__":
    main()
