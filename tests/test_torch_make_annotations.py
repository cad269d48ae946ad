"""The port's annotation maker (``feartracker_tpu_torch/tools/make_annotations.py``:
numpy and the standard library, no pandas, no cv2) against the JAX tool on
the same trees: the CSV of every layout byte-equal to JAX's
``df.to_csv(index=False)``; the header reader's frame sizes equal to what
``cv2.imread`` decodes (baseline and progressive JPEG, PNG, an EXIF-rotated
JPEG, an unreadable file) and to an ``.npy`` file's array; a GOT-10k tree of
``.npy`` frames annotated as its JPEG twin is."""

import json
import os
import struct

import cv2
import numpy as np
import pytest

import tools.make_annotations as jax_ann
from feartracker_tpu_torch.tools import make_annotations
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate


def _frame(h=80, w=100, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), dtype=np.uint8)


def _got10k(root):
    """Two sequences with fractional boxes (x.5: banker's rounding), one
    with an absence label; a list.txt."""
    base = root / "train"
    names = []
    for s in range(2):
        seq = f"GOT-10k_Train_{s:06d}"
        d = base / seq
        d.mkdir(parents=True)
        gt = []
        for f in range(4):
            cv2.imwrite(str(d / f"{f:08d}.jpg"), _frame(80, 100 + 10 * s, f))
            gt.append(f"{10.5 + 5 * f},{8 + 2 * f}.5,30.5,{25 - 25 * (f == 3)}")
        (d / "groundtruth.txt").write_text("\n".join(gt))
        if s == 0:
            (d / "absence.label").write_text("0\n0\n1\n0")
        names.append(seq)
    (base / "list.txt").write_text("\n".join(names))
    return dict(root=str(root), subset="train")


def _lasot(root):
    for cls in ("airplane", "bird"):
        for n in (1, 2):
            d = root / cls / f"{cls}-{n}"
            (d / "img").mkdir(parents=True)
            for f in range(3):
                cv2.imwrite(str(d / "img" / f"{f + 1:08d}.jpg"), _frame(60, 90, f))
            (d / "groundtruth.txt").write_text("1,2,30,40\n2.5,3.5,30,40\n0,0,1,1")
            if n == 1:
                (d / "full_occlusion.txt").write_text("0,1,0")
                (d / "out_of_view.txt").write_text("0,1,1")
    return dict(root=str(root), subset="")


def _trackingnet(root):
    chunk = root / "TRAIN_0"
    for seq in ("a", "b"):
        frames = chunk / "frames" / seq
        frames.mkdir(parents=True)
        for i in [0, 1, 2, 10]:  # numeric vs lexical order differs
            cv2.imwrite(str(frames / f"{i}.jpg"), _frame(60, 80, i))
        (chunk / "anno").mkdir(exist_ok=True)
        (chunk / "anno" / f"{seq}.txt").write_text("5,6,20,18\n6.5,7,20,18\n7,8,20,18\n58,9,20,18")
    return dict(root=str(root), subset="train")


def _coco(root):
    (root / "annotations").mkdir()
    coco = {
        "images": [{"id": 7, "file_name": "000007.jpg", "width": 100, "height": 80},
                   {"id": 9, "file_name": "000009.jpg", "width": 64, "height": 64}],
        "annotations": [{"id": 1, "image_id": 7, "bbox": [10.5, 12.5, 30.4, 25.6], "iscrowd": 0},
                        {"id": 2, "image_id": 7, "bbox": [50, 5, 20, 20], "iscrowd": 0},
                        {"id": 3, "image_id": 9, "bbox": [0, 0, 10, 10], "iscrowd": 1},
                        {"id": 4, "image_id": 9, "bbox": [5, 5, 0, 7], "iscrowd": 0},
                        {"id": 5, "image_id": 9, "bbox": [1, 1, 62, 60]}],
    }
    (root / "annotations" / "instances_val2017.json").write_text(json.dumps(coco))
    return dict(root=str(root), subset="val")


def _ilsvrc(root):
    seq = "ILSVRC2015_train_00001000"
    anno_dir = root / "Annotations" / "VID" / "train" / "a" / seq
    anno_dir.mkdir(parents=True)
    frames = {0: [(0, 0, 10, 10, 30, 20), (1, 0, 50, 40, 20, 20)], 1: [(0, 1, 12, 11, 30, 20)],
              2: [(0, 0, 14, 12, 30, 20), (1, 0, 55, 42, 20, 20), (2, 0, 0, 0, 0, 5)]}
    for f, objs in frames.items():
        body = "".join(f"<object><trackid>{t}</trackid><occluded>{o}</occluded><bndbox><xmin>{x}</xmin>"
                       f"<ymin>{y}</ymin><xmax>{x + w}</xmax><ymax>{y + h}</ymax></bndbox></object>"
                       for t, o, x, y, w, h in objs)
        (anno_dir / f"{f:06d}.xml").write_text(
            f"<annotation><size><width>120</width><height>90</height></size>{body}</annotation>")
    return dict(root=str(root), subset="train")


def _youtube_bb(root):
    rows = [
        ("vidA", 0, 5, "dog", 0, "present", 0.10, 0.40, 0.25, 0.75),
        ("vidA", 1000, 5, "dog", 0, "present", 0.1225, 0.42, 0.25, 0.75),
        ("vidA", 2000, 5, "dog", 0, "absent", -1.0, -1.0, -1.0, -1.0),
        ("vidA", 3000, 5, "dog", 0, "present", 0.00, 0.30, 0.00, 0.50),  # near corner
        ("vidA", 5000, 5, "dog", 0, "present", 0.20, 0.50, 0.25, 0.75),  # a gap
        ("vidA", 0, 5, "dog", 1, "present", 0.50, 0.90, 0.10, 0.60),  # a second object
        ("vidB", 0, 3, "cat", 0, "present", 0.25, 0.75, 0.25, 0.75),  # no frame on disk
        ("vidA", 4000, 12, "cow", 0, "1", 0.0025, 0.4, 0.0, 0.2),
    ]
    with open(root / "yt_bb_detection_train.csv", "w") as fh:
        for r in rows:
            fh.write(",".join(str(v) for v in r) + "\n")
    (root / "vidA").mkdir()
    for ts in (0, 1000, 2000, 3000, 4000, 5000):
        cv2.imwrite(str(root / "vidA" / f"vidA_{ts}.jpg"), _frame(100, 200, ts))
    return dict(root=str(root), subset="train")


LAYOUTS = {"got10k": _got10k, "lasot": _lasot, "trackingnet": _trackingnet, "coco": _coco, "ilsvrc": _ilsvrc,
           "youtube_bb": _youtube_bb}


@pytest.mark.parametrize("dataset", sorted(LAYOUTS))
def test_csv_equals_jax_byte_for_byte(dataset, tmp_path, capsys):
    kw = LAYOUTS[dataset](tmp_path)
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    jax_ann.BUILDERS[dataset](kw["root"], kw["subset"]).to_csv(jax_csv, index=False)
    jax_out = capsys.readouterr().out
    rec = make_annotations.run(dataset, kw["root"], str(port_csv), subset=kw["subset"])
    assert port_csv.read_bytes() == jax_csv.read_bytes()
    assert rec[0]["rows"] == len(jax_csv.read_text().splitlines()) - 1 > 0
    if dataset == "youtube_bb":  # the dropped rows are reported as JAX reports them
        assert "[youtube_bb] dropped 1 rows" in jax_out
        assert "[youtube_bb] dropped 1 rows" in capsys.readouterr().out


def test_an_empty_layout_writes_what_pandas_writes(tmp_path):
    (tmp_path / "val").mkdir()
    make_annotations.write_csv(make_annotations.make_got10k(str(tmp_path), "val"), tmp_path / "port.csv")
    jax_ann.make_got10k(str(tmp_path), "val").to_csv(tmp_path / "jax.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes() == b"\n"


def _exif_jpeg(path, img, orientation, big_endian=False):
    """``img`` as JPEG with an APP1 Exif segment holding ``orientation``."""
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    e = ">" if big_endian else "<"
    tiff = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "I", 8) + struct.pack(e + "H", 1)
    tiff += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    payload = b"Exif\x00\x00" + tiff
    data = enc.tobytes()
    path.write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:])


def _cv2_shape(path):
    img = cv2.imread(str(path))
    return (img.shape[1], img.shape[0]) if img is not None else (0, 0)


@pytest.mark.parametrize("kind", ["baseline", "progressive", "png", "exif6", "exif8_big_endian", "exif3",
                                  "unreadable", "empty"])
def test_header_size_equals_cv2_imread(kind, tmp_path):
    img = _frame(37, 53)
    path = tmp_path / ("f.png" if kind == "png" else "f.jpg")
    if kind == "baseline":
        cv2.imwrite(str(path), img)
    elif kind == "progressive":
        cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    elif kind == "png":
        cv2.imwrite(str(path), img)
    elif kind.startswith("exif"):
        _exif_jpeg(path, img, int(kind[4]), big_endian=kind.endswith("big_endian"))
    elif kind == "unreadable":
        path.write_bytes(b"not an image at all" * 10)
    else:
        path.write_bytes(b"")
    want = _cv2_shape(path)
    assert make_annotations.frame_shape(str(path)) == want
    assert want == {"unreadable": (0, 0), "empty": (0, 0), "exif6": (37, 53),
                    "exif8_big_endian": (37, 53)}.get(kind, (53, 37))


def test_header_size_of_npy(tmp_path):
    np.save(tmp_path / "f.npy", _frame(37, 53))
    assert make_annotations.frame_shape(str(tmp_path / "f.npy")) == (53, 37)
    assert make_annotations.frame_shape(str(tmp_path / "missing.jpg")) == (0, 0)


def test_got10k_of_npy_frames_annotates_as_its_jpeg_twin(tmp_path):
    """The numpy generator's GOT-10k tree (``.npy`` frames) against the same
    frames as JPEG through the JAX tool: the same rows, the frames' suffix
    aside."""
    generate(str(tmp_path / "npy"), tracks=1, frames=6, val_sequences=2, seed=3)
    npy_val = tmp_path / "npy" / "got10k" / "val"
    jpg_val = tmp_path / "jpg" / "got10k" / "val"
    for seq in sorted(os.listdir(npy_val)):
        src = npy_val / seq
        if not src.is_dir():
            continue
        (jpg_val / seq).mkdir(parents=True)
        for f in os.listdir(src):
            if f.endswith(".npy"):
                cv2.imwrite(str(jpg_val / seq / f.replace(".npy", ".jpg")), np.load(src / f)[..., ::-1])
            else:
                (jpg_val / seq / f).write_bytes((src / f).read_bytes())
    (jpg_val / "list.txt").write_bytes((npy_val / "list.txt").read_bytes())
    make_annotations.run("got10k", str(tmp_path / "npy" / "got10k"), str(tmp_path / "port.csv"), subset="val")
    jax_ann.make_got10k(str(tmp_path / "jpg" / "got10k"), "val").to_csv(tmp_path / "jax.csv", index=False)
    port = (tmp_path / "port.csv").read_text()
    assert port == (tmp_path / "jax.csv").read_text().replace(".jpg", ".npy")
    assert port.count("\n") == 1 + 2 * 6 and '"[224, 160]"' in port


def test_main_writes_the_csv(tmp_path, capsys):
    kw = _coco(tmp_path)
    make_annotations.main(["coco", "--root", kw["root"], "--subset", "val", "--out", str(tmp_path / "c.csv")])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"dataset": "coco", "out": str(tmp_path / "c.csv"), "rows": 3, "tracks": 3,
                   "frame_shapes": ["[100, 80]", "[64, 64]"]}
