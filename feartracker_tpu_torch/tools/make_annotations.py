"""Generate training CSV annotations from standard dataset layouts with the
standard library and numpy alone: the counterpart of
``tools/make_annotations.py``, which needs pandas for the CSV and cv2 for
the frame sizes.

The reference requires a per-dataset CSV with the schema sequence_id,
track_id, frame_index, img_path, bbox, frame_shape, dataset, presence,
near_corner (ref: README.md:82-93). This tool builds it from GOT-10k, LaSOT,
TrackingNet, COCO-2017 instances (single-frame tracks), ImageNet-VID and
YouTube-BoundingBoxes layouts, every training dataset of the reference's
full_train recipe (ref: config/dataset/full_train.yaml). The CSV is the JAX
tool's byte for byte (pandas' ``to_csv(index=False)``: minimal quoting,
``\\n`` line ends).

Frame sizes come from the file's header, not from decoding it: a JPEG's SOFn
marker, a PNG's IHDR chunk (each swapped where its EXIF / eXIf orientation is
5-8, as ``cv2.imread`` rotates such frames), a BMP, PNM, PAM, PFM, Sun
raster, TIFF, GIF, WebP, JPEG 2000 (SIZ, after cv2's checks) or Radiance
HDR header as OpenCV's decoders read it, an ``.npy`` header; ``(0, 0)`` for
a file none of these reads, where ``cv2.imread`` returns None. GOT-10k, LaSOT and
TrackingNet frames are ``*.jpg``; a sequence without any takes its ``*.npy``
frames (``tools/make_synthetic_dataset.py``'s trees).

    python -m feartracker_tpu_torch.tools.make_annotations got10k --root /data/got10k --subset train \\
        --out /data/got10k/train.csv
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

from feartracker_tpu_torch.data import jp2
from feartracker_tpu_torch.data.gif import first_image
from feartracker_tpu_torch.data.hdr import hdr_header
from feartracker_tpu_torch.data.imread import (bmp_header, format_of, pam_header, pfm_header, pnm_header,
                                               sun_raster_header, tiff_orientation)
from feartracker_tpu_torch.data.tiff import tiff_header
from feartracker_tpu_torch.data.webp import webp_header
from feartracker_tpu_torch.data.sequence import _read_gt


def _near_corner(bbox, shape_wh, margin: int = 2) -> int:
    x, y, w, h = bbox
    W, H = shape_wh
    return int(x <= margin or y <= margin or x + w >= W - margin or y + h >= H - margin)


# -- frame sizes from headers -------------------------------------------------


def _jpeg_shape(data: bytes) -> Tuple[int, int]:
    """(W, H) from the frame header, as displayed: swapped for an EXIF
    orientation of 5-8 (a transposing rotation or flip); (0, 0) for the
    kinds ``cv2.imread`` refuses (hierarchical, lossless arithmetic, 12-bit,
    2 components, a height set by DNL, lossless grey or YCbCr, lossless
    above 8 bits), judged from the markers up to the first scan as libjpeg
    judges them."""
    pos, orientation, sof, jfif, adobe = 2, 1, None, False, None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return 0, 0
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:  # no length
            pos += 2
            continue
        if marker in (0xD9, 0xDA):  # end of image, or the first scan
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if sof is not None or len(seg) < 6:
                return 0, 0
            sof = (marker,) + struct.unpack(">BHHB", seg[:6])
        elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = tiff_orientation(seg[6:])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        pos += 2 + length
    if sof is None:
        return 0, 0
    marker, precision, h, w, ncomp = sof
    if not (w and h) or ncomp not in (1, 3, 4) or marker not in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        return 0, 0
    if marker == 0xC3:  # lossless: only RGB and CMYK need no conversion in libjpeg-turbo
        ycc = ncomp == 3 and (jfif or (adobe is not None and adobe != 0))
        if not 2 <= precision <= 8 or ncomp == 1 or ycc or (ncomp == 4 and adobe not in (None, 0)):
            return 0, 0
    elif precision != 8:
        return 0, 0
    return (h, w) if orientation in (5, 6, 7, 8) else (w, h)


def _png_shape(data: bytes) -> Tuple[int, int]:
    """(W, H) from IHDR, swapped for an eXIf orientation of 5-8."""
    if len(data) < 24 or data[12:16] != b"IHDR":
        return 0, 0
    w, h = struct.unpack(">II", data[16:24])
    pos, orientation = 8, 1
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind in (b"IDAT", b"IEND"):
            break
        if kind == b"eXIf":
            orientation = tiff_orientation(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    if not (w and h):
        return 0, 0
    return (h, w) if orientation in (5, 6, 7, 8) else (w, h)


def frame_shape(img_path: str) -> Tuple[int, int]:
    """A frame's (W, H) from its header alone: what ``cv2.imread``'s array
    gives for a JPEG, PNG, BMP, PNM, PAM, PFM, Sun raster, TIFF, GIF, WebP,
    JPEG 2000 or Radiance HDR file (picked by signature, as cv2 picks its
    decoder; after the orientation cv2 applies),
    the array's for an ``.npy`` file; ``(0, 0)`` where none of these reads
    the header or the reader refuses what it names."""
    try:
        with open(img_path, "rb") as fh:
            head = fh.read(16)
            if head.startswith(b"\x93NUMPY"):
                shape = np.load(img_path, mmap_mode="r").shape
                return (shape[1], shape[0]) if len(shape) >= 2 else (0, 0)
            kind = format_of(head)
            if kind == "jpeg":
                return _jpeg_shape(head + fh.read())
            if kind == "png":
                return _png_shape(head + fh.read())
            if kind == "bmp":
                hd = bmp_header(head + fh.read())
                return hd["width"], hd["height"]
            if kind == "pnm":
                hd = pnm_header(head + fh.read())
                return hd["width"], hd["height"]
            if kind == "tiff":  # orientations 5-8 raise: cv2.imread reads nothing there
                hd = tiff_header(head + fh.read())
                return hd["width"], hd["height"]
            if kind == "gif":
                hd = first_image(head + fh.read())
                return hd["width"], hd["height"]
            if kind == "webp":
                hd = webp_header(head + fh.read())
                return (hd["height"], hd["width"]) if hd["orientation"] in (5, 6, 7, 8) else (hd["width"], hd["height"])
            if kind == "jp2":  # the image area after cv2's checks (signed, offset, sub-sampled, colour space, ...)
                return jp2.frame_size(head + fh.read())
            header = {"pam": pam_header, "pfm": pfm_header, "sun": sun_raster_header, "hdr": hdr_header}.get(kind)
            if header is not None:
                hd = header(head + fh.read())
                return hd["width"], hd["height"]
    except (OSError, ValueError):
        pass
    return 0, 0


# -- rows -----------------------------------------------------------------------


def _frames(seq_dir: str) -> List[str]:
    """A sequence directory's ``*.jpg`` frames, else its ``*.npy`` frames."""
    return glob.glob(os.path.join(seq_dir, "*.jpg")) or glob.glob(os.path.join(seq_dir, "*.npy"))


def rows_for_sequence(seq_id, track_id, files, anno, dataset, root, absence=None) -> List[Dict]:
    if not files:
        return []
    shape_wh = frame_shape(files[0])
    out = []
    n = min(len(files), len(anno))
    for i in range(n):
        bbox = [int(round(v)) for v in anno[i][:4]]
        presence = 1
        if absence is not None and i < len(absence):
            presence = int(absence[i] == 0)
        if bbox[2] <= 0 or bbox[3] <= 0:
            presence = 0
        out.append(dict(sequence_id=seq_id, track_id=track_id, frame_index=i,
                        img_path=os.path.relpath(files[i], root), bbox=str(bbox),
                        frame_shape=str(list(shape_wh)), dataset=dataset, presence=presence,
                        near_corner=_near_corner(bbox, shape_wh)))
    return out


def make_got10k(root: str, subset: str) -> List[Dict]:
    base = os.path.join(root, subset)
    list_file = os.path.join(base, "list.txt")
    if os.path.exists(list_file):
        with open(list_file) as fh:
            seqs = [line.strip() for line in fh if line.strip()]
    else:
        seqs = sorted(os.path.basename(d) for d in glob.glob(os.path.join(base, "*")) if os.path.isdir(d))
    rows = []
    for seq in seqs:
        seq_dir = os.path.join(base, seq)
        gt = os.path.join(seq_dir, "groundtruth.txt")
        if not os.path.exists(gt):
            continue
        absence_file = os.path.join(seq_dir, "absence.label")
        absence = np.loadtxt(absence_file, dtype=int) if os.path.exists(absence_file) else None  # 1 = absent
        rows += rows_for_sequence(seq, seq, sorted(_frames(seq_dir)), _read_gt(gt), "got10k", root, absence)
    return rows


def make_lasot(root: str, subset: str = "") -> List[Dict]:
    rows = []
    for gt in sorted(glob.glob(os.path.join(root, "*", "*", "groundtruth.txt"))):
        seq_dir = os.path.dirname(gt)
        seq = os.path.basename(seq_dir)
        absence = None
        occ = os.path.join(seq_dir, "full_occlusion.txt")
        oov = os.path.join(seq_dir, "out_of_view.txt")
        if os.path.exists(occ) and os.path.exists(oov):
            a = _read_gt(occ).ravel().astype(int)
            b = _read_gt(oov).ravel().astype(int)
            absence = np.clip(a + b, 0, 1)  # 1 = occluded or out of view
        rows += rows_for_sequence(seq, seq, sorted(_frames(os.path.join(seq_dir, "img"))), _read_gt(gt), "lasot",
                                  root, absence)
    return rows


def make_trackingnet(root: str, subset: str = "train") -> List[Dict]:
    """TrackingNet train chunks: root/TRAIN_*/frames/<seq>/<N>.jpg (numeric
    order) + anno/<seq>.txt. No absence labels in the release."""
    rows = []
    chunks = sorted(d for d in glob.glob(os.path.join(root, "TRAIN_*")) if os.path.isdir(d))
    for chunk in chunks:
        for anno_path in sorted(glob.glob(os.path.join(chunk, "anno", "*.txt"))):
            seq = os.path.splitext(os.path.basename(anno_path))[0]
            files = _frames(os.path.join(chunk, "frames", seq))
            files.sort(key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
            rows += rows_for_sequence(seq, seq, files, _read_gt(anno_path), "trackingnet", root)
    return rows


def make_coco(root: str, subset: str = "train") -> List[Dict]:
    """COCO instances → one single-frame track per (non-crowd) object, the
    reference's static-image training recipe. Frame shapes come from the
    JSON: no image reads."""
    with open(os.path.join(root, "annotations", f"instances_{subset}2017.json")) as fh:
        coco = json.load(fh)
    images = {im["id"]: im for im in coco["images"]}
    rows = []
    for a in coco["annotations"]:
        if a.get("iscrowd"):
            continue
        bbox = [int(round(v)) for v in a["bbox"]]
        if bbox[2] <= 0 or bbox[3] <= 0:
            continue
        im = images[a["image_id"]]
        shape_wh = (im["width"], im["height"])
        rows.append(dict(sequence_id=f"img{a['image_id']}", track_id=f"ann{a['id']}", frame_index=0,
                         img_path=os.path.join(f"{subset}2017", im["file_name"]), bbox=str(bbox),
                         frame_shape=str(list(shape_wh)), dataset="coco2017", presence=1,
                         near_corner=_near_corner(bbox, shape_wh)))
    return rows


def make_ilsvrc_vid(root: str, subset: str = "train") -> List[Dict]:
    """ImageNet-VID: Annotations/VID/<subset>/**/<seq>/NNNNNN.xml, one XML per
    frame with zero or more <object><trackid> entries. Each (sequence,
    trackid) becomes a track; frames where the object is absent are skipped
    (frame_index is the real frame number); occluded frames get presence=0."""
    anno_root = os.path.join(root, "Annotations", "VID", subset)
    rows = []
    seq_dirs = sorted(d for d, dirs, files in os.walk(anno_root) if files and not dirs)
    for seq_dir in seq_dirs:
        seq = os.path.relpath(seq_dir, anno_root).replace(os.sep, "/")
        for xml_path in sorted(glob.glob(os.path.join(seq_dir, "*.xml"))):
            stem = os.path.splitext(os.path.basename(xml_path))[0]
            xml = ET.parse(xml_path).getroot()
            W = int(xml.findtext("size/width"))
            H = int(xml.findtext("size/height"))
            img_rel = os.path.join("Data", "VID", subset, seq, stem + ".JPEG")
            for obj in xml.findall("object"):
                x1 = int(obj.findtext("bndbox/xmin"))
                y1 = int(obj.findtext("bndbox/ymin"))
                bbox = [x1, y1, int(obj.findtext("bndbox/xmax")) - x1, int(obj.findtext("bndbox/ymax")) - y1]
                if bbox[2] <= 0 or bbox[3] <= 0:
                    continue
                rows.append(dict(sequence_id=seq, track_id=f"{seq}/t{obj.findtext('trackid')}",
                                 frame_index=int(stem), img_path=img_rel, bbox=str(bbox), frame_shape=str([W, H]),
                                 dataset="ilsvrc", presence=int(obj.findtext("occluded", "0") == "0"),
                                 near_corner=_near_corner(bbox, (W, H))))
    return rows


# frame-dump layouts produced by the common yt_bb download scripts; each is a
# format string over the annotation row's fields, relative to --root
YTBB_PATH_TEMPLATES = [
    "{youtube_id}/{youtube_id}_{timestamp_ms}.jpg",
    "{class_name}/{youtube_id}+{class_id}+{object_id}/{youtube_id}_{timestamp_ms}.jpg",
    "{youtube_id}_{timestamp_ms}_{class_id}_{object_id}.jpg",
]
YTBB_COLUMNS = ("youtube_id", "timestamp_ms", "class_id", "class_name", "object_id", "object_presence",
                "xmin", "xmax", "ymin", "ymax")


def _number(text: str):
    """A CSV field as pandas types a numeric column: int, else float."""
    try:
        return int(text)
    except ValueError:
        return float(text)


def make_youtube_bb(root: str, subset: str = "train", path_template: str = "") -> List[Dict]:
    """YouTube-BoundingBoxes: the upstream detection CSV
    (yt_bb_detection_{subset}.csv: youtube_id, timestamp_ms, class_id,
    class_name, object_id, object_presence, xmin, xmax, ymin, ymax with
    normalized [0, 1] corners) → the repo schema.

    Rows whose frame image is missing are dropped (yt_bb downloads are
    routinely partial) and counted. Frame sizes are read once per video and
    denormalize the corners to integer xywh. ``path_template`` overrides the
    auto-detected frame layout. Tracks come in (youtube_id, class_id,
    object_id) order, each by timestamp (a stable sort: ties keep the file's
    order)."""
    anno_path = os.path.join(root, f"yt_bb_detection_{subset}.csv")
    if not os.path.exists(anno_path):
        candidates = glob.glob(os.path.join(root, "yt_bb_*.csv"))
        if not candidates:
            raise FileNotFoundError(f"no yt_bb_*.csv found under {root}")
        anno_path = candidates[0]
    groups: Dict[tuple, list] = {}
    with open(anno_path, newline="") as fh:
        for fields in csv.reader(fh):
            row = dict(zip(YTBB_COLUMNS, fields))
            for k in ("timestamp_ms", "class_id", "object_id"):
                row[k] = _number(row[k])
            groups.setdefault((row["youtube_id"], row["class_id"], row["object_id"]), []).append(row)

    templates = [path_template] if path_template else YTBB_PATH_TEMPLATES
    shape_cache: dict = {}
    rows = []
    missing = 0
    for (vid, cls_id, obj_id) in sorted(groups):
        track = f"{vid}/{cls_id}_{obj_id}"
        tmpl = None
        for row in sorted(groups[(vid, cls_id, obj_id)], key=lambda r: r["timestamp_ms"]):
            ts = int(row["timestamp_ms"])
            fields = dict(youtube_id=vid, timestamp_ms=ts, class_id=int(cls_id), class_name=row["class_name"],
                          object_id=int(obj_id))
            if tmpl is None:  # resolve the layout on the track's first hit
                for cand in templates:
                    if os.path.exists(os.path.join(root, cand.format(**fields))):
                        tmpl = cand
                        break
            rel = tmpl.format(**fields) if tmpl else None
            if rel is None or not os.path.exists(os.path.join(root, rel)):
                missing += 1
                continue
            if vid not in shape_cache:
                shape_cache[vid] = frame_shape(os.path.join(root, rel))
            W, H = shape_cache[vid]
            present = row["object_presence"].strip().lower() in ("present", "1", "true")
            xmin, xmax, ymin, ymax = (float(row[k]) for k in ("xmin", "xmax", "ymin", "ymax"))
            x, y = int(round(xmin * W)), int(round(ymin * H))
            w, h = int(round((xmax - xmin) * W)), int(round((ymax - ymin) * H))
            if w <= 0 or h <= 0:
                present = False
                x = y = w = h = 0
            rows.append(dict(
                sequence_id=str(vid), track_id=track,
                # yt_bb samples one frame per second at whole-second
                # timestamps: seconds keep frame_offset windows time-correct
                frame_index=ts // 1000, img_path=rel, bbox=str([x, y, w, h]), frame_shape=str([W, H]),
                dataset="youtube_bb", presence=int(present),
                near_corner=_near_corner([x, y, w, h], (W, H)) if present else 0))
    if missing:
        print(f"[youtube_bb] dropped {missing} rows with no decoded frame on disk")
    return rows


BUILDERS = {
    "got10k": make_got10k,
    "lasot": make_lasot,
    "trackingnet": make_trackingnet,
    "coco": make_coco,
    "ilsvrc": make_ilsvrc_vid,
    "youtube_bb": make_youtube_bb,
}


def write_csv(rows: List[Dict], path: str) -> None:
    """The rows as ``pandas.DataFrame(rows).to_csv(path, index=False)``
    writes them: a header, minimal quoting, ``\\n`` line ends; a lone
    ``\\n`` for no rows."""
    with open(path, "w", newline="") as fh:
        if not rows:
            fh.write("\n")
            return
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def run(dataset: str, root: str, out: str, subset: str = "train", path_template: str = "") -> List[Dict]:
    """Build ``dataset``'s rows, write them to ``out`` and print one JSON
    line: the row and track counts and the distinct frame shapes. → [that
    record]."""
    kwargs = {"path_template": path_template} if dataset == "youtube_bb" else {}
    rows = BUILDERS[dataset](root, subset, **kwargs)
    write_csv(rows, out)
    rec = {"dataset": dataset, "out": out, "rows": len(rows), "tracks": len({r["track_id"] for r in rows}),
           "frame_shapes": sorted({r["frame_shape"] for r in rows})}
    print(json.dumps(rec), flush=True)
    return [rec]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset", choices=sorted(BUILDERS))
    p.add_argument("--root", required=True)
    p.add_argument("--subset", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--path_template", default="",
                   help="youtube_bb only: frame-path format string over "
                   "youtube_id/timestamp_ms/class_id/class_name/object_id")
    args = p.parse_args(argv)
    run(args.dataset, args.root, args.out, args.subset, args.path_template)


if __name__ == "__main__":
    main()
