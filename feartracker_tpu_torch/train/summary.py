"""TensorBoard event files without tensorboardX or tensorboard (the card
host has neither): the training loop's :class:`SummaryWriter` and a reader,
:func:`read_events`.

An event file is a sequence of TFRecords, each the length as a
little-endian uint64, the masked CRC32C of those 8 bytes, the data, and the
masked CRC32C of the data. The data is a serialized ``Event`` message
(``tensorflow/core/util/event.proto``): ``wall_time`` (1, double), ``step``
(2, int64), then ``file_version`` (3, string; the file's first record holds
``"brain.Event:2"``) or ``summary`` (5): repeated ``value`` (1), each a
``tag`` (1) and a ``simple_value`` (2, float) or an ``image`` (4: height 1,
width 2, colorspace 3, the PNG bytes 4). Images are written as PNG with
``zlib``. The file is named as tensorboardX names it:
``events.out.tfevents.<unix time>.<host>``.
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from feartracker_tpu_torch.convert import protowire as pw

FILE_VERSION = "brain.Event:2"


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames its records. A byte at a
    time in Python: cheap for scalars, slow for an image of a few MB (the
    loop writes two mosaics an epoch, and none with device augmentations)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 image as PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)  # filter 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


class SummaryWriter:
    """``add_scalar``, ``add_image`` and ``close`` of tensorboardX's writer,
    one event file in ``logdir``. Each record is flushed to the file as it
    is written."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        base = os.path.join(logdir, f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}")
        path, n = base, 0
        while os.path.exists(path):  # a second writer in the same second
            n += 1
            path = f"{base}.{n}"
        self.path = path
        self._fh = open(path, "wb")
        self._write(pw.field_double(1, time.time()) + pw.field_bytes(3, FILE_VERSION.encode()))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._fh.write(header + struct.pack("<I", masked_crc32c(header)) + event
                       + struct.pack("<I", masked_crc32c(event)))
        self._fh.flush()

    def _summary(self, value: bytes, step: Optional[int]) -> None:
        event = pw.field_double(1, time.time())
        if step is not None:
            event += pw.field_varint(2, int(step))
        self._write(event + pw.field_bytes(5, pw.field_bytes(1, value)))

    def add_scalar(self, tag: str, scalar_value: Any, global_step: Optional[int] = None) -> None:
        value = pw.field_bytes(1, tag.encode()) + pw.field_float(2, float(scalar_value))
        self._summary(value, global_step)

    def add_image(self, tag: str, img_tensor: np.ndarray, global_step: Optional[int] = None,
                  dataformats: str = "HWC") -> None:
        """An (H, W, C) uint8 image (``dataformats`` as tensorboardX's, which
        the loop passes; only "HWC" is taken)."""
        img = np.asarray(img_tensor)
        if dataformats != "HWC" or img.dtype != np.uint8:
            raise ValueError(f"only (H, W, C) uint8 images are supported, got {dataformats} {img.dtype}")
        h, w, c = img.shape
        image = (pw.field_varint(1, h) + pw.field_varint(2, w) + pw.field_varint(3, c)
                 + pw.field_bytes(4, encode_png(img)))
        self._summary(pw.field_bytes(1, tag.encode()) + pw.field_bytes(4, image), global_step)

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


# -- reader ---------------------------------------------------------------------


def _records(data: bytes, path: str) -> Iterator[bytes]:
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length checksum at byte {pos}")
        body = data[pos + 12:pos + 12 + n]
        if len(body) != n or pos + 16 + n > len(data):
            raise ValueError(f"{path}: truncated record at byte {pos}")
        (crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(body):
            raise ValueError(f"{path}: bad data checksum at byte {pos}")
        yield body
        pos += 16 + n


def _value(fields: List[pw.Field]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in fields:
        if f.number == 1 and f.wire_type == 2:
            out["tag"] = f.as_string()
        elif f.number == 2 and f.wire_type == 5:
            out["simple_value"] = struct.unpack("<f", f.fixed)[0]
        elif f.number == 4 and f.wire_type == 2:
            img: Dict[str, Any] = {}
            for g in f.as_message():
                key = {1: "height", 2: "width", 3: "colorspace", 4: "encoded_image_string"}.get(g.number)
                if key:
                    img[key] = g.data if g.wire_type == 2 else g.varint
            out["image"] = img
    return out


def _event(body: bytes) -> Dict[str, Any]:
    ev: Dict[str, Any] = {"wall_time": 0.0, "step": 0}
    for f in pw.iter_fields(body):
        if f.number == 1 and f.wire_type == 1:
            ev["wall_time"] = struct.unpack("<d", f.fixed)[0]
        elif f.number == 2 and f.wire_type == 0:
            ev["step"] = f.varint - (1 << 64) if f.varint >= 1 << 63 else f.varint
        elif f.number == 3 and f.wire_type == 2:
            ev["file_version"] = f.as_string()
        elif f.number == 5 and f.wire_type == 2:
            ev["summary"] = [_value(v.as_message()) for v in pw.all_of(f.as_message(), 1)]
    return ev


def read_events(path: str) -> List[Dict[str, Any]]:
    """Every event of an event file, or of every event file in a directory
    (by name order): ``{"wall_time", "step", "file_version"}`` or
    ``{"wall_time", "step", "summary": [{"tag", "simple_value" | "image":
    {"height", "width", "colorspace", "encoded_image_string"}}, ...]}``.
    Raises ``ValueError`` on a bad checksum or a truncated record."""
    files = sorted(glob.glob(os.path.join(path, "*tfevents*"))) if os.path.isdir(path) else [path]
    events: List[Dict[str, Any]] = []
    for name in files:
        with open(name, "rb") as fh:
            events += [_event(body) for body in _records(fh.read(), name)]
    return events


def scalars(events: List[Dict[str, Any]]) -> Dict[str, List[Tuple[int, float]]]:
    """``{tag: [(step, value), ...]}`` of the events' scalar values, in order."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for ev in events:
        for v in ev.get("summary", ()):
            if "simple_value" in v:
                out.setdefault(v["tag"], []).append((ev["step"], v["simple_value"]))
    return out
