"""Minimal protobuf wire-format reader, the port's own copy of
``feartracker_tpu/convert/protowire.py`` (the port imports nothing of the
JAX package), and the few field encoders that the training loop's event
log writes with (``train/summary.py``).

coremltools is not a dependency, but the reference ships its
trained FEAR-XS weights inside CoreML ``.mlmodel`` protobufs
(ref: evaluate/FEARDemo/FEARDemo/Tracker.mlmodel + TrackerInit.mlmodel,
produced by evaluate/coreml_convert.py:34-58). An ``.mlmodel`` is a standard
protobuf message, so a generic wire-format decoder plus CoreML's (stable,
public) field numbers is enough to recover every layer and weight blob.

This module is schema-free: it decodes the tag/wire-type stream into nested
``Field`` records; :mod:`feartracker_tpu_torch.convert.coreml` assigns meaning.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple


@dataclass
class Field:
    number: int
    wire_type: int
    # exactly one of the below is set depending on wire_type
    varint: Optional[int] = None
    fixed: Optional[bytes] = None
    data: Optional[bytes] = None  # wire type 2 payload

    def as_string(self) -> str:
        return self.data.decode("utf-8", errors="replace")

    def as_message(self) -> "List[Field]":
        return parse(self.data)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(buf: bytes) -> Iterator[Field]:
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        number, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
            yield Field(number, wt, varint=val)
        elif wt == 1:
            yield Field(number, wt, fixed=buf[pos : pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            yield Field(number, wt, data=buf[pos : pos + ln])
            pos += ln
        elif wt == 5:
            yield Field(number, wt, fixed=buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")


def parse(buf: bytes) -> List[Field]:
    return list(iter_fields(buf))


def first(fields: List[Field], number: int) -> Optional[Field]:
    for f in fields:
        if f.number == number:
            return f
    return None


def all_of(fields: List[Field], number: int) -> List[Field]:
    return [f for f in fields if f.number == number]


def packed_uint64(data: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(v)
    return out


def floats_le(data: bytes) -> "List[float]":
    return list(struct.unpack(f"<{len(data)//4}f", data[: len(data) // 4 * 4]))


# -- writer: the encodings the training loop's event log needs ---------------


def varint(value: int) -> bytes:
    """An unsigned varint; a negative int64 as its 10-byte two's complement."""
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(number: int, value: int) -> bytes:
    return varint(number << 3) + varint(int(value))


def field_bytes(number: int, data: bytes) -> bytes:
    """A length-delimited field: bytes, a string's UTF-8 or a message."""
    return varint(number << 3 | 2) + varint(len(data)) + data


def field_double(number: int, value: float) -> bytes:
    return varint(number << 3 | 1) + struct.pack("<d", value)


def field_float(number: int, value: float) -> bytes:
    return varint(number << 3 | 5) + struct.pack("<f", value)
