"""A read-only OCDBT key-value store: the on-disk database that Orbax
writes a checkpoint's arrays into (through tensorstore), read with Python
and numpy alone.

Every manifest and b-tree node is framed the same way: a 4-byte big-endian
magic (``0x0cdb3a2a`` for ``manifest.ocdbt``, ``0x0cdb20de`` for a node),
the frame's total length as a little-endian uint64, a varint version (0),
a varint compression (0 none, 1 zstd), the (compressed) body, and the
little-endian CRC-32C of everything before it. Varints are LEB128.

* The manifest's body is the config (a 16-byte uuid, the manifest kind,
  the largest inline value, the largest decoded node, the version tree's
  arity, the compression and, for zstd, its level as an int32) and then the
  version tree's newest leaf: a data-file table and per version (in
  columns) its generation, root height, root node's data file, offset and
  length, and three statistics, then a uint64 commit time each. The newest
  generation's root is the tree read. Older versions' nodes are not read.
* A data-file table lists paths, each sharing a prefix with the previous
  one; the first ``base_path_length`` bytes of a path are its base path. A
  node read from a file inherits that file's base path as a prefix of its
  own table's paths (how the root store of a multi-process save reaches
  ``ocdbt.process_0/d/...``).
* A b-tree node is its height, its data-file table, the entry count, the
  keys (each sharing a prefix with the previous key), and then for a leaf
  each value's length and kind (0 inline, 1 in a data file at an offset)
  followed by the inline values, or for an interior node each child's key
  prefix common to its subtree (stripped from the child's keys), file,
  offset, length and statistics.

Values kept in a data file (large arrays) are raw bytes at their offset and
carry no checksum of their own in the format; the zarr chunks in them are
zstd frames, whose decoding checks their structure. Anything else this
reader meets that it does not handle raises :class:`OcdbtError`.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

from feartracker_tpu_torch.convert import zstd
from feartracker_tpu_torch.train.summary import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the address of an empty tree
CONVERT_HINT = ("(convert the checkpoint to an .npz on a host with JAX and orbax: "
           "python tools/export_weights.py --weights_path <dir> --out <file>.npz)")


class OcdbtError(ValueError):
    """A store this reader cannot read: corrupt, truncated or unsupported."""


class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.buf):
                raise OcdbtError(f"{self.what}: truncated")
            b = self.buf[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """A manifest's or node's body, its frame checked."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: truncated")
    got = struct.unpack_from(">I", data, 0)[0]
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    if struct.unpack_from("<Q", data, 4)[0] != len(data):
        raise OcdbtError(f"{what}: length field disagrees with the {len(data)} bytes read")
    if crc32c(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise OcdbtError(f"{what}: CRC-32C mismatch (the file is corrupt)")
    cur = _Cursor(data[:-4], what)
    cur.pos = 12
    version = cur.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} {CONVERT_HINT}")
    compression = cur.varint()
    body = data[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: compression format {compression} {CONVERT_HINT}")


def _file_table(cur: _Cursor, inherited: str) -> List[Tuple[str, str]]:
    """A data-file table → ``[(base path, path)]``, both relative to the
    store's directory."""
    n = cur.varint()
    shared = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    out, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError(f"{cur.what}: bad data-file path prefix")
        path = prev[:shared[i]] + cur.take(suffix[i])
        if base_len[i] > len(path):
            raise OcdbtError(f"{cur.what}: base path longer than its path")
        prev = path
        text = path.decode("utf-8")
        out.append((inherited + text[:base_len[i]], inherited + text))
    return out


class _Store:
    def __init__(self, directory: str):
        self.directory = directory
        self.files: Dict[str, bytes] = {}
        self.bytes_read = 0

    def read(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        parts = path.split("/")
        if os.path.isabs(path) or ".." in parts:
            raise OcdbtError(f"data file {path!r} lies outside the store")
        if path not in self.files:
            with open(os.path.join(self.directory, *parts), "rb") as fh:
                self.files[path] = fh.read()
            self.bytes_read += len(self.files[path])
        data = self.files[path]
        end = len(data) if length < 0 else offset + length
        if end > len(data):
            raise OcdbtError(f"{path}: {offset}+{length} runs past its {len(data)} bytes")
        return data[offset:end]

    def manifest_root(self) -> Tuple[Tuple[str, str], int, int, int]:
        what = os.path.join(self.directory, "manifest.ocdbt")
        cur = _Cursor(_unframe(self.read("manifest.ocdbt"), MANIFEST_MAGIC, what), what)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise OcdbtError(f"{what}: manifest kind {kind} (numbered manifests) {CONVERT_HINT}")
        cur.varint()  # largest inline value
        cur.varint()  # largest decoded node
        cur.byte()  # version tree arity (log2)
        compression = cur.varint()
        if compression == 1:
            cur.take(4)  # zstd level
        elif compression != 0:
            raise OcdbtError(f"{what}: node compression {compression} {CONVERT_HINT}")
        files = _file_table(cur, "")
        n = cur.varint()
        if n == 0:
            raise OcdbtError(f"{what}: no version in the manifest")
        gens, heights, ids, offsets, lengths = (cur.varints(n) for _ in range(5))
        newest = max(range(n), key=gens.__getitem__)
        if offsets[newest] == _MISSING:
            return ("", ""), 0, _MISSING, 0
        if ids[newest] >= len(files):
            raise OcdbtError(f"{what}: root in data file {ids[newest]} of {len(files)}")
        return files[ids[newest]], heights[newest], offsets[newest], lengths[newest]

    def node(self, file: Tuple[str, str], offset: int, length: int, height: int, prefix: bytes,
             out: Dict[bytes, bytes]) -> None:
        base, path = file
        what = f"{os.path.join(self.directory, path)}@{offset}"
        cur = _Cursor(_unframe(self.read(path, offset, length), NODE_MAGIC, what), what)
        got = cur.byte()
        if got != height:
            raise OcdbtError(f"{what}: node height {got}, expected {height}")
        table = _file_table(cur, base)
        n = cur.varint()
        shared = [0] + cur.varints(max(n - 1, 0))
        suffix = cur.varints(n)
        common = cur.varints(n) if height else []
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise OcdbtError(f"{what}: bad key prefix")
            prev = prev[:shared[i]] + cur.take(suffix[i])
            keys.append(prev)
        if height:
            ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            for i in range(n):
                if ids[i] >= len(table) or common[i] > len(keys[i]):
                    raise OcdbtError(f"{what}: bad child reference")
                self.node(table[ids[i]], offsets[i], lengths[i], height - 1, prefix + keys[i][:common[i]], out)
            return
        sizes, kinds = cur.varints(n), cur.varints(n)
        bad = sorted({k for k in kinds if k not in (0, 1)})
        if bad:
            raise OcdbtError(f"{what}: value kind {bad} {CONVERT_HINT}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
        for j, i in enumerate(indirect):
            if ids[j] >= len(table):
                raise OcdbtError(f"{what}: value in data file {ids[j]} of {len(table)}")
            out[prefix + keys[i]] = self.read(table[ids[j]][1], offsets[j], sizes[i])
        for i in range(n):
            if kinds[i] == 0:
                out[prefix + keys[i]] = cur.take(sizes[i])
        if cur.pos != len(cur.buf):
            raise OcdbtError(f"{what}: {len(cur.buf) - cur.pos} bytes after the last value")


def open_store(directory: str) -> Dict[bytes, bytes]:
    """Every key and value of the newest version of the OCDBT database at
    ``directory`` (the folder holding ``manifest.ocdbt``), keys sorted."""
    return read_store(directory)[0]


def read_store(directory: str) -> Tuple[Dict[bytes, bytes], int]:
    """:func:`open_store` and the number of file bytes it read."""
    store = _Store(directory)
    file, height, offset, length = store.manifest_root()
    out: Dict[bytes, bytes] = {}
    if offset != _MISSING:
        store.node(file, offset, length, height, b"", out)
    return dict(sorted(out.items())), store.bytes_read
