"""A Zstandard decoder (RFC 8878) in Python and numpy, so that the port
reads the JAX trainer's Orbax checkpoints where no ``zstandard`` module is
installed (the card host has none, and Python 3.12's library has no zstd).

:func:`decompress` decodes every frame of a buffer (skippable frames are
skipped) and returns their content joined:

* frames: single-segment or windowed, the frame-content-size field (held
  against what was decoded), the optional XXH64 content checksum (verified);
  a frame that names a dictionary raises, as no dictionary is at hand;
* blocks: raw, RLE and compressed;
* literals: raw, RLE, Huffman-coded in one or four streams, and treeless
  (the previous block's Huffman table);
* sequences: predefined, RLE, FSE-coded and repeat table modes, and the
  three repeat offsets that carry from block to block within a frame.

Huffman literals are the bulk of a checkpoint (float weights barely
compress): they are decoded with numpy. Every bit position of a stream gets
its table lookup at once (the code that starts there and its length), and
the positions where codes really start are found by pointer doubling over
"next position = position + code length", so no Python loop runs per
literal. Sequences, which are few in such data, are decoded in a Python
loop.

Errors raise :class:`ZstdError`.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

FRAME_MAGIC = 0xFD2FB528
_MAX_BLOCK = 128 * 1024


class ZstdError(ValueError):
    """A malformed, truncated or unsupported zstd frame."""


# -- tables of the format (RFC 8878 3.1.1.3.2.1) --------------------------------

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
                              8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = [c + 3 for c in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                         2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

_LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1,
                   1, 1, -1, -1, -1, -1])
_ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1])
_OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1,
                   -1])
# (max symbol, max accuracy log) of the literal-length, offset and
# match-length codes
_LL_LIMITS, _OF_LIMITS, _ML_LIMITS = (35, 9), (31, 8), (52, 9)

# -- XXH64 (the content checksum) --------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``: zstd's content checksum is its low 32 bits."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=stripes * 4).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1 & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        pos = stripes * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, pos)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= (struct.unpack_from("<I", data, pos)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# -- bit streams ------------------------------------------------------------------


class _BackwardBits:
    """A bit stream read from its end (FSE and Huffman streams): the last
    byte's highest set bit is a sentinel, and bits are taken from just below
    it toward the first byte, most significant first. Reading past the first
    byte yields zeros; :meth:`overflowed` says whether that happened."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ZstdError("bit stream without its end marker")
        self.buf = buf
        self.pos = 8 * (len(buf) - 1) + buf[-1].bit_length() - 1  # bits left

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            x = int.from_bytes(self.buf[p >> 3:((p + n - 1) >> 3) + 1], "little")
            return (x >> (p & 7)) & ((1 << n) - 1)
        top = p + n  # bits of the stream still inside the read
        if top <= 0:
            return 0
        x = int.from_bytes(self.buf[:((top - 1) >> 3) + 1], "little") & ((1 << top) - 1)
        return x << (-p)

    def overflowed(self) -> bool:
        return self.pos < 0


def _read_ncount(src: bytes, pos: int, end: int, limits: Tuple[int, int]) -> Tuple[int, List[int], int]:
    """An FSE table description (RFC 8878 4.1.1): ``(accuracy log,
    normalized counts with -1 for "less than one", position after it)``."""
    max_symbol, max_log = limits
    end = min(end, pos + 512)  # a description is far shorter: keep the int small
    data = int.from_bytes(src[pos:end], "little")
    avail = 8 * (end - pos)
    log = (data & 0xF) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = len(counts)
            while (data >> bit) & 0xFFFF == 0xFFFF:
                n0 += 24
                bit += 16
            while (data >> bit) & 3 == 3:
                n0 += 3
                bit += 2
            n0 += (data >> bit) & 3
            bit += 2
            if n0 > max_symbol + 1:
                raise ZstdError("FSE table: zero run past the last symbol")
            counts.extend([0] * (n0 - len(counts)))
            if n0 > max_symbol:
                break
        most = (2 * threshold - 1) - remaining
        low = (data >> bit) & (threshold - 1)
        if low < most:
            count = low
            bit += nbits - 1
        else:
            count = (data >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= most
            bit += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or bit > avail:
        raise ZstdError("corrupt FSE table description")
    return log, counts, pos + (bit + 7) // 8


def _fse_table(log: int, counts: Sequence[int]) -> Tuple[List[int], List[int], List[int]]:
    """The decoding table of a distribution: per state its symbol, the bits
    to read and the baseline the next state adds them to."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    next_state = []
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            next_state.append(1)
        else:
            next_state.append(c)
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("FSE counts do not fill the table")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        ns = next_state[s]
        next_state[s] += 1
        nb[u] = log - (ns.bit_length() - 1)
        base[u] = (ns << nb[u]) - size
    return sym, nb, base


def _rle_table(symbol: int) -> Tuple[List[int], List[int], List[int]]:
    return [symbol], [0], [0]


# -- Huffman literals ---------------------------------------------------------------


class _Huffman:
    """A literal table: per ``max_bits``-bit window (read most significant
    bit first), the symbol whose code starts it and that code's length."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman weights are all zero")
        max_bits = total.bit_length()
        rest = (1 << max_bits) - total
        if rest & (rest - 1) or max_bits > 11:
            raise ZstdError("corrupt Huffman weights")
        weights = weights + [rest.bit_length()]
        if len(weights) > 256:
            raise ZstdError("more than 256 Huffman symbols")
        start = [0] * (max_bits + 2)
        for w in weights:
            if w:
                start[w + 1] += 1 << (w - 1)
        for w in range(1, max_bits + 2):
            start[w] += start[w - 1]
        sym = np.zeros(1 << max_bits, np.uint8)
        nb = np.zeros(1 << max_bits, np.int64)
        for s, w in enumerate(weights):
            if w:
                n = 1 << (w - 1)
                sym[start[w]:start[w] + n] = s
                nb[start[w]:start[w] + n] = max_bits + 1 - w
                start[w] += n
        self.max_bits, self.sym, self.nb = max_bits, sym, nb

    def decode_stream(self, stream: bytes, count: int) -> np.ndarray:
        """``count`` literals of one stream, which they must use up exactly."""
        if count == 0:
            return np.zeros(0, np.uint8)
        if not stream or stream[-1] == 0:
            raise ZstdError("Huffman stream without its end marker")
        h = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
        L = self.max_bits
        # read backwards, the stream is its bytes in reverse order, each
        # most significant bit first, after the sentinel bit of the last
        rev = np.frombuffer(stream[::-1] + b"\0\0\0", np.uint8).astype(np.int64)
        word = (rev[:-2] << 16) | (rev[1:-1] << 8) | rev[2:]  # 24 bits from each byte on
        q = np.arange(h, dtype=np.int64) + (9 - stream[-1].bit_length())
        window = (word[q >> 3] >> (24 - L - (q & 7))) & ((1 << L) - 1)
        length = self.nb[window]
        # where the next code starts; a code that would run past the
        # stream's end points at the sink h
        nxt = np.minimum(np.arange(h, dtype=np.int64) + length, h)
        nxt = np.append(nxt, h)
        starts = np.empty(count, np.int64)
        starts[0] = 0
        filled, jump = 1, nxt
        while filled < count:
            m = min(filled, count - filled)
            starts[filled:filled + m] = jump[starts[:m]]
            filled += m
            if filled < count:
                jump = jump[jump]
        last = int(starts[-1])
        if last >= h or last + int(length[last]) != h:
            raise ZstdError("Huffman stream does not hold its literals exactly")
        return self.sym[window[starts]]


def _huffman_weights_fse(src: bytes, pos: int, size: int) -> List[int]:
    end = pos + size
    log, counts, p = _read_ncount(src, pos, end, (255, 6))
    sym, nb, base = _fse_table(log, counts)
    bits = _BackwardBits(src[p:end])
    s1, s2 = bits.read(log), bits.read(log)
    out: List[int] = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.overflowed():
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.overflowed():
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ZstdError("too many Huffman weights")
    return out


def _read_huffman(src: bytes, pos: int) -> Tuple[_Huffman, int]:
    """A Huffman tree description → (table, position after it)."""
    header = src[pos]
    pos += 1
    if header < 128:
        return _Huffman(_huffman_weights_fse(src, pos, header)), pos + header
    n = header - 127
    raw = src[pos:pos + (n + 1) // 2]
    weights = [(raw[i // 2] >> 4) if i % 2 == 0 else (raw[i // 2] & 0xF) for i in range(n)]
    return _Huffman(weights), pos + (n + 1) // 2


# -- frames -------------------------------------------------------------------------


class _FrameState:
    """What one block leaves to the next within a frame."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.ll = self.of = self.ml = None
        self.reps = [1, 4, 8]


def _literals(src: bytes, pos: int, end: int, st: _FrameState) -> Tuple[bytes, int]:
    b0 = src[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (src[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (src[pos + 1] << 4) + (src[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals past the block's end")
            return bytes(src[pos:pos + size]), pos + size
        return bytes([src[pos]]) * size, pos + 1
    n_hdr = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    h = int.from_bytes(src[pos:pos + n_hdr], "little")
    bits = {3: 10, 4: 14, 5: 18}[n_hdr]
    regen = (h >> 4) & ((1 << bits) - 1)
    comp = (h >> (4 + bits)) & ((1 << bits) - 1)
    pos += n_hdr
    end_lit = pos + comp
    if end_lit > end:
        raise ZstdError("compressed literals past the block's end")
    if kind == 2:
        st.huffman, pos = _read_huffman(src, pos)
    elif st.huffman is None:
        raise ZstdError("treeless literals with no earlier Huffman table")
    huf = st.huffman
    if fmt == 0:
        out = huf.decode_stream(bytes(src[pos:end_lit]), regen)
    else:
        s1, s2, s3 = struct.unpack_from("<HHH", src, pos)
        pos += 6
        bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, end_lit]
        if bounds[3] > end_lit:
            raise ZstdError("literal stream sizes past the literals' end")
        q = (regen + 3) // 4
        sizes = [q, q, q, regen - 3 * q]
        if sizes[3] < 0:
            raise ZstdError("four literal streams for fewer than four literals")
        out = np.concatenate([huf.decode_stream(bytes(src[bounds[i]:bounds[i + 1]]), sizes[i])
                              for i in range(4)])
    return out.tobytes(), end_lit


def _seq_table(mode: int, src: bytes, pos: int, end: int, default, limits, previous, name: str):
    if mode == 0:
        return _fse_table(*default), pos
    if mode == 1:
        if src[pos] > limits[0]:
            raise ZstdError(f"{name} RLE symbol out of range")
        return _rle_table(src[pos]), pos + 1
    if mode == 2:
        log, counts, pos = _read_ncount(src, pos, end, limits)
        return _fse_table(log, counts), pos
    if previous is None:
        raise ZstdError(f"{name} repeat mode with no earlier table")
    return previous, pos


def _block(src: bytes, pos: int, end: int, out: bytearray, st: _FrameState) -> None:
    lits, pos = _literals(src, pos, end, st)
    if pos >= end:
        raise ZstdError("block without its sequences section")
    b0 = src[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + src[pos + 1], pos + 2
    else:
        nseq, pos = src[pos + 1] + (src[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    modes = src[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequences' modes")
    (ll_sym, ll_nb, ll_base), pos = _seq_table(modes >> 6, src, pos, end, _LL_DEFAULT, _LL_LIMITS, st.ll,
                                               "literal length")
    (of_sym, of_nb, of_base), pos = _seq_table((modes >> 4) & 3, src, pos, end, _OF_DEFAULT, _OF_LIMITS,
                                               st.of, "offset")
    (ml_sym, ml_nb, ml_base), pos = _seq_table((modes >> 2) & 3, src, pos, end, _ML_DEFAULT, _ML_LIMITS,
                                               st.ml, "match length")
    st.ll, st.of, st.ml = (ll_sym, ll_nb, ll_base), (of_sym, of_nb, of_base), (ml_sym, ml_nb, ml_base)
    bits = _BackwardBits(bytes(src[pos:end]))
    read = bits.read
    ll_s = read(len(ll_sym).bit_length() - 1)
    of_s = read(len(of_sym).bit_length() - 1)
    ml_s = read(len(ml_sym).bit_length() - 1)
    reps = st.reps
    lp = 0
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31:
            raise ZstdError("offset code out of range")
        offset = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset > 3:
            offset -= 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            idx = offset - 1 + (ll == 0)
            if idx == 0:
                offset = reps[0]
            elif idx == 3:
                offset = reps[0] - 1
                reps[2], reps[1], reps[0] = reps[1], reps[0], offset
            else:
                offset = reps[idx]
                if idx == 2:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], offset
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > len(lits):
            raise ZstdError("sequence takes more literals than the block has")
        out += lits[lp:lp + ll]
        lp += ll
        start = len(out) - offset
        if offset <= 0 or start < 0:
            raise ZstdError("match offset before the frame's start (a dictionary is not supported)")
        if offset >= ml:
            out += out[start:start + ml]
        else:
            out += (out[start:] * (ml // offset + 1))[:ml]
    if bits.pos != 0:
        raise ZstdError("sequences do not use up their bit stream")
    out += lits[lp:]


def _frame(src: bytes, pos: int) -> Tuple[bytes, int]:
    fhd = src[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 0x08:
        raise ZstdError("reserved bit set in the frame header")
    if not single:
        pos += 1  # window descriptor: the whole frame is kept, so any window fits
    did_size = (0, 1, 2, 4)[did_flag]
    if did_size and int.from_bytes(src[pos:pos + did_size], "little"):
        raise ZstdError("the frame needs a zstd dictionary, which this decoder does not support")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(src[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
        pos += fcs_size
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > len(src):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(src[pos:pos + 3], "little")
        pos += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 0:
            if pos + size > len(src):
                raise ZstdError("truncated raw block")
            out += src[pos:pos + size]
            pos += size
        elif kind == 1:
            out += bytes([src[pos]]) * size
            pos += 1
        elif kind == 2:
            if size > _MAX_BLOCK or pos + size > len(src):
                raise ZstdError("compressed block too large or truncated")
            _block(src, pos, pos + size, out, st)
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content_size is not None and content_size != len(out):
        raise ZstdError(f"frame holds {len(out)} bytes, its header says {content_size}")
    if checksum:
        want = int.from_bytes(src[pos:pos + 4], "little")
        if len(src) < pos + 4 or xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return bytes(out), pos


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data``, joined."""
    src = bytes(data)
    pos = 0
    parts = []
    if not src:
        raise ZstdError("no zstd frame")
    while pos < len(src):
        if len(src) - pos < 4:
            raise ZstdError("trailing bytes after the last frame")
        magic = struct.unpack_from("<I", src, pos)[0]
        pos += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            pos += 4 + struct.unpack_from("<I", src, pos)[0]
            continue
        if magic != FRAME_MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        try:
            part, pos = _frame(src, pos)
        except (IndexError, struct.error) as e:
            raise ZstdError(f"truncated zstd frame: {e}") from e
        parts.append(part)
    return b"".join(parts)
