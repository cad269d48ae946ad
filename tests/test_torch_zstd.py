"""The port's zstd decoder (``convert/zstd.py``) against the ``zstandard``
module's compressor, on the CPU: random bytes, float32 arrays, long runs,
text, the empty input, payloads of several 128 KiB blocks and payloads
larger than the window, at levels -5, 1, 3, 9 and 19, with and without the
content size and the checksum; several frames in one buffer and skippable
frames; a wrong checksum, a truncated frame and a dictionary are refused."""

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from feartracker_tpu_torch.convert import zstd

LEVELS = (-5, 1, 3, 9, 19)
SETTINGS = dict(max_examples=25, deadline=None, derandomize=True, database=None)


def _compress(data: bytes, level: int, checksum: bool, content_size: bool, window_log: int = 0) -> bytes:
    if window_log:
        params = zstandard.ZstdCompressionParameters.from_level(level, window_log=window_log,
                                                                write_checksum=checksum,
                                                                write_content_size=content_size)
        return zstandard.ZstdCompressor(compression_params=params).compress(data)
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


def _payload(kind: str, seed: int, size: int) -> bytes:
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.bytes(size)
    if kind == "float32":
        return rng.randn(size // 4).astype(np.float32).tobytes()
    if kind == "runs":
        lengths = rng.randint(1, 300, size // 100 + 1)
        return b"".join(bytes([int(v)]) * int(n) for v, n in zip(rng.randint(0, 4, len(lengths)), lengths))[:size]
    if kind == "text":
        words = [b"tracker", b"the", b"box", b"frame", b"search", b"template", b"\n", b"0.5", b"  "]
        return b" ".join(words[i] for i in rng.randint(0, len(words), size // 5 + 1))[:size]
    # a weight-like mix: float32 runs, zeros, and repeats of earlier bytes
    head = rng.randn(size // 8).astype(np.float32).tobytes()
    return (head + bytes(size // 4) + head[: size // 8])[:size]


@settings(**SETTINGS)
@given(kind=st.sampled_from(["random", "float32", "runs", "text", "mixed"]), seed=st.integers(0, 2**16),
       size=st.integers(0, 40_000), level=st.sampled_from(LEVELS), checksum=st.booleans(),
       content_size=st.booleans())
def test_decode_equals_the_input(kind, seed, size, level, checksum, content_size):
    data = _payload(kind, seed, size)
    assert zstd.decompress(_compress(data, level, checksum, content_size)) == data


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["float32", "runs", "mixed"])
def test_several_blocks(kind, level):
    """More than 128 KiB: several compressed blocks, whose Huffman and FSE
    tables and repeat offsets carry from block to block."""
    data = _payload(kind, level + 10, 300_000 if level < 19 else 140_000)
    for checksum in (False, True):
        assert zstd.decompress(_compress(data, level, checksum, True)) == data


@pytest.mark.parametrize("level", (1, 9))
def test_input_larger_than_the_window(level):
    """A 1 KiB window over 64 KiB: a windowed (not single-segment) frame
    whose matches reach back at most the window."""
    rng = np.random.RandomState(level)
    block = rng.bytes(700)
    data = b"".join(block[: rng.randint(100, 700)] + rng.bytes(50) for _ in range(120))
    frame = _compress(data, level, True, False, window_log=10)
    assert not frame[4] & 0x20  # Single_Segment_flag clear: a window descriptor follows
    assert zstd.decompress(frame) == data


def test_frames_and_skippable_frames():
    a, b = b"first frame " * 50, np.arange(5000, dtype=np.float32).tobytes()
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"ABCDE"
    buf = _compress(a, 3, True, True) + skip + _compress(b, 1, False, False) + _compress(b"", 1, True, True)
    assert zstd.decompress(buf) == a + b


def test_the_weights_archive_decodes():
    """FEAR-XS's float32 weights, the bulk of a training checkpoint."""
    with np.load("feartracker_tpu/weights/fear_xs.npz") as z:
        data = b"".join(z[k].astype(np.float32).tobytes() for k in sorted(z.files)[:60])
    assert zstd.decompress(_compress(data, 1, True, True)) == data


def test_a_wrong_checksum_raises():
    data = np.random.RandomState(0).randn(3000).astype(np.float32).tobytes()
    frame = bytearray(_compress(data, 3, True, True))
    assert zstd.decompress(bytes(frame)) == data
    frame[-1] ^= 0x01
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_truncated_and_foreign_input_raise():
    frame = _compress(b"abc" * 1000 + np.random.RandomState(1).bytes(2000), 3, True, True)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame[:-9])
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"PK\x03\x04" + frame)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"")


def test_a_dictionary_frame_raises():
    samples = [(b"sample %d of the dictionary " % i) * 20 for i in range(200)]
    dictionary = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(b"sample 7 of the dictionary " * 3)
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame)


def test_xxh64_known_values():
    """XXH64 with seed 0 (the content checksum's hash) on the reference
    implementation's published values."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
