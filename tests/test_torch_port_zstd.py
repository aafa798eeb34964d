"""The port's C++ zstd decoder (csrc/zstd.cpp through utils/zstd.py)
against the `zstandard` package, which is not needed by the port and is
used here only to make frames: byte-equal output for every input kind and
level, frames over 128 KiB (several blocks, matches reaching back across
them), with and without a checksum and a content size, concatenated and
skippable frames; truncated and corrupted frames raise. Also the CRC-32C
that utils/ocdbt.py checks every node with."""
import struct

import numpy as np
import pytest

from emotiongestures_torch.utils import zstd

Z = pytest.importorskip("zstandard")

LEVELS = (-5, 1, 3, 9, 19)


def _inputs():
    r = np.random.default_rng(0)
    text = b" ".join(b"gesture%d emotion %s" % (i, b"happy" if i % 3 else
                                                  b"sad") for i in range(4000))
    return {
        "empty": b"",
        "random": r.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
        "constant": b"\x07" * 50000,
        "text": text,
        "float32": (0.05 * r.standard_normal(40000)).astype(
            np.float32).tobytes(),
    }


INPUTS = _inputs()


def _frame(data, level=3, checksum=False, content_size=True):
    return Z.ZstdCompressor(level=level, write_checksum=checksum,
                            write_content_size=content_size).compress(data)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", list(INPUTS))
def test_decodes_what_zstandard_encodes(kind, level):
    data = INPUTS[kind]
    assert zstd.decompress(_frame(data, level)) == data


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_large_frames_with_and_without_checksum_and_size(checksum,
                                                         content_size):
    """Over 128 KiB: several blocks, and a window spanning them (repeated
    text draws its matches from earlier blocks)."""
    data = INPUTS["text"] * 4 + INPUTS["float32"] * 2 + INPUTS["random"]
    assert len(data) > 3 * 128 * 1024
    frame = _frame(data, 3, checksum, content_size)
    assert zstd.content_size(frame) == (len(data) if content_size else None)
    assert zstd.decompress(frame) == data
    out = np.empty(len(data), np.uint8)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out.tobytes() == data


def test_streamed_frame_without_content_size():
    """A frame written by a streaming compressor with flushes: blocks
    without a declared content size, the window carried across them."""
    import io

    sink = io.BytesIO()
    with Z.ZstdCompressor(level=3).stream_writer(sink, closefd=False) as f:
        for _ in range(6):
            f.write(INPUTS["text"][:30000])
            f.flush()
    assert zstd.decompress(sink.getvalue()) == INPUTS["text"][:30000] * 6


def test_concatenated_and_skippable_frames():
    skip = struct.pack("<II", 0x184D2A5E, 6) + b"orbax!"
    frames = (skip + _frame(INPUTS["text"], 1, checksum=True) + skip
              + _frame(INPUTS["float32"], 9, content_size=False)
              + _frame(b"", 3))
    assert zstd.decompress(frames) == INPUTS["text"] + INPUTS["float32"]
    assert zstd.decompress(b"") == b""


def test_truncated_frames_raise():
    frame = _frame(INPUTS["text"], 3, checksum=True)
    for cut in (3, 5, 12, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])


def test_bad_checksum_and_bad_magic_raise():
    frame = bytearray(_frame(INPUTS["text"], 3, checksum=True))
    frame[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"\x00" * 16)


def test_corrupted_bytes_never_pass_silently():
    """A single byte changed anywhere in a checksummed frame either raises
    or still decodes to the data (a byte the decoder never reads)."""
    data = INPUTS["text"][:20000] + INPUTS["float32"][:20000]
    frame = _frame(data, 3, checksum=True)
    r = np.random.default_rng(1)
    for i in r.choice(np.arange(5, len(frame)), 300, replace=False):
        bad = bytearray(frame)
        bad[i] ^= int(r.integers(1, 256))
        try:
            got = zstd.decompress(bytes(bad))
        except ValueError:
            continue
        assert got == data, i


def test_offset_past_the_window_raises():
    """A match 3000 bytes back in a frame whose window descriptor was cut
    to 1 KiB after compressing."""
    x = INPUTS["random"][:3000]
    params = Z.ZstdCompressionParameters.from_level(
        3, window_log=12, write_content_size=0)
    frame = bytearray(Z.ZstdCompressor(compression_params=params)
                      .compress(x + x))
    assert zstd.decompress(bytes(frame)) == x + x
    assert not frame[4] & 0x20  # not single-segment: a window descriptor
    frame[5] = 0  # 2^10 bytes
    with pytest.raises(zstd.ZstdError, match="window"):
        zstd.decompress(bytes(frame))


def test_crc32c_known_values():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(b"56789", zstd.crc32c(b"1234")) == 0xE3069283
