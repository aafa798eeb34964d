"""Zstandard decoding and CRC-32C on the host, for reading the orbax
checkpoints of the JAX package (utils/ocdbt.py, utils/orbax.py) where
neither `zstandard` nor `tensorstore` is installed.

The decoder is the port's own C++ (`csrc/zstd.cpp`, RFC 8878 frames without
dictionaries), built with g++ at first use into `emotiongestures_torch/
_build/` through data/store.py's builder and loaded with ctypes. Bad input
raises `ZstdError` with the decoder's message.

    decompress(data)                -> bytes
    decompress_into(data, out)      -> bytes written into a writable buffer
    crc32c(data)                    -> int
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..data.store import PACKAGE, load_shared

ZSTD_SRC = PACKAGE / "csrc" / "zstd.cpp"

_P, _SZ = ctypes.c_void_p, ctypes.c_size_t
_SIGNATURES = {
    "egtp_zstd_decompress": ([_P, _SZ, _P, _SZ, ctypes.c_char_p, _SZ],
                             ctypes.c_longlong),
    "egtp_zstd_content_size": ([_P, _SZ], ctypes.c_longlong),
    "egtp_crc32c": ([_P, _SZ, ctypes.c_uint32], ctypes.c_uint32),
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


class ZstdError(ValueError):
    """A zstd frame that does not decode."""


def native() -> ctypes.CDLL:
    """The loaded decoder, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_shared(ZSTD_SRC, "libegtp_zstd", _SIGNATURES)
    return _lib


def _view(data):
    """(pointer, length, keep-alive) of a bytes-like object."""
    arr = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)
    return arr.ctypes.data, len(data), arr


def content_size(data) -> int | None:
    """The summed content sizes the frames declare, or None when one does
    not declare it."""
    ptr, n, _keep = _view(data)
    got = native().egtp_zstd_content_size(ptr, n)
    if got == -3:
        raise ZstdError("not a sequence of zstd frames")
    return None if got < 0 else int(got)


def decompress_into(data, out) -> int:
    """Decode every frame of `data` into the writable buffer `out` (a numpy
    array or bytearray); returns the bytes written. Raises ZstdError on bad
    input and ValueError when `out` is too small."""
    ptr, n, _keep = _view(data)
    dst = np.frombuffer(out, np.uint8) if not isinstance(out, np.ndarray) \
        else out.reshape(-1).view(np.uint8)
    if not dst.flags.writeable:
        raise ValueError("decompress_into needs a writable buffer")
    err = ctypes.create_string_buffer(256)
    got = native().egtp_zstd_decompress(
        ptr, n, dst.ctypes.data if dst.size else None, dst.size, err, 256)
    if got == -2:
        raise ValueError(f"zstd output larger than the {dst.size}-byte "
                         "buffer")
    if got < 0:
        raise ZstdError(err.value.decode(errors="replace"))
    return int(got)


def decompress(data, max_output: int | None = None) -> bytes:
    """Decode every frame of `data`. Frames that declare their content size
    decode in one pass; otherwise the buffer grows (up to `max_output`
    bytes when given)."""
    size = content_size(data)
    cap = size if size is not None else max(4 * len(data), 1 << 16)
    while True:
        if max_output is not None:
            cap = min(cap, max_output)
        buf = np.empty(max(cap, 1), np.uint8)
        try:
            n = decompress_into(data, buf)
        except ZstdError:
            raise
        except ValueError:
            if size is not None:
                raise ZstdError("frames decode past their declared content "
                                "size") from None
            if max_output is not None and cap >= max_output:
                raise
            cap *= 4
            continue
        return buf[:n].tobytes()


def crc32c(data, value: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `value`."""
    ptr, n, _keep = _view(data)
    return int(native().egtp_crc32c(ptr, n, value))

