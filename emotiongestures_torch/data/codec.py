"""Self-owned binary record codec (a copy of
emotiongestures_tpu/data/codec.py): records are bytes on disk, so the two
packages read and write each other's stores byte for byte. It replaces the
reference's dead pyarrow-0.14 `serialize` format (SURVEY.md §2.6).

A record is the reference's window tuple
(data_loader/lmdb_loader_BEAT_full.py:180):
  (word_seq, pose_seq, audio, spectrogram, aux_info)

Wire format (little-endian), version 1:
  magic  b'EGTP'  | u16 version | u16 n_fields
  per field: u8 name_len | name | u8 kind | payload
    kind 0 = ndarray: u8 dtype_len | dtype str | u8 ndim | i64*ndim shape
             | raw bytes (C order)
    kind 1 = json (utf-8): u32 len | bytes      (aux_info, word_seq)

The same layout is implemented by the C++ batch gather in csrc/codec.cpp;
this module is the authoritative spec and the per-record Python path.
"""
from __future__ import annotations

import json
import math
import struct

import numpy as np

MAGIC = b"EGTP"
VERSION = 1
_KIND_NDARRAY = 0
_KIND_JSON = 1


def encode_record(record: dict) -> bytes:
    """Encode a dict of {str: ndarray | json-able} to bytes."""
    parts = [MAGIC, struct.pack("<HH", VERSION, len(record))]
    for name, value in record.items():
        name_b = name.encode("utf-8")
        parts.append(struct.pack("<B", len(name_b)))
        parts.append(name_b)
        if isinstance(value, np.ndarray):
            dtype_b = value.dtype.str.encode("ascii")
            parts.append(struct.pack("<BB", _KIND_NDARRAY, len(dtype_b)))
            parts.append(dtype_b)
            parts.append(struct.pack("<B", value.ndim))
            parts.append(struct.pack(f"<{value.ndim}q", *value.shape))
            parts.append(np.ascontiguousarray(value).tobytes())
        else:
            payload = json.dumps(value).encode("utf-8")
            parts.append(struct.pack("<BI", _KIND_JSON, len(payload)))
            parts.append(payload)
    return b"".join(parts)


def decode_record(buf: bytes | memoryview) -> dict:
    """Decode bytes back to a dict. ndarrays are zero-copy views when
    `buf` is a memoryview over a mapped file."""
    view = memoryview(buf)
    if bytes(view[:4]) != MAGIC:
        raise ValueError("bad magic; not an EGTP record")
    version, n_fields = struct.unpack_from("<HH", view, 4)
    if version != VERSION:
        raise ValueError(f"unsupported record version {version}")
    off = 8
    out = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<B", view, off)
        off += 1
        name = bytes(view[off : off + name_len]).decode("utf-8")
        off += name_len
        (kind,) = struct.unpack_from("<B", view, off)
        off += 1
        if kind == _KIND_NDARRAY:
            (dtype_len,) = struct.unpack_from("<B", view, off)
            off += 1
            dtype = np.dtype(bytes(view[off : off + dtype_len]).decode())
            off += dtype_len
            (ndim,) = struct.unpack_from("<B", view, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}q", view, off)
            off += 8 * ndim
            count = math.prod(shape)
            nbytes = count * dtype.itemsize
            arr = np.frombuffer(view, dtype=dtype, count=count,
                                offset=off).reshape(shape)
            off += nbytes
            out[name] = arr
        elif kind == _KIND_JSON:
            (length,) = struct.unpack_from("<I", view, off)
            off += 4
            out[name] = json.loads(bytes(view[off : off + length]))
            off += length
        else:
            raise ValueError(f"unknown field kind {kind}")
    return out


_ITEMSIZE_CACHE: dict = {}


def _itemsize(dtype_bytes: bytes) -> int:
    size = _ITEMSIZE_CACHE.get(dtype_bytes)
    if size is None:
        size = np.dtype(dtype_bytes.decode()).itemsize
        _ITEMSIZE_CACHE[dtype_bytes] = size
    return size


def decode_json_fields(buf: bytes | memoryview) -> dict:
    """Decode ONLY the json-kind fields of a record (aux_info, word_seq),
    skipping ndarray payloads without materialising them — the cheap
    metadata path for batch iterators that gather the array fields
    through the native codec (`GestureStore.batch_field`)."""
    view = memoryview(buf)
    if bytes(view[:4]) != MAGIC:
        raise ValueError("bad magic; not an EGTP record")
    version, n_fields = struct.unpack_from("<HH", view, 4)
    if version != VERSION:
        raise ValueError(f"unsupported record version {version}")
    off = 8
    out = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<B", view, off)
        off += 1
        name = bytes(view[off : off + name_len]).decode("utf-8")
        off += name_len
        (kind,) = struct.unpack_from("<B", view, off)
        off += 1
        if kind == _KIND_NDARRAY:
            (dtype_len,) = struct.unpack_from("<B", view, off)
            off += 1
            itemsize = _itemsize(bytes(view[off : off + dtype_len]))
            off += dtype_len
            (ndim,) = struct.unpack_from("<B", view, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}q", view, off)
            off += 8 * ndim + math.prod(shape) * itemsize
        elif kind == _KIND_JSON:
            (length,) = struct.unpack_from("<I", view, off)
            off += 4
            out[name] = json.loads(bytes(view[off : off + length]))
            off += length
        else:
            raise ValueError(f"unknown field kind {kind}")
    return out
