"""Reader and writer of the pyarrow-0.14 ``serialize`` wire format, the
layout of every value in the reference's LMDB caches
(``pyarrow.serialize(v).to_buffer()`` at data_preprocessor.py:163, read back
by ``pyarrow.deserialize`` at lmdb_loader_BEAT_full.py:176). Modern pyarrow
removed that API, so this module decodes and encodes the format with numpy
and ``struct`` alone. The port of emotiongestures_tpu/data/arrow014.py: the
reader is a copy, and the writer builds its flatbuffers with `_Builder`, a
byte-for-byte rendering of the ``flatbuffers`` package's Python ``Builder``,
which this package does not import.

Wire layout (arrow 0.14 ``SerializedPyObject::WriteTo``,
cpp/src/arrow/python/serialize.cc):

    int32 num_tensors | int32 num_ndarrays | int32 num_buffers
    ...pad to 8...
    Arrow IPC stream (LEGACY pre-0.15 framing: <int32 size><flatbuffer>
        messages, no 0xFFFFFFFF continuation): Schema message, then ONE
        RecordBatch holding the object tree as a List<DenseUnion> column,
        then EOS (<int32 0>)
    ...pad to 64...
    per ndarray: a Tensor IPC message (metadata + 64-aligned body)
    per py buffer: <int64 size><bytes>

The union's children exist only for python types actually present
(arrow registers them on first use); dispatch here is by child FIELD
NAME + arrow type, which is stable across 0.13-0.16:
    bools/ints/strings/bytes/floats/doubles -> scalars
    tensors/ndarrays/buffers (int32)        -> indices into the
                                               out-of-band tensor blocks
    lists/tuples/sets (list<union>)         -> recursive sequences
    dicts (struct{keys,vals:list<union>})   -> dict

Pre-1.0 IPC details honored for metadata version <= V4: dense unions
carry a leading validity buffer ([validity, type_ids, offsets]); Null
arrays carry one validity buffer. V5 framing/layout (continuation
marker, no union validity) is ALSO accepted, so streams re-encoded by
0.15-0.17 ``serialize`` decode too.

The writer emits the legacy-0.14 layout above, the same bytes as the JAX
package's writer (tests/test_torch_port_migration.py holds the two to it,
and to the committed fixtures in tests/fixtures/).
"""
from __future__ import annotations

import struct

import numpy as np

# --------------------------------------------------------------------------
# minimal flatbuffer TABLE reader (little-endian, per the flatbuffers
# internals spec: root uoffset -> table; table starts with soffset to its
# vtable; vtable = [u16 vtable_bytes, u16 table_bytes, u16 field_off...])
# --------------------------------------------------------------------------


class _Table:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int):
        self.buf = buf
        self.pos = pos

    @classmethod
    def root(cls, buf, base: int = 0) -> "_Table":
        (off,) = struct.unpack_from("<I", buf, base)
        return cls(buf, base + off)

    def _field(self, slot: int) -> int:
        """Byte offset of slot's value within the table, 0 if absent."""
        (soff,) = struct.unpack_from("<i", self.buf, self.pos)
        vtab = self.pos - soff
        (vsize,) = struct.unpack_from("<H", self.buf, vtab)
        entry = 4 + 2 * slot
        if entry >= vsize:
            return 0
        (voff,) = struct.unpack_from("<H", self.buf, vtab + entry)
        return voff

    def _scalar(self, slot: int, fmt: str, default):
        voff = self._field(slot)
        if not voff:
            return default
        return struct.unpack_from(fmt, self.buf, self.pos + voff)[0]

    def u8(self, slot, default=0):
        return self._scalar(slot, "<B", default)

    def i16(self, slot, default=0):
        return self._scalar(slot, "<h", default)

    def i32(self, slot, default=0):
        return self._scalar(slot, "<i", default)

    def i64(self, slot, default=0):
        return self._scalar(slot, "<q", default)

    def bool_(self, slot, default=False):
        return bool(self._scalar(slot, "<B", int(default)))

    def _indirect(self, slot: int) -> int | None:
        """Absolute position a uoffset slot points at (tables, vectors,
        strings), None if absent."""
        voff = self._field(slot)
        if not voff:
            return None
        p = self.pos + voff
        (off,) = struct.unpack_from("<I", self.buf, p)
        return p + off

    def table(self, slot: int) -> "_Table | None":
        p = self._indirect(slot)
        return None if p is None else _Table(self.buf, p)

    def string(self, slot: int) -> str | None:
        p = self._indirect(slot)
        if p is None:
            return None
        (n,) = struct.unpack_from("<I", self.buf, p)
        return bytes(self.buf[p + 4:p + 4 + n]).decode("utf-8")

    def vector(self, slot: int) -> tuple[int, int]:
        """(length, absolute position of element 0); (0, -1) if absent."""
        p = self._indirect(slot)
        if p is None:
            return 0, -1
        (n,) = struct.unpack_from("<I", self.buf, p)
        return n, p + 4

    def vector_tables(self, slot: int) -> list["_Table"]:
        n, base = self.vector(slot)
        out = []
        for i in range(n):
            (off,) = struct.unpack_from("<I", self.buf, base + 4 * i)
            out.append(_Table(self.buf, base + 4 * i + off))
        return out

    def vector_i64(self, slot: int) -> list[int]:
        n, base = self.vector(slot)
        return list(struct.unpack_from(f"<{n}q", self.buf, base)) if n \
            else []

    def vector_i32(self, slot: int) -> list[int]:
        n, base = self.vector(slot)
        return list(struct.unpack_from(f"<{n}i", self.buf, base)) if n \
            else []

    def struct_pos(self, slot: int) -> int | None:
        """Absolute position of an inline struct field."""
        voff = self._field(slot)
        return None if not voff else self.pos + voff


# --------------------------------------------------------------------------
# Arrow flatbuffer schemas (format/*.fbs, slot ids = declaration order;
# unions take two slots: tag byte then value offset)
# --------------------------------------------------------------------------

# Message.fbs MessageHeader union tags
_MSG_SCHEMA, _MSG_DICT_BATCH, _MSG_RECORD_BATCH, _MSG_TENSOR = 1, 2, 3, 4
# Schema.fbs Type union tags (stable prefix since 0.8)
_T_NULL, _T_INT, _T_FLOAT, _T_BINARY, _T_UTF8, _T_BOOL = 1, 2, 3, 4, 5, 6
_T_DATE, _T_LIST, _T_STRUCT, _T_UNION = 8, 12, 13, 14
_V5 = 4  # MetadataVersion enum: V1=0..V5=4; pyarrow 0.14 wrote V4=3


class _Field:
    """Parsed Schema.fbs Field: name, type tag + params, children."""

    __slots__ = ("name", "tag", "params", "children")

    def __init__(self, table: _Table):
        self.name = table.string(0) or ""
        self.tag = table.u8(2)
        t = table.table(3)
        self.params = {}
        if self.tag == _T_INT:
            self.params = {"bits": t.i32(0, 0), "signed": t.bool_(1)}
        elif self.tag == _T_FLOAT:
            self.params = {"precision": t.i16(0, 0)}  # 0=half 1=f4 2=f8
        elif self.tag == _T_UNION:
            self.params = {"mode": t.i16(0, 0),  # 0=sparse 1=dense
                           "type_ids": t.vector_i32(1)}
        self.children = [_Field(c) for c in table.vector_tables(5)]


def _parse_schema(msg: _Table) -> list[_Field]:
    header = msg.table(2)
    return [_Field(f) for f in header.vector_tables(1)]


# --------------------------------------------------------------------------
# IPC stream walking
# --------------------------------------------------------------------------


class _Stream:
    """Cursor over the byte buffer with legacy/V5 message framing."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def read(self, n: int):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated arrow014 stream")
        self.pos += n
        return out

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.read(8))[0]

    def align(self, n: int):
        self.pos += (n - self.pos % n) % n

    def next_message(self) -> tuple[_Table | None, memoryview | None]:
        """Read one IPC message -> (Message table, body view). Returns
        (None, None) on EOS. Handles legacy <i32 size> framing (0.14),
        the V5 <0xFFFFFFFF><i32 size> continuation framing, and skips
        zero padding between messages (the 0.14 writer 64-aligns the
        stream between tensor blocks with zeros)."""
        while True:
            if self.pos >= len(self.buf):
                return None, None
            prefix = self.i32()
            if prefix == 0:
                return None, None  # EOS marker
            if prefix == -1:  # V5 continuation marker
                prefix = self.i32()
                if prefix == 0:
                    return None, None
            break
        meta = self.read(prefix)  # flatbuffer + its padding
        msg = _Table.root(meta)
        body_len = msg.i64(3, 0)
        body = self.read(body_len) if body_len else memoryview(b"")
        return msg, body


# --------------------------------------------------------------------------
# record-batch array materialization
# --------------------------------------------------------------------------

_NP_FLOAT = {0: np.float16, 1: np.float32, 2: np.float64}


class _Arrays:
    """Decoded column forest: walk (field, node, buffer) triples in the
    same pre-order the writer emitted them."""

    def __init__(self, batch: _Table, body, legacy_unions: bool):
        self.body = body
        self.legacy = legacy_unions
        n_nodes, p = batch.vector(1)
        self.nodes = [struct.unpack_from("<2q", batch.buf, p + 16 * i)
                      for i in range(n_nodes)]  # (length, null_count)
        n_bufs, p = batch.vector(2)
        self.bufs = [struct.unpack_from("<2q", batch.buf, p + 16 * i)
                     for i in range(n_bufs)]  # (offset, length)
        self._node_i = 0
        self._buf_i = 0

    def _node(self):
        n = self.nodes[self._node_i]
        self._node_i += 1
        return n

    def _buffer(self):
        off, length = self.bufs[self._buf_i]
        self._buf_i += 1
        return self.body[off:off + length]

    def _np(self, raw, dtype):
        return np.frombuffer(raw, dtype=dtype) if len(raw) else \
            np.empty(0, dtype=dtype)

    def read(self, field: _Field) -> dict:
        """One array (and its subtree) -> plain dict description."""
        length, null_count = self._node()
        tag = field.tag
        if tag == _T_NULL:
            # pre-V5 writers emitted a (possibly empty) validity buffer
            # for null arrays; V5 emits none
            if self.legacy:
                self._buffer()
            return {"kind": "null", "length": length}
        validity = self._buffer()
        valid = None
        if null_count and len(validity):
            bits = np.unpackbits(self._np(validity, np.uint8),
                                 bitorder="little")
            valid = bits[:length].astype(bool)
        if tag == _T_BOOL:
            bits = np.unpackbits(self._np(self._buffer(), np.uint8),
                                 bitorder="little")
            return {"kind": "prim", "data": bits[:length].astype(bool),
                    "valid": valid, "field": field}
        if tag == _T_INT:
            bits, signed = field.params["bits"], field.params["signed"]
            dt = np.dtype(f"{'i' if signed else 'u'}{bits // 8}")
            data = self._np(self._buffer(), dt)[:length]
            return {"kind": "prim", "data": data, "valid": valid,
                    "field": field}
        if tag == _T_FLOAT:
            dt = _NP_FLOAT[field.params["precision"]]
            data = self._np(self._buffer(), dt)[:length]
            return {"kind": "prim", "data": data, "valid": valid,
                    "field": field}
        if tag == _T_DATE:
            data = self._np(self._buffer(), np.int64)[:length]
            return {"kind": "date64", "data": data, "valid": valid}
        if tag in (_T_UTF8, _T_BINARY):
            offsets = self._np(self._buffer(), np.int32)[:length + 1]
            data = bytes(self._buffer())
            return {"kind": "utf8" if tag == _T_UTF8 else "bin",
                    "offsets": offsets, "data": data, "valid": valid}
        if tag == _T_LIST:
            offsets = self._np(self._buffer(), np.int32)[:length + 1]
            child = self.read(field.children[0])
            return {"kind": "list", "offsets": offsets, "child": child,
                    "valid": valid, "field": field}
        if tag == _T_STRUCT:
            children = {c.name: self.read(c) for c in field.children}
            return {"kind": "struct", "children": children,
                    "valid": valid, "length": length}
        if tag == _T_UNION:
            # pre-V5: [validity, type_ids, offsets]; V5: [type_ids,
            # offsets] — `validity` above already consumed the first
            # buffer either way
            type_ids_raw = validity if not self.legacy else self._buffer()
            type_ids = self._np(type_ids_raw, np.int8)[:length]
            offsets = self._np(self._buffer(), np.int32)[:length]
            code_map = field.params["type_ids"] or list(
                range(len(field.children)))
            children = [self.read(c) for c in field.children]
            return {"kind": "union", "type_ids": type_ids,
                    "offsets": offsets, "code_map": code_map,
                    "children": children, "fields": field.children}
        raise ValueError(
            f"arrow014: unsupported column type tag {tag} "
            f"(field {field.name!r})")


# --------------------------------------------------------------------------
# union tree -> python values
# --------------------------------------------------------------------------


def _seq_kind(name: str):
    name = name.lower()
    if "tuple" in name:
        return tuple
    if "set" in name:
        return set
    return list


def _ref_kind(name: str):
    name = name.lower()
    if "ndarray" in name:
        return "ndarrays"
    if "tensor" in name:
        return "tensors"
    if "buffer" in name:
        return "buffers"
    return None


def _union_value(arr: dict, index: int, ctx: dict):
    code = int(arr["type_ids"][index])
    child_idx = arr["code_map"].index(code)
    child, field = arr["children"][child_idx], arr["fields"][child_idx]
    return _value(child, int(arr["offsets"][index]), ctx, field)


def _value(arr: dict, i: int, ctx: dict, field: _Field):
    kind = arr["kind"]
    if kind == "null":
        return None
    if arr.get("valid") is not None and not arr["valid"][i]:
        return None
    if kind == "prim":
        ref = _ref_kind(field.name)
        if ref is not None and field.tag == _T_INT and \
                field.params["bits"] == 32:
            return ctx[ref][int(arr["data"][i])]
        v = arr["data"][i]
        if field.tag == _T_BOOL:
            return bool(v)
        return int(v) if field.tag == _T_INT else float(v)
    if kind == "utf8":
        lo, hi = int(arr["offsets"][i]), int(arr["offsets"][i + 1])
        return arr["data"][lo:hi].decode("utf-8")
    if kind == "bin":
        lo, hi = int(arr["offsets"][i]), int(arr["offsets"][i + 1])
        return arr["data"][lo:hi]
    if kind == "list":
        lo, hi = int(arr["offsets"][i]), int(arr["offsets"][i + 1])
        child = arr["child"]
        if child["kind"] != "union":
            raise ValueError("arrow014: list child must be a union")
        items = [_union_value(child, j, ctx) for j in range(lo, hi)]
        return _seq_kind(field.name)(items)
    if kind == "struct":  # serialize.cc DictBuilder: keys/vals sequences
        keys_arr = arr["children"].get("keys")
        vals_arr = arr["children"].get("vals")
        if keys_arr is None or vals_arr is None:
            raise ValueError("arrow014: struct without keys/vals — not a "
                             "serialized dict")
        kf = _Field.__new__(_Field)
        kf.name, kf.tag, kf.params, kf.children = "keys", _T_LIST, {}, []
        vf = _Field.__new__(_Field)
        vf.name, vf.tag, vf.params, vf.children = "vals", _T_LIST, {}, []
        keys = _value(keys_arr, i, ctx, kf)
        vals = _value(vals_arr, i, ctx, vf)
        return dict(zip(keys, vals))
    if kind == "date64":
        import datetime

        return datetime.datetime.utcfromtimestamp(
            int(arr["data"][i]) / 1000.0)
    raise ValueError(f"arrow014: cannot realize {kind}")


# --------------------------------------------------------------------------
# tensor messages
# --------------------------------------------------------------------------


def _tensor_dtype(tag: int, t: _Table) -> np.dtype:
    if tag == _T_INT:
        return np.dtype(f"{'i' if t.bool_(1) else 'u'}{t.i32(0, 0) // 8}")
    if tag == _T_FLOAT:
        return np.dtype(_NP_FLOAT[t.i16(0, 0)])
    if tag == _T_BOOL:
        return np.dtype(np.bool_)
    raise ValueError(f"arrow014: unsupported tensor type tag {tag}")


def _read_tensor(msg: _Table, body) -> np.ndarray:
    header = msg.table(2)
    dtype = _tensor_dtype(header.u8(0), header.table(1))
    shape = [d.i64(0, 0) for d in header.vector_tables(2)]
    strides = header.vector_i64(3)
    data_pos = header.struct_pos(4)
    off, length = (struct.unpack_from("<2q", header.buf, data_pos)
                   if data_pos is not None else (0, len(body)))
    raw = bytes(body[off:off + length]) if length else b""
    flat = np.frombuffer(raw, dtype=dtype)
    if not strides or not shape:
        return flat.reshape(shape)
    arr = np.lib.stride_tricks.as_strided(
        flat, shape=shape, strides=strides)
    return np.ascontiguousarray(arr)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def deserialize(buf) -> object:
    """Decode one ``pyarrow.serialize(...).to_buffer()`` byte string.
    The primary target is the exact pyarrow-0.14 layout the reference's
    caches hold (3-int header, legacy framing, pre-1.0 union buffers);
    0.15-0.17 re-encodings (4-int header with a sparse-tensor count, V5
    framing) are also accepted via fallback. numpy-only."""
    try:
        return _deserialize(buf, sparse_count_header=False)
    except Exception:
        # 0.15+ inserted int32 num_sparse_tensors after num_tensors;
        # both headers pad to the same 16-byte boundary, so the variants
        # are distinguished by whether the section byte-accounting works
        # out (a wrong count breaks tensor/buffer parsing)
        return _deserialize(buf, sparse_count_header=True)


def _deserialize(buf, sparse_count_header: bool) -> object:
    s = _Stream(buf)
    # 0.14: <tensors><ndarrays><buffers><pad32>; 0.15+: <tensors>
    # <sparse><ndarrays><buffers>. Both are 16 bytes to the first message
    # (AlignStream(8) pads the 12-byte header).
    ints = [s.i32() for _ in range(4)]
    if sparse_count_header:
        num_tensors, num_sparse, num_ndarrays, num_buffers = ints
        if num_sparse:
            raise ValueError("arrow014: sparse tensors unsupported")
    else:
        num_tensors, num_ndarrays, num_buffers = ints[:3]
    msg, _ = s.next_message()
    if msg is None or msg.u8(1) != _MSG_SCHEMA:
        raise ValueError("arrow014: expected Schema message")
    legacy = msg.i16(0, 0) < _V5
    fields = _parse_schema(msg)
    msg, body = s.next_message()
    if msg is None or msg.u8(1) != _MSG_RECORD_BATCH:
        raise ValueError("arrow014: expected RecordBatch message")
    arrays = _Arrays(msg.table(2), body, legacy)
    columns = {f.name: (arrays.read(f), f) for f in fields}

    ctx = {"tensors": [], "ndarrays": [], "buffers": []}
    # consume the stream's EOS marker (legacy: <i32 0>; V5: <-1><0>)
    # BEFORE aligning — when the batch body ends exactly 64-aligned the
    # EOS sits on the boundary and align() alone would misread it as
    # the first tensor message
    mark = s.pos
    if s.pos + 4 <= len(s.buf):
        v = s.i32()
        if v == -1 and s.pos + 4 <= len(s.buf):
            v = s.i32()
        if v != 0:
            s.pos = mark  # no EOS written (some writers stop early)
    s.align(64)
    for _ in range(num_tensors + num_ndarrays):
        msg, tbody = s.next_message()
        if msg is None or msg.u8(1) != _MSG_TENSOR:
            raise ValueError("arrow014: expected Tensor message")
        arr = _read_tensor(msg, tbody)
        target = "tensors" if len(ctx["tensors"]) < num_tensors else \
            "ndarrays"
        ctx[target].append(arr)
        s.align(64)
    for _ in range(num_buffers):
        n = s.i64()
        ctx["buffers"].append(bytes(s.read(n)))

    # top level: single List<union> column of one row wrapping the object
    (arr, field), = columns.values()
    if arr["kind"] != "list":
        raise ValueError("arrow014: top-level column is not a sequence")
    lf = _Field.__new__(_Field)
    lf.name, lf.tag, lf.params, lf.children = "list", _T_LIST, {}, []
    wrapper = _value(arr, 0, ctx, lf)
    if len(wrapper) != 1:
        raise ValueError(
            f"arrow014: expected a 1-element wrapper, got {len(wrapper)}")
    return wrapper[0]




# ==========================================================================
# writer: the 0.14 layout, with its flatbuffers built by `_Builder`
# ==========================================================================


class _Builder:
    """The part of the ``flatbuffers`` package's Python ``Builder`` that the
    writer uses, laid out byte for byte as that Builder lays it out. The
    buffer is filled from its end towards its start; every scalar is
    aligned to its size counted from the end; a table's vtable is written
    after (below) the table, or shared with an earlier equal one; a scalar
    slot that holds its default is left out."""

    def __init__(self, size: int = 1024):
        self.buf = bytearray(size)
        self.head = size
        self.minalign = 1
        self.vtable = None
        self.object_end = 0
        self.vtables = {}
        self.n_elems = 0

    def offset(self) -> int:
        """Bytes written so far, counted from the end of the buffer."""
        return len(self.buf) - self.head

    def _grow(self):
        old = len(self.buf)
        new = bytearray(2 * old)
        new[old:] = self.buf
        self.buf = new
        self.head += old

    def pad(self, n: int):
        self.buf[self.head - n:self.head] = bytes(n)
        self.head -= n

    def prep(self, size: int, additional: int):
        """Align so that a `size`-byte scalar can follow `additional` more
        bytes."""
        self.minalign = max(self.minalign, size)
        align = -(self.offset() + additional) & (size - 1)
        while self.head < align + size + additional:
            self._grow()
        self.pad(align)

    def place(self, fmt: str, x):
        self.head -= struct.calcsize(fmt)
        struct.pack_into("<" + fmt, self.buf, self.head, x)

    def prepend(self, fmt: str, x):
        self.prep(struct.calcsize(fmt), 0)
        self.place(fmt, x)

    def prepend_uoffset(self, off: int):
        """A uoffset to `off` (an earlier `offset()`), relative to where it
        is written."""
        self.prep(4, 0)
        self.place("I", self.offset() - off + 4)

    # ---- tables ---------------------------------------------------------

    def start_object(self, n_fields: int):
        self.vtable = [0] * n_fields
        self.object_end = self.offset()

    def slot(self, i: int):
        self.vtable[i] = self.offset()

    def add(self, i: int, fmt: str, x, default):
        """A scalar field; left out when it holds its default."""
        if x != default:
            self.prepend(fmt, x)
            self.slot(i)

    def add_uoffset(self, i: int, off: int):
        self.prepend_uoffset(off)
        self.slot(i)

    def end_object(self) -> int:
        self.prepend("i", 0)  # the soffset to the vtable, filled below
        obj = self.offset()
        fields = self.vtable
        while fields and not fields[-1]:  # trailing absent fields
            fields = fields[:-1]
        entries = [obj - f if f else 0 for f in fields]
        size = obj - self.object_end
        key = (tuple(entries), size)
        shared = self.vtables.get(key)
        if shared is None:
            for e in reversed(entries):
                self.prepend("H", e)
            self.prepend("H", size)
            self.prepend("H", 2 * (len(entries) + 2))
            struct.pack_into("<i", self.buf, len(self.buf) - obj,
                             self.offset() - obj)
            self.vtables[key] = self.offset()
        else:
            struct.pack_into("<i", self.buf, len(self.buf) - obj,
                             shared - obj)
        self.vtable = None
        return obj

    # ---- vectors and strings -------------------------------------------

    def start_vector(self, elem_size: int, n: int, alignment: int):
        self.n_elems = n
        self.prep(4, elem_size * n)
        self.prep(alignment, elem_size * n)

    def end_vector(self) -> int:
        self.place("I", self.n_elems)
        return self.offset()

    def create_string(self, s: str) -> int:
        x = s.encode("utf-8")
        self.prep(4, len(x) + 1)
        self.place("B", 0)
        self.head -= len(x)
        self.buf[self.head:self.head + len(x)] = x
        self.n_elems = len(x)
        return self.end_vector()

    def finish(self, root: int) -> bytes:
        self.prep(self.minalign, 4)
        self.prepend_uoffset(root)
        return bytes(self.buf[self.head:])


class _ChildWriter:
    """One union child: accumulates values, then renders (field-schema
    spec, node list, buffer list, sub-children) for the batch."""

    def __init__(self, name, kind):
        self.name, self.kind = name, kind
        self.values = []

    def append(self, v) -> int:
        self.values.append(v)
        return len(self.values) - 1


def _pad(blob: bytes, align: int = 8) -> bytes:
    return blob + b"\x00" * ((align - len(blob) % align) % align)


# Schema.fbs Type tags of the writer's type specs
_TYPE_TAGS = {"bool": _T_BOOL, "int": _T_INT, "float": _T_FLOAT,
              "utf8": _T_UTF8, "binary": _T_BINARY, "list": _T_LIST,
              "struct": _T_STRUCT}


class _BatchWriter:
    """Builds the one-column List<DenseUnion> record batch the 0.14
    serializer emits, with pre-1.0 buffer conventions (union validity
    buffer present, 8-byte buffer alignment)."""

    def __init__(self):
        self.ctx = {"ndarrays": [], "buffers": [], "tensors": []}

    # ---- value tree -> union writers ------------------------------------

    def build_sequence(self, items) -> dict:
        """A sequence of python values -> spec dict for one
        list<union> column level."""
        children: dict[str, _ChildWriter] = {}

        def child(name, kind):
            if name not in children:
                children[name] = _ChildWriter(name, kind)
            return children[name]

        type_of, offset_of = [], []
        for v in items:
            if isinstance(v, (bool, np.bool_)):
                c = child("bools", "bool")
            elif isinstance(v, (int, np.integer)):
                c = child("ints", "int64")
            elif isinstance(v, (float, np.floating)):
                c = child("doubles", "float64")
            elif isinstance(v, str):
                c = child("strings", "utf8")
            elif isinstance(v, bytes):
                c = child("bytes", "binary")
            elif isinstance(v, np.ndarray):
                c = child("ndarrays", "ref")
                self.ctx["ndarrays"].append(np.ascontiguousarray(v))
                v = len(self.ctx["ndarrays"]) - 1
            elif isinstance(v, tuple):
                c = child("tuples", "seq")
            elif isinstance(v, list):
                c = child("lists", "seq")
            elif isinstance(v, set):
                c = child("sets", "seq")
                v = sorted(v)  # deterministic bytes
            elif isinstance(v, dict):
                c = child("dicts", "dict")
            elif v is None:
                raise ValueError(
                    "arrow014 writer: None not supported (the reference "
                    "caches contain no None values; the READER handles "
                    "null entries via validity bitmaps)")
            else:
                raise ValueError(
                    f"arrow014 writer: unsupported type {type(v)}")
            idx = list(children).index(c.name)
            type_of.append(idx)
            offset_of.append(c.append(v))
        return {"children": children, "type_ids": type_of,
                "offsets": offset_of, "length": len(items)}

    # ---- union writers -> (schema fields, nodes, buffers) ---------------

    def render_union(self, spec) -> tuple[list, list, list]:
        """-> (child field specs, nodes, buffers) for the union ITSELF
        plus all children, pre-order."""
        fields, nodes, bufs = [], [], []
        nodes.append((spec["length"], 0))
        bufs.append(b"")  # pre-1.0 union validity placeholder
        bufs.append(np.asarray(spec["type_ids"], np.int8).tobytes())
        bufs.append(np.asarray(spec["offsets"], np.int32).tobytes())
        for name, c in spec["children"].items():
            f, n, b = self._render_child(name, c)
            fields.append(f)
            nodes.extend(n)
            bufs.extend(b)
        return fields, nodes, bufs

    def _render_child(self, name, c: _ChildWriter):
        n = len(c.values)
        if c.kind == "bool":
            data = np.packbits(np.asarray(c.values, np.uint8),
                               bitorder="little").tobytes()
            return ({"name": name, "type": ("bool",), "children": []},
                    [(n, 0)], [b"", data])
        if c.kind in ("int64", "float64", "ref"):
            type_spec, dtype = {"int64": (("int", 64, True), np.int64),
                                "float64": (("float", 2), np.float64),
                                "ref": (("int", 32, True), np.int32)}[c.kind]
            return ({"name": name, "type": type_spec, "children": []},
                    [(n, 0)], [b"", np.asarray(c.values, dtype).tobytes()])
        if c.kind in ("utf8", "binary"):
            blobs = [v.encode("utf-8") if c.kind == "utf8" else v
                     for v in c.values]
            offsets = np.zeros(n + 1, np.int32)
            np.cumsum([len(x) for x in blobs], out=offsets[1:])
            return ({"name": name, "type": (c.kind,), "children": []},
                    [(n, 0)],
                    [b"", offsets.tobytes(), b"".join(blobs)])
        if c.kind == "seq":
            offsets = np.zeros(n + 1, np.int32)
            np.cumsum([len(v) for v in c.values], out=offsets[1:])
            flat = [x for v in c.values for x in v]
            sub = self.build_sequence(flat)
            sub_fields, sub_nodes, sub_bufs = self.render_union(sub)
            return ({"name": name, "type": ("list",),
                     "children": [{"name": "item", "type": ("union",),
                                   "children": sub_fields}]},
                    [(n, 0)] + sub_nodes,
                    [b"", offsets.tobytes()] + sub_bufs)
        if c.kind == "dict":
            keys, vals = [], []
            koff = np.zeros(n + 1, np.int32)
            for i, d in enumerate(c.values):
                items = list(d.items())
                keys.extend(k for k, _ in items)
                vals.extend(v for _, v in items)
                koff[i + 1] = len(keys)
            out_nodes, out_bufs, kv_fields = [(n, 0)], [b""], []
            for part, flat in (("keys", keys), ("vals", vals)):
                sub = self.build_sequence(flat)
                sf, sn, sb = self.render_union(sub)
                kv_fields.append(
                    {"name": part, "type": ("list",),
                     "children": [{"name": "item", "type": ("union",),
                                   "children": sf}]})
                out_nodes.extend([(n, 0)] + sn)
                out_bufs.extend([b"", koff.tobytes()] + sb)
            return ({"name": name, "type": ("struct",),
                     "children": kv_fields}, out_nodes, out_bufs)
        raise AssertionError(c.kind)

    # ---- flatbuffer assembly ---------------------------------------------

    @staticmethod
    def _write_type(b: _Builder, type_spec):
        """-> (type_tag, type_table_offset)."""
        kind = type_spec[0]
        if kind == "int":
            b.start_object(2)
            b.add(0, "i", type_spec[1], 0)
            b.add(1, "B", int(type_spec[2]), 0)
        elif kind == "float":
            b.start_object(1)
            b.add(0, "h", type_spec[1], 0)
        else:  # the types without parameters
            b.start_object(0)
        return _TYPE_TAGS[kind], b.end_object()

    def _write_field(self, b: _Builder, spec):
        name_off = b.create_string(spec["name"])
        child_offs = [self._write_field(b, c) for c in spec["children"]]
        children_vec = None
        if child_offs:
            b.start_vector(4, len(child_offs), 4)
            for off in reversed(child_offs):
                b.prepend_uoffset(off)
            children_vec = b.end_vector()
        if spec["type"][0] == "union":
            # typeIds written explicitly as 0..n-1 (registration order)
            n = len(spec["children"])
            b.start_vector(4, n, 4)
            for i in reversed(range(n)):
                b.prepend("i", i)
            ids_vec = b.end_vector()
            b.start_object(2)
            b.add(0, "h", 1, 0)  # Dense
            b.add_uoffset(1, ids_vec)
            tag, type_off = _T_UNION, b.end_object()
        else:
            tag, type_off = self._write_type(b, spec["type"])
        b.start_object(7)
        b.add_uoffset(0, name_off)
        b.add(1, "B", 1, 0)  # nullable
        b.add(2, "B", tag, 0)
        b.add_uoffset(3, type_off)
        if children_vec is not None:
            b.add_uoffset(5, children_vec)
        return b.end_object()

    @staticmethod
    def _message(b: _Builder, header_tag, header_off, body_len) -> bytes:
        b.start_object(5)
        b.add(0, "h", 3, 0)  # MetadataVersion V4
        b.add(1, "B", header_tag, 0)
        b.add_uoffset(2, header_off)
        b.add(3, "q", body_len, 0)
        return b.finish(b.end_object())

    def schema_message(self, union_fields) -> bytes:
        b = _Builder()
        top = self._write_field(
            b, {"name": "list", "type": ("list",),
                "children": [{"name": "item", "type": ("union",),
                              "children": union_fields}]})
        b.start_vector(4, 1, 4)
        b.prepend_uoffset(top)
        fields_vec = b.end_vector()
        b.start_object(3)
        b.add(0, "h", 0, 0)  # little endian (the default, left out)
        b.add_uoffset(1, fields_vec)
        return self._message(b, _MSG_SCHEMA, b.end_object(), 0)

    @staticmethod
    def _struct_vector(b: _Builder, pairs) -> int:
        """A vector of 16-byte structs of two int64s."""
        b.start_vector(16, len(pairs), 8)
        for first, second in reversed(pairs):
            b.prep(8, 16)
            b.prepend("q", second)
            b.prepend("q", first)
        return b.end_vector()

    def batch_message(self, nodes, buffers) -> tuple[bytes, bytes]:
        body = bytearray()
        entries = []
        for raw in buffers:
            entries.append((len(body), len(raw)))
            body.extend(_pad(raw, 8))
        b = _Builder()
        buf_vec = self._struct_vector(b, entries)     # (offset, length)
        node_vec = self._struct_vector(b, nodes)      # (length, nulls)
        b.start_object(3)
        b.add(0, "q", 1, 0)  # batch length: the 1-row wrapper
        b.add_uoffset(1, node_vec)
        b.add_uoffset(2, buf_vec)
        return (self._message(b, _MSG_RECORD_BATCH, b.end_object(),
                              len(body)), bytes(body))

    def tensor_message(self, arr: np.ndarray) -> tuple[bytes, bytes]:
        body = _pad(arr.tobytes(), 8)
        b = _Builder()
        if arr.dtype == np.bool_:
            type_spec = ("int", 8, False)
        elif arr.dtype.kind in "iu":
            type_spec = ("int", arr.dtype.itemsize * 8,
                         arr.dtype.kind == "i")
        else:
            type_spec = ("float", {2: 0, 4: 1, 8: 2}[arr.dtype.itemsize])
        tag, type_off = self._write_type(b, type_spec)
        dim_offs = []
        for size in arr.shape:
            b.start_object(2)
            b.add(0, "q", size, 0)
            dim_offs.append(b.end_object())
        b.start_vector(4, len(dim_offs), 4)
        for off in reversed(dim_offs):
            b.prepend_uoffset(off)
        shape_vec = b.end_vector()
        b.start_vector(8, arr.ndim, 8)
        for stride in reversed(arr.strides):
            b.prepend("q", stride)
        stride_vec = b.end_vector()
        b.start_object(5)
        b.add(0, "B", tag, 0)
        b.add_uoffset(1, type_off)
        b.add_uoffset(2, shape_vec)
        b.add_uoffset(3, stride_vec)
        b.prep(8, 16)  # the Buffer struct (offset 0, length) inline
        b.prepend("q", arr.nbytes)
        b.prepend("q", 0)
        b.slot(4)
        return (self._message(b, _MSG_TENSOR, b.end_object(), len(body)),
                body)


def _frame_legacy(out: bytearray, metadata: bytes):
    """Legacy (pre-0.15) message framing: <i32 size><flatbuffer+pad> so
    the stream position ends 8-aligned (ipc/message.cc 0.14
    WriteMessage)."""
    start = len(out)
    padded = len(metadata) + 4
    rem = (padded + start) % 8
    if rem:
        padded += 8 - rem
    out.extend(struct.pack("<i", padded - 4))
    out.extend(metadata)
    out.extend(b"\x00" * (padded - 4 - len(metadata)))


def serialize(obj) -> bytes:
    """Assemble a pyarrow-0.14 ``serialize().to_buffer()`` byte stream
    for `obj`: the JAX package's writer's bytes. Layout notes in the
    module docstring."""
    w = _BatchWriter()
    # the serializer wraps the object in a 1-element sequence; the
    # column is a 1-row List<union> whose single list holds `obj`
    spec = w.build_sequence([obj])
    offsets = np.asarray([0, len(spec["type_ids"])], np.int32)
    union_fields, sub_nodes, sub_bufs = w.render_union(spec)
    nodes = [(1, 0)] + sub_nodes
    buffers = [b"", offsets.tobytes()] + sub_bufs

    out = bytearray()
    out.extend(struct.pack("<3i", len(w.ctx["tensors"]),
                           len(w.ctx["ndarrays"]),
                           len(w.ctx["buffers"])))
    out.extend(b"\x00" * ((8 - len(out) % 8) % 8))
    _frame_legacy(out, w.schema_message(union_fields))
    batch_meta, batch_body = w.batch_message(nodes, buffers)
    _frame_legacy(out, batch_meta)
    out.extend(batch_body)
    out.extend(struct.pack("<i", 0))  # stream EOS
    out.extend(b"\x00" * ((64 - len(out) % 64) % 64))
    for arr in w.ctx["ndarrays"]:
        meta, body = w.tensor_message(arr)
        _frame_legacy(out, meta)
        out.extend(body)
        out.extend(b"\x00" * ((64 - len(out) % 64) % 64))
    for blob in w.ctx["buffers"]:
        out.extend(struct.pack("<q", len(blob)))
        out.extend(blob)
    return bytes(out)
