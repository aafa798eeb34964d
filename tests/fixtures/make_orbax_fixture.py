"""A JAX-free writer of orbax checkpoints in the JAX package's layout, for
tests and `chip_smoke.py` (the port reads orbax checkpoints and writes
none).

`write_orbax(path, tree)` writes what `ocp.PyTreeCheckpointer().save(path,
tree)` writes for a tree of dicts, lists, None and numpy arrays, as far as
`PyTreeCheckpointer().restore` and the port's reader are concerned:

  _METADATA          tree_metadata (key paths, key_types 1 sequence / 2
                     dict, value types), use_ocdbt true, use_zarr3 false
  manifest.ocdbt     an OCDBT manifest: config (compression none), a data
                     file table, one version
  d/<hex>            the arrays' zarr v2 chunks as indirect values, then
                     the B+tree: leaves of at most LEAF_ENTRIES keys under
                     one interior root when there is more than one leaf

Every zarr chunk is one zstd frame of raw blocks (RFC 8878: no entropy
coding; each block at most 128 KiB) declaring its content size, without a
checksum; each array is one chunk, as orbax chunks a host array. The
OCDBT nodes are uncompressed and carry a CRC-32C computed here. It shares
no code with the reader (emotiongestures_torch/utils/{zstd,ocdbt,orbax}.py)
and imports only numpy.

`jax_state_tree(state, table, step, moments)` lays a reference-layout
state_dict out as a JAX TrainState tree (step, params, batch_stats and an
optax `adam` opt_state: [None, {count, mu, nu}, None]) through one of the
port's weight tables (torch_key, jax_path, kind).
"""
from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np

LEAF_ENTRIES = 64
BLOCK = 128 * 1024
MANIFEST_MAGIC, BTREE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zstd_raw_frame(data: bytes) -> bytes:
    """One zstd frame: single segment, 8-byte content size, raw blocks."""
    out = [struct.pack("<IB", 0xFD2FB528, 0xE0), struct.pack("<Q", len(data))]
    starts = list(range(0, len(data), BLOCK)) or [0]
    for i, s in enumerate(starts):
        chunk = data[s:s + BLOCK]
        last = int(i == len(starts) - 1)
        out.append((last | (len(chunk) << 3)).to_bytes(3, "little"))
        out.append(chunk)
    return b"".join(out)


def _ocdbt_file(magic: int, body: bytes) -> bytes:
    head = varint(0) + varint(0)  # version 0, uncompressed
    n = 4 + 8 + len(head) + len(body) + 4
    raw = struct.pack(">I", magic) + struct.pack("<Q", n) + head + body
    return raw + struct.pack("<I", crc32c(raw))


def _file_table(paths: list) -> bytes:
    out = varint(len(paths))
    enc = [p.encode() for p in paths]
    out += b"".join(varint(0) for _ in enc[1:])  # no shared prefixes
    out += b"".join(varint(len(p)) for p in enc)
    out += b"".join(varint(0) for _ in enc)  # no base path
    return out + b"".join(enc)


def _keys(keys: list) -> tuple:
    """Prefix-compressed key columns: (shared lengths, suffix lengths,
    suffix bytes)."""
    shared, suffix, data, prev = [], [], [], b""
    for i, k in enumerate(keys):
        n = 0
        if i:
            while n < min(len(k), len(prev)) and k[n] == prev[n]:
                n += 1
            shared.append(n)
        suffix.append(len(k) - n)
        data.append(k[n:])
        prev = k
    return (b"".join(map(varint, shared)), b"".join(map(varint, suffix)),
            b"".join(data))


def _leaf(entries: list, files: list) -> bytes:
    """entries: (key, offset, length) of indirect values in file 0."""
    shared, suffix, data = _keys([k for k, _, _ in entries])
    body = bytes([0]) + _file_table(files) + varint(len(entries))
    body += shared + suffix + data
    body += b"".join(varint(ln) for _, _, ln in entries)
    body += b"".join(varint(1) for _ in entries)  # indirect
    body += b"".join(varint(0) for _ in entries)  # data file 0
    body += b"".join(varint(off) for _, off, _ in entries)
    return _ocdbt_file(BTREE_MAGIC, body)


def _interior(children: list, files: list) -> bytes:
    """children: (first key, offset, length, n_keys, value bytes)."""
    shared, suffix, data = _keys([c[0] for c in children])
    body = bytes([1]) + _file_table(files) + varint(len(children))
    body += shared + suffix + b"".join(varint(0) for _ in children) + data
    for col in (lambda c: 0, lambda c: c[1], lambda c: c[2], lambda c: c[3],
                lambda c: c[2], lambda c: c[4]):
        body += b"".join(varint(col(c)) for c in children)
    return _ocdbt_file(BTREE_MAGIC, body)


def _leaves(tree, keys=()):
    """(key path of (key, key_type), value) of every leaf, in order."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _leaves(v, keys + ((str(k), 2),))
    elif isinstance(tree, (list, tuple)) and len(tree):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + ((str(i), 1),))
    else:
        yield keys, tree


def _zarray(a: np.ndarray) -> bytes:
    return json.dumps({
        "chunks": list(a.shape), "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": a.dtype.str,
        "fill_value": None, "filters": None, "order": "C",
        "shape": list(a.shape), "zarr_format": 2},
        separators=(",", ":")).encode()


def write_orbax(path, tree) -> Path:
    """Write `tree` as an orbax checkpoint directory at `path`."""
    path = Path(path)
    (path / "d").mkdir(parents=True, exist_ok=True)
    meta, values = {}, {}
    for keys, value in _leaves(tree):
        name = str(tuple(k for k, _ in keys))
        if value is None or isinstance(value, (dict, list, tuple)):
            vtype = "None" if value is None else (
                "Dict" if isinstance(value, dict) else "List")
            skip = True
        else:
            value = np.ascontiguousarray(value)
            vtype, skip = "np.ndarray", False
            zname = ".".join(k for k, _ in keys)
            chunk = ".".join("0" for _ in value.shape) or "0"
            values[f"{zname}/.zarray".encode()] = _zarray(value)
            values[f"{zname}/{chunk}".encode()] = zstd_raw_frame(
                value.tobytes())
        meta[name] = {"key_metadata": [{"key": k, "key_type": t}
                                       for k, t in keys],
                      "value_metadata": {"value_type": vtype,
                                         "skip_deserialize": skip}}
    data_name = f"d/{os.urandom(16).hex()}"
    files = [data_name]
    keys = sorted(values)
    offset, entries, blobs = 0, [], []
    for k in keys:
        blobs.append(values[k])
        entries.append((k, offset, len(values[k])))
        offset += len(values[k])
    nodes, children = [], []
    for s in range(0, len(entries), LEAF_ENTRIES):
        part = entries[s:s + LEAF_ENTRIES]
        node = _leaf(part, files)
        children.append((part[0][0], offset, len(node), len(part),
                         sum(ln for _, _, ln in part)))
        nodes.append(node)
        offset += len(node)
    if len(children) == 1:
        root, height = children[0], 0
    else:
        node = _interior(children, files)
        root = (b"", offset, len(node), len(entries),
                sum(c[4] for c in children))
        nodes.append(node)
        height = 1
    with open(path / data_name, "wb") as f:
        for blob in blobs + nodes:
            f.write(blob)
    config = os.urandom(16) + varint(0) + varint(1024) + varint(100000000)
    config += bytes([4]) + varint(0)  # arity 2^4, no compression
    version = varint(1) + varint(1) + bytes([height]) + varint(0)
    version += varint(root[1]) + varint(root[2]) + varint(root[3])
    version += varint(root[2]) + varint(root[4]) + struct.pack("<Q", 0)
    manifest = config + _file_table(files) + version + varint(0)
    (path / "manifest.ocdbt").write_bytes(
        _ocdbt_file(MANIFEST_MAGIC, manifest))
    (path / "_METADATA").write_text(json.dumps({
        "tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    return path


# torch layout -> JAX layout, the inverse of emotiongestures_torch/utils/
# weights.py's TO_TORCH for the kinds the generator and the CVAEs use
FROM_TORCH = {
    "raw": lambda x: x,
    "dense": lambda x: x.T,
    "conv2d": lambda x: np.transpose(x, (2, 3, 1, 0)),
    "conv1d": lambda x: np.transpose(x, (2, 1, 0)),
    "dense1x1": lambda x: x[:, :, 0].T,
    "g": lambda x: x.reshape(-1),
    "convT1d": lambda x: np.transpose(x, (2, 0, 1))[::-1],
}


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def jax_state_tree(state: dict, table: list, step: int,
                   moments=None) -> dict:
    """A JAX TrainState tree from a reference-layout `state` (name ->
    numpy array) through `table`; `moments(path, shape) -> (mu, nu)` fills
    Adam's moments (zeros when None), and `count` is `step`."""
    variables: dict = {"params": {}, "batch_stats": {}}
    mu: dict = {}
    nu: dict = {}
    for key, path, kind in table:
        value = np.ascontiguousarray(FROM_TORCH[kind](np.asarray(state[key])))
        _put(variables, path, value)
        if path[0] == "params":
            m, v = moments(path, value.shape) if moments else (
                np.zeros_like(value), np.zeros_like(value))
            _put(mu, path[1:], m)
            _put(nu, path[1:], v)
    return {"step": np.asarray(step, np.int64),
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": [None, {"count": np.asarray(step, np.int32),
                                 "mu": mu, "nu": nu}, None]}
