"""A read-only OCDBT key-value store: the on-disk database that orbax writes
through tensorstore (`use_ocdbt: true`, the default of the JAX package's
`save_checkpoint`), read with numpy and the port's own zstd decoder.

Files. `manifest.ocdbt` at the store's root, and nodes inside data files
(`d/<hex>`, or `ocdbt.process_<i>/d/<hex>` where orbax merged per-process
databases). Every manifest and node is

    magic u32 (big-endian) | length u64 | version varint (0) |
    compression varint (0 none, 1 zstd) | body (compressed as said) |
    CRC-32C u32 of all the bytes before it

with the magics 0x0cdb3a2a (manifest), 0x0cdb1234 (version tree node) and
0x0cdb20de (B+tree node); the CRC is checked on every read. Integers are
little-endian, varints LEB128, and lists are stored as columns.

Manifest body: the config (uuid[16], manifest_kind, max_inline_value_bytes,
max_decoded_node_bytes, version_tree_arity_log2 u8, compression method,
and for zstd its level as an int32), a data-file table, the newest versions
(a version-tree leaf, inline) and references to the older version-tree
nodes. A data-file table is a count, the shared-prefix lengths of paths 2..n,
the suffix lengths, the base-path lengths, then the suffix bytes; a path is
the base path followed by a path relative to it, both under the root.

A version is (generation, root height u8, root location, key count, tree
bytes, indirect value bytes, commit time u64); a location is (data file
index, offset, length) into the node's table. The root read is the newest
version's. A B+tree node is its height u8, a data-file table and its
entries: keys as shared-prefix lengths, suffix lengths and suffix bytes;
an interior entry also carries how many bytes of its key its whole subtree
shares (the child's keys are stored without them) and its child's location
and statistics; a leaf entry carries a value length and kind (0 inline, 1 a
location in a data file), then the indirect values' locations, then the
inline values' bytes.

Only the `single` manifest kind is read; anything else raises with the
field's name. This layout was read from the bytes tensorstore 0.1.80 writes
(through orbax 0.11.32), with tensorstore's own list and read as the oracle
(tests/test_torch_port_orbax.py).
"""
from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from pathlib import Path

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
_MAGIC_NAMES = {MANIFEST_MAGIC: "manifest", VERSION_NODE_MAGIC:
                "version tree node", BTREE_NODE_MAGIC: "B+tree node"}


class OcdbtError(ValueError):
    """An OCDBT store this reader cannot read: a bad checksum, a truncated
    or malformed file, or a feature it does not know."""


class _Body:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OcdbtError(f"truncated {self.what}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtError(f"truncated varint in {self.what}")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"varint too long in {self.what}")

    def column(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{len(self.data) - self.pos} stray bytes after "
                             f"the {self.what}")


def decode_file(raw: bytes, magic: int, max_decoded: int | None = None
                ) -> bytes:
    """The body of one manifest or node, its header and CRC-32C checked."""
    what = _MAGIC_NAMES[magic]
    if len(raw) < 18:
        raise OcdbtError(f"truncated {what}: {len(raw)} bytes")
    got_magic, length = struct.unpack(">I", raw[:4])[0], \
        struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"bad magic 0x{got_magic:08x} for a {what}")
    if length != len(raw):
        raise OcdbtError(f"{what} says it is {length} bytes, found "
                         f"{len(raw)}")
    crc = struct.unpack("<I", raw[-4:])[0]
    if zstd.crc32c(raw[:-4]) != crc:
        raise OcdbtError(f"CRC-32C mismatch in a {what}")
    head = _Body(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"unknown {what} version {version}")
    compression = head.varint()
    payload = raw[12 + head.pos:-4]
    if compression == 0:
        return payload
    if compression == 1:
        try:
            return zstd.decompress(payload, max_output=max_decoded)
        except ValueError as exc:
            raise OcdbtError(f"{what}: {exc}") from exc
    raise OcdbtError(f"unknown compression format {compression} in a {what}")


def _data_file_table(b: _Body) -> list:
    n = b.varint()
    shared = [0] + b.column(n - 1) if n else []
    suffix = b.column(n)
    base = b.column(n)
    paths, prev = [], b""
    for k in range(n):
        if shared[k] > len(prev):
            raise OcdbtError(f"bad path prefix length in the {b.what}")
        full = prev[:shared[k]] + b.take(suffix[k])
        if base[k] > len(full):
            raise OcdbtError(f"bad base path length in the {b.what}")
        paths.append(full.decode())
        prev = full
    return paths


@dataclass(frozen=True)
class Location:
    file: str       # path under the store's root
    offset: int
    length: int


def _locations(b: _Body, files: list, n: int) -> list:
    ids, offsets, lengths = b.column(n), b.column(n), b.column(n)
    out = []
    for i, off, ln in zip(ids, offsets, lengths):
        if i >= len(files):
            raise OcdbtError(f"data file index {i} out of range in the "
                             f"{b.what}")
        out.append(Location(files[i], off, ln))
    return out


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Location
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


def _versions(b: _Body, files: list) -> list:
    n = b.varint()
    gens = b.column(n)
    heights = [b.u8() for _ in range(n)]
    roots = _locations(b, files, n)
    keys, tree, indirect = b.column(n), b.column(n), b.column(n)
    times = [b.u64() for _ in range(n)]
    return [Version(*v) for v in zip(gens, heights, roots, keys, tree,
                                     indirect, times)]


def _version_refs(b: _Body, files: list, with_height: bool,
                  height: int = 0) -> list:
    """References to version-tree nodes: (generation, location, height)."""
    n = b.varint()
    gens = b.column(n)
    locs = _locations(b, files, n)
    b.column(n)  # num_generations
    [b.u64() for _ in range(n)]  # commit times
    heights = [b.u8() for _ in range(n)] if with_height else [height] * n
    return list(zip(gens, locs, heights))


@dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: str
    zstd_level: int | None


class OcdbtStore:
    """The newest version of the OCDBT database at `root`, read-only.

    `keys()` lists its keys in order, `read(key)` returns a value's bytes
    (None for a missing key), `versions()` walks the version tree."""

    def __init__(self, root):
        self.root = Path(root)
        self._maps: dict = {}
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise OcdbtError(f"{self.root} has no manifest.ocdbt")
        body = _Body(decode_file(path.read_bytes(), MANIFEST_MAGIC),
                     "manifest")
        self.config = self._config(body)
        files = _data_file_table(body)
        self._inline_versions = _versions(body, files)
        self._version_nodes = _version_refs(body, files, True)
        body.done()
        if not self._inline_versions and not self._version_nodes:
            raise OcdbtError("the manifest holds no version")
        self.version = max(self.versions(), key=lambda v: v.generation)
        self._values: dict = {}
        if self.version.num_keys and self.version.root.length:
            self._walk(self.version.root, self.version.root_height, b"")
        self._keys = sorted(self._values)

    @staticmethod
    def _config(b: _Body) -> Config:
        uuid = b.take(16)
        kind = b.varint()
        if kind != 0:
            raise OcdbtError(f"unknown manifest_kind {kind}: only the "
                             "single-file manifest (0) is read")
        inline, node_bytes = b.varint(), b.varint()
        arity = b.u8()
        method = b.varint()
        if method == 0:
            return Config(uuid, kind, inline, node_bytes, arity, "none", None)
        if method == 1:
            return Config(uuid, kind, inline, node_bytes, arity, "zstd",
                          b.i32())
        raise OcdbtError(f"unknown compression method {method} in the "
                         "manifest's config")

    def _bytes(self, loc: Location) -> bytes:
        mm = self._maps.get(loc.file)
        if mm is None:
            path = (self.root / loc.file).resolve()
            if not path.is_relative_to(self.root.resolve()):
                raise OcdbtError(f"data file {loc.file} lies outside the "
                                 "store")
            if not path.is_file():
                raise OcdbtError(f"missing data file {loc.file}")
            with open(path, "rb") as f:
                size = path.stat().st_size
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) \
                    if size else b""
            self._maps[loc.file] = mm
        if loc.offset + loc.length > len(mm):
            raise OcdbtError(f"location {loc.offset}+{loc.length} past the "
                             f"end of {loc.file} ({len(mm)} bytes)")
        return mm[loc.offset:loc.offset + loc.length]

    def _node(self, loc: Location, magic: int) -> bytes:
        return decode_file(self._bytes(loc), magic,
                           self.config.max_decoded_node_bytes)

    def versions(self) -> list:
        """Every version the version tree holds, oldest first."""
        out = list(self._inline_versions)
        stack = list(self._version_nodes)
        while stack:
            _, loc, height = stack.pop()
            b = _Body(self._node(loc, VERSION_NODE_MAGIC),
                      "version tree node")
            arity = b.u8()
            if arity != self.config.version_tree_arity_log2:
                raise OcdbtError(f"version tree node of arity_log2 {arity} "
                                 "in a store of "
                                 f"{self.config.version_tree_arity_log2}")
            got = b.u8()
            if got != height:
                raise OcdbtError(f"version tree node of height {got} where "
                                 f"{height} was referenced")
            files = _data_file_table(b)
            if height == 0:
                out += _versions(b, files)
            else:
                stack += _version_refs(b, files, False, height - 1)
            b.done()
        return sorted(out, key=lambda v: v.generation)

    def _walk(self, loc: Location, height: int, prefix: bytes) -> None:
        b = _Body(self._node(loc, BTREE_NODE_MAGIC), "B+tree node")
        got = b.u8()
        if got != height:
            raise OcdbtError(f"B+tree node of height {got} where {height} "
                             "was referenced")
        files = _data_file_table(b)
        n = b.varint()
        shared = [0] + b.column(n - 1) if n else []
        suffix = b.column(n)
        subtree = b.column(n) if height else None
        keys, prev = [], b""
        for k in range(n):
            if shared[k] > len(prev):
                raise OcdbtError("bad key prefix length in a B+tree node")
            prev = prev[:shared[k]] + b.take(suffix[k])
            keys.append(prev)
        if height:
            children = _locations(b, files, n)
            for _ in range(3):  # num_keys, tree bytes, indirect value bytes
                b.column(n)
            b.done()
            for key, common, child in zip(keys, subtree, children):
                if common > len(key):
                    raise OcdbtError("bad subtree prefix length in a B+tree "
                                     "node")
                self._walk(child, height - 1, prefix + key[:common])
            return
        lengths = b.column(n)
        kinds = b.column(n)
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"unknown value kind {max(kinds)} in a B+tree "
                             "leaf")
        n_indirect = kinds.count(1)
        ids, offsets = b.column(n_indirect), b.column(n_indirect)
        if any(i >= len(files) for i in ids):
            raise OcdbtError("data file index out of range in a B+tree leaf")
        indirect = [(files[i], off) for i, off in zip(ids, offsets)]
        it = iter(indirect)
        for key, ln, kind in zip(keys, lengths, kinds):
            if kind == 0:
                self._values[prefix + key] = b.take(ln)
            else:
                file, offset = next(it)
                self._values[prefix + key] = Location(file, offset, ln)
        b.done()

    def keys(self) -> list:
        """The keys, in byte order."""
        return list(self._keys)

    def __contains__(self, key) -> bool:
        return _as_bytes(key) in self._values

    def __len__(self) -> int:
        return len(self._keys)

    def read(self, key) -> bytes | None:
        """The value of `key`, or None when the store does not hold it."""
        value = self._values.get(_as_bytes(key))
        if isinstance(value, Location):
            return self._bytes(value)
        return value

    def close(self) -> None:
        for mm in self._maps.values():
            if isinstance(mm, mmap.mmap):
                mm.close()
        self._maps.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _as_bytes(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)
