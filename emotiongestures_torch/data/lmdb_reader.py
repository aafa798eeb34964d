"""Pure-Python read-only LMDB parser, a copy of
emotiongestures_tpu/data/lmdb_reader.py: it lets `convert_data cache/clips`
open the reference's LMDB environments (lmdb_loader_BEAT_full.py:154,
data_preprocessor.py:44) with NO `lmdb` package installed, next to the
pyarrow-0.14 payload reader (data/arrow014.py).

Parses the LMDB 0.9.x on-disk format (mdb.c / lmdb.h):

  page       16-byte header: pgno u64 | pad u16 | flags u16 | lower u16
             | upper u16 (the last u32 is `pages` for overflow pages)
  meta       pages 0 and 1; the live one has valid magic 0xBEEFC0DE and
             the larger txnid; carries psize (dbs[0].md_pad) and the
             main DB (dbs[1]): depth, entries, root pgno
  node       u16 lo | u16 hi | u16 flags | u16 ksize | key bytes...
             branch: child pgno = lo | hi<<16 | flags<<32
             leaf:   value size = lo | hi<<16; F_BIGDATA (0x01) means
             the value bytes live on `ceil(size/psize)` contiguous
             OVERFLOW pages (data starts after the FIRST page's header)
  traversal  mp_ptrs (u16 offsets from page start) in key order;
             depth-first branch descent yields keys sorted

Scope: plain get/put environments like the reference's (no DUPSORT, no
named sub-databases, no LEAF2/fixed-size pages): anything else raises.
Writes are out of scope. tests/test_torch_port_migration.py holds it to
the JAX package's reader on environments written by
tests/fixtures/make_lmdb_fixture.py (the same spec, independent code).
"""
from __future__ import annotations

import mmap
import struct
from pathlib import Path

_MAGIC = 0xBEEFC0DE
_P_INVALID = 0xFFFFFFFFFFFFFFFF
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2, P_SUBP = 0x20, 0x40
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
_PAGEHDRSZ = 16


class LmdbEnv:
    """Read-only view over one LMDB environment (directory containing
    data.mdb, or the data file itself)."""

    def __init__(self, path):
        p = Path(path)
        self.path = p / "data.mdb" if p.is_dir() else p
        if not self.path.exists():
            raise FileNotFoundError(f"no LMDB data file at {self.path}")
        self._file = open(self.path, "rb")
        self._map = mmap.mmap(self._file.fileno(), 0,
                              access=mmap.ACCESS_READ)
        self.buf = memoryview(self._map)
        meta = self._pick_meta()
        self.psize = meta["psize"]
        self.entries = meta["entries"]
        self.root = meta["root"]
        self.depth = meta["depth"]

    # -- meta ---------------------------------------------------------------

    def _read_meta(self, pgno: int, psize_guess: int = 4096) -> dict | None:
        base = pgno * psize_guess + _PAGEHDRSZ
        if base + 32 + 2 * 48 + 16 > len(self.buf):
            return None
        magic, version = struct.unpack_from("<II", self.buf, base)
        if magic != _MAGIC:
            return None
        # MDB_meta: magic, version, address ptr, mapsize, dbs[2], last_pg,
        # txnid — MDB_db: pad u32, flags u16, depth u16, branch u64,
        # leaf u64, overflow u64, entries u64, root u64 (48 bytes)
        off = base + 8 + 8 + 8  # skip magic+version, address, mapsize
        free_db = struct.unpack_from("<IHH5Q", self.buf, off)
        main_db = struct.unpack_from("<IHH5Q", self.buf, off + 48)
        last_pg, txnid = struct.unpack_from("<QQ", self.buf, off + 96)
        if main_db[1] & 0x04:  # MDB_DUPSORT on the main DB
            raise ValueError("lmdb_reader: DUPSORT databases unsupported")
        return {
            "psize": free_db[0] or psize_guess,
            "depth": main_db[2],
            "entries": main_db[6],
            "root": main_db[7],
            "txnid": txnid,
        }

    def _pick_meta(self) -> dict:
        m0 = self._read_meta(0)
        # page size needed to locate meta page 1; trust meta 0's, fall
        # back to the default, then to a rescan over common sizes
        candidates = []
        for ps in ([m0["psize"]] if m0 else []) + [4096, 8192, 16384,
                                                   32768, 65536]:
            base1 = ps + _PAGEHDRSZ
            if base1 + 4 <= len(self.buf) and struct.unpack_from(
                    "<I", self.buf, base1)[0] == _MAGIC:
                m1 = self._read_meta(1, ps)
                if m1 is not None:
                    candidates.append(m1)
                    break
        if m0 is not None:
            candidates.append(m0)
        if not candidates:
            raise ValueError(
                f"{self.path}: no valid LMDB meta page (magic mismatch)")
        return max(candidates, key=lambda m: m["txnid"])

    # -- pages --------------------------------------------------------------

    def _page(self, pgno: int):
        off = pgno * self.psize
        if off + _PAGEHDRSZ > len(self.buf):
            raise ValueError(f"lmdb_reader: page {pgno} out of file")
        flags, lower, upper = struct.unpack_from("<HHH", self.buf,
                                                 off + 10)
        return off, flags, lower, upper

    def _numkeys(self, lower: int) -> int:
        return (lower - _PAGEHDRSZ) >> 1

    def _node(self, page_off: int, ptr_index: int):
        (noff,) = struct.unpack_from(
            "<H", self.buf, page_off + _PAGEHDRSZ + 2 * ptr_index)
        base = page_off + noff
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self.buf, base)
        key = bytes(self.buf[base + 8:base + 8 + ksize])
        return lo, hi, flags, key, base + 8 + ksize

    def _leaf_value(self, lo, hi, flags, data_off) -> bytes:
        size = lo | (hi << 16)
        if flags & (F_SUBDATA | F_DUPDATA):
            raise ValueError("lmdb_reader: DUPSORT/sub-DB data "
                             "unsupported")
        if flags & F_BIGDATA:
            (ov_pgno,) = struct.unpack_from("<Q", self.buf, data_off)
            ov_off, ov_flags, _, _ = self._page(ov_pgno)
            if not ov_flags & P_OVERFLOW:
                raise ValueError(
                    f"lmdb_reader: page {ov_pgno} is not an overflow "
                    "page")
            start = ov_off + _PAGEHDRSZ
            return bytes(self.buf[start:start + size])
        return bytes(self.buf[data_off:data_off + size])

    def _walk(self, pgno: int):
        page_off, flags, lower, upper = self._page(pgno)
        if flags & P_LEAF2:
            raise ValueError("lmdb_reader: LEAF2 pages unsupported")
        n = self._numkeys(lower)
        if flags & P_BRANCH:
            for i in range(n):
                lo, hi, nflags, _key, _ = self._node(page_off, i)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        elif flags & P_LEAF:
            for i in range(n):
                lo, hi, nflags, key, data_off = self._node(page_off, i)
                yield key, self._leaf_value(lo, hi, nflags, data_off)
        else:
            raise ValueError(
                f"lmdb_reader: unexpected page flags 0x{flags:x} at "
                f"page {pgno}")

    # -- public -------------------------------------------------------------

    def __len__(self):
        return self.entries

    def items(self):
        """All (key, value) pairs in key order."""
        if self.root == _P_INVALID:
            return
        yield from self._walk(self.root)

    def get(self, key: bytes) -> bytes | None:
        """Point lookup by binary descent (memcmp key order)."""
        if self.root == _P_INVALID:
            return None
        pgno = self.root
        while True:
            page_off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_LEAF:
                for i in range(n):
                    lo, hi, nflags, k, data_off = self._node(page_off, i)
                    if k == key:
                        return self._leaf_value(lo, hi, nflags, data_off)
                return None
            # branch: last child whose key <= target (child 0's key is
            # conventionally empty)
            child = None
            for i in range(n):
                lo, hi, nflags, k, _ = self._node(page_off, i)
                if i == 0 or k <= key:
                    child = lo | (hi << 16) | (nflags << 32)
                else:
                    break
            pgno = child

    def close(self):
        self.buf.release()
        self._map.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_entries(path):
    """Convenience: yield (key, value) from an LMDB env path."""
    with LmdbEnv(path) as env:
        yield from env.items()
