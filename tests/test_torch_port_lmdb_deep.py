"""LMDB B+trees of depth 3 and more: branch pages over branch pages, as a
full BEAT train cache has. tests/fixtures/make_lmdb_fixture.py writes at
most one branch level, so this file writes deeper trees itself (its page,
node and meta renderers, a branch layer over every layer of more than one
page) and holds the port's reader (emotiongestures_torch/data/
lmdb_reader.py) and the JAX package's to the same records, in key order,
and the same point lookups.
"""
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from emotiongestures_torch.data import lmdb_reader as PL
from emotiongestures_tpu.data import lmdb_reader as JL

sys.path.insert(0, str(Path(__file__).resolve().parent / "fixtures"))
import make_lmdb_fixture as F  # noqa: E402

sys.path.pop(0)


def write_deep_lmdb(path, items, leaf_keys=2, fanout=3, inline_max=512):
    """An LMDB env of `items` whose leaves hold at most `leaf_keys` records
    and whose branch pages hold at most `fanout` children; values above
    `inline_max` bytes on overflow runs. Page order: metas, leaves, the
    branch layers bottom-up, overflow runs. Returns (path, depth)."""
    items = sorted(items.items())
    leaves = [items[i:i + leaf_keys] for i in range(0, len(items), leaf_keys)]
    pages, next_pg = {}, 2
    level = []  # (first key, pgno) of each page of the current layer
    leaf_pg = {}
    for i, leaf in enumerate(leaves):
        leaf_pg[i] = next_pg
        level.append((leaf[0][0], next_pg))
        next_pg += 1
    depth, n_branch, layers = 1, 0, []
    while len(level) > 1:
        upper = []
        for i in range(0, len(level), fanout):
            group = level[i:i + fanout]
            layers.append((next_pg, group))
            upper.append((group[0][0], next_pg))
            next_pg += 1
            n_branch += 1
        level, depth = upper, depth + 1
    overflow = {}
    for i, leaf in enumerate(leaves):
        for key, value in leaf:
            if len(value) > inline_max:
                n = (F.PAGEHDRSZ + len(value) + F.PSIZE - 1) // F.PSIZE
                overflow[key] = (next_pg, n)
                next_pg += n
    for i, leaf in enumerate(leaves):
        nodes = []
        for key, value in leaf:
            if key in overflow:
                nodes.append(F._node(key, dsize=len(value),
                                     nflags=F.F_BIGDATA,
                                     payload=struct.pack(
                                         "<Q", overflow[key][0])))
            else:
                nodes.append(F._node(key, dsize=len(value), nflags=0,
                                     payload=value))
        pages[leaf_pg[i]] = F._render_page(leaf_pg[i], F.P_LEAF, nodes)
    for pgno, group in layers:
        nodes = [F._branch_node(b"" if j == 0 else key, child)
                 for j, (key, child) in enumerate(group)]
        pages[pgno] = F._render_page(pgno, F.P_BRANCH, nodes)
    values = dict(items)
    for key, (pgno, n) in overflow.items():
        hdr = struct.pack("<QHHI", pgno, 0, F.P_OVERFLOW, n)
        pages[pgno] = (hdr + values[key]).ljust(n * F.PSIZE, b"\x00")
    last_pg = next_pg - 1
    main = {"depth": depth, "branch": n_branch, "leaf": len(leaves),
            "overflow": sum(n for _, n in overflow.values()),
            "entries": len(items), "root": level[0][1]}
    empty = {"depth": 0, "branch": 0, "leaf": 0, "overflow": 0,
             "entries": 0, "root": F.P_INVALID}
    out = bytearray(F._meta(0, 0, F.PSIZE, empty, 1))
    out += F._meta(1, 1, F.PSIZE, main, last_pg)
    pos = 2
    while pos <= last_pg:
        out += pages[pos]
        pos += len(pages[pos]) // F.PSIZE
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "data.mdb").write_bytes(bytes(out))
    return path, depth


@pytest.mark.parametrize("n,leaf_keys,fanout,depth", [
    (18, 2, 3, 3),     # 9 leaves -> 3 branches -> the root
    (200, 3, 4, 5),    # 67 leaves -> 17 -> 5 -> 2 -> the root
    (41, 1, 2, 7),     # one record per leaf, binary branch pages
], ids=["depth3", "depth5", "depth7"])
def test_deep_trees_read_the_same_records_in_both_readers(
        tmp_path, n, leaf_keys, fanout, depth):
    rng = np.random.RandomState(n)
    items = {f"{i:010d}".encode(): bytes(rng.bytes(rng.randint(1, 400)))
             for i in range(n)}
    for i in range(0, n, 7):  # some values on overflow runs
        items[f"{i:010d}".encode()] = bytes(rng.bytes(3000 + 500 * i))
    path, got_depth = write_deep_lmdb(tmp_path / "env", items, leaf_keys,
                                      fanout)
    assert got_depth == depth
    want = sorted(items.items())
    assert list(PL.iter_entries(path)) == list(JL.iter_entries(path)) == want
    with PL.LmdbEnv(path) as p, JL.LmdbEnv(path) as j:
        assert (len(p), p.depth, p.root) == (len(j), j.depth, j.root) == \
            (n, depth, j.root)
        for key, value in want:
            assert p.get(key) == j.get(key) == value
        assert p.get(b"9999999999") is None and j.get(b"9999999999") is None
        assert p.get(b"0") is None and j.get(b"0") is None

