"""Reading the JAX package's orbax checkpoints without jax, orbax or
tensorstore: the `checkpoint_iteration<N>` directories that
emotiongestures_tpu/utils/checkpoint.py writes with
`ocp.PyTreeCheckpointer().save`, and that every JAX trainer's `--resume`,
the JAX eval CLI and the JAX demo restore.

A directory holds `_METADATA` (JSON: `tree_metadata`, one entry per leaf
with its key path and `key_type`s, 1 a sequence index and 2 a dict key,
and `use_ocdbt` / `use_zarr3`) and the arrays as zarr v2: under
`use_ocdbt: true` the keys `<name>/.zarray` and `<name>/<chunk>` of an OCDBT
store at the directory's root (utils/ocdbt.py), else one directory per
array. `<name>` is the leaf's key path joined with ".". `restore(path)`
rebuilds the pytree as `ocp.PyTreeCheckpointer().restore(path)` returns
it: nested dicts and lists of numpy arrays, None where optax keeps an empty
state, python scalars for scalars.

Read of zarr v2: dtype, shape, chunks in C order with the "." separator, a
compressor of "zstd" (the port's decoder, utils/zstd.py) or none, the
fill value for a chunk the store lacks, and 0-d arrays (chunk key "0").
Anything else raises with the field's name: zarr3, filters, another
compressor, Fortran order, an unknown value type.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from . import zstd
from .ocdbt import OcdbtStore

_ITERATION = re.compile(r"checkpoint_iteration(\d+)")

_VALUE_TYPES_READ = ("np.ndarray", "jax.Array", "scalar")
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


class OrbaxFormatError(ValueError):
    """A checkpoint this reader does not read, with the field at fault."""


def latest_step(directory) -> int | None:
    """The newest N of the `checkpoint_iteration<N>` directories in
    `directory` (the JAX package's fullmatch regex), or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    steps = [int(m.group(1)) for p in directory.iterdir()
             if p.is_dir() and (m := _ITERATION.fullmatch(p.name))]
    return max(steps) if steps else None


def is_orbax_checkpoint(path) -> bool:
    """Whether `path` is one orbax checkpoint (a directory with _METADATA)."""
    return (Path(path) / "_METADATA").is_file()


def find_checkpoint(path, step: int | None = None) -> Path | None:
    """`path` itself when it is an orbax checkpoint, else its
    `checkpoint_iteration<step>` (the newest when `step` is None), or None
    when it holds none."""
    path = Path(path)
    if step is None and is_orbax_checkpoint(path):
        return path
    if step is None:
        step = latest_step(path)
        if step is None:
            return None
    cand = path / f"checkpoint_iteration{step}"
    return cand if is_orbax_checkpoint(cand) else None


def _dtype(spec) -> np.dtype:
    if spec == "bfloat16":
        try:
            import ml_dtypes
        except ImportError as exc:
            raise OrbaxFormatError(
                "dtype 'bfloat16' needs the ml_dtypes package to be held in "
                "numpy") from exc
        return np.dtype(ml_dtypes.bfloat16)
    if not isinstance(spec, str):
        raise OrbaxFormatError(f"dtype {spec!r}: structured dtypes are not "
                               "read")
    dt = np.dtype(spec)
    if dt.kind not in "biuf" or dt.byteorder == ">":
        raise OrbaxFormatError(f"dtype {spec!r} is not read")
    return dt


def _fill(spec, dtype):
    if spec is None:
        return 0
    if isinstance(spec, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}.get(spec, None) if dtype.kind == "f" \
            else None
    return spec


def read_zarr(get, name: str) -> np.ndarray:
    """The zarr v2 array `name`, through `get(key) -> bytes | None`."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"array {name!r}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"array {name!r}: zarr_format "
                               f"{meta.get('zarr_format')!r}")
    if meta.get("filters"):
        raise OrbaxFormatError(f"array {name!r}: filters {meta['filters']!r}"
                               " are not read")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"array {name!r}: order {meta['order']!r} is "
                               "not read")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxFormatError(f"array {name!r}: dimension_separator "
                               f"{sep!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"array {name!r}: compressor "
                               f"{comp.get('id')!r} is not read")
    dtype = _dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"array {name!r}: chunks {list(chunks)} for "
                               f"shape {list(shape)}")
    fill = _fill(meta.get("fill_value"), dtype)
    if fill is None:
        raise OrbaxFormatError(f"array {name!r}: fill_value "
                               f"{meta.get('fill_value')!r}")
    out = np.full(shape, fill, dtype) if fill else np.zeros(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*[len(g) for g in grid]) if shape else [()]:
        key = sep.join(str(i) for i in idx) if idx else "0"
        data = get(f"{name}/{key}")
        if data is None:
            continue  # a missing chunk holds the fill value
        whole = chunks == shape  # one chunk: decode in place
        buf = out.reshape(-1).view(np.uint8) if whole else \
            np.empty(chunk_bytes, np.uint8)
        if comp is None:
            if len(data) != chunk_bytes:
                raise OrbaxFormatError(f"array {name!r}: chunk {key} holds "
                                       f"{len(data)} bytes, not "
                                       f"{chunk_bytes}")
            buf[:] = np.frombuffer(data, np.uint8)
        else:
            try:
                n = zstd.decompress_into(data, buf)
            except ValueError as exc:
                raise OrbaxFormatError(f"array {name!r}: chunk {key}: {exc}"
                                       ) from exc
            if n != chunk_bytes:
                raise OrbaxFormatError(f"array {name!r}: chunk {key} decodes "
                                       f"to {n} bytes, not {chunk_bytes}")
        if whole:
            continue
        block = buf.view(dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def read_metadata(path) -> dict:
    meta = json.loads((Path(path) / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise OrbaxFormatError("use_zarr3: zarr v3 arrays are not read")
    if "tree_metadata" not in meta:
        raise OrbaxFormatError("_METADATA has no tree_metadata")
    return meta


class _Seq(dict):
    """A sequence node while the tree is built: index -> child."""


def _place(root, keys, value, where):
    """Put `value` at `keys` ((key, key_type) pairs) under `root`."""
    node = root
    for depth, (key, kind) in enumerate(keys):
        if kind not in (1, 2):
            raise OrbaxFormatError(f"{where}: key_type {kind!r} is not read")
        if (kind == 1) != isinstance(node, _Seq):
            raise OrbaxFormatError(f"{where}: sequence and dict keys mixed "
                                   "in one node")
        key = int(key) if kind == 1 else key
        if depth == len(keys) - 1:
            node[key] = value
            return
        if key not in node:
            node[key] = _Seq() if keys[depth + 1][1] == 1 else {}
        node = node[key]


def _finish(node):
    if isinstance(node, _Seq):
        idx = sorted(node)
        if idx != list(range(len(idx))):
            raise OrbaxFormatError(f"sequence indices {idx} are not 0..n-1")
        return [_finish(node[i]) for i in idx]
    if isinstance(node, dict):  # keys sorted, as jax flattens a dict
        return {k: _finish(node[k]) for k in sorted(node)}
    return node


def restore(path, only=None) -> dict:
    """The pytree of the orbax checkpoint at `path`, as
    `ocp.PyTreeCheckpointer().restore(path)` returns it; with `only` (top
    level keys), just those subtrees (a model's params and batch_stats
    without its optimizer state)."""
    path = Path(path)
    meta = read_metadata(path)
    store = None
    if meta.get("use_ocdbt", False):
        store = OcdbtStore(path)
        get = store.read
    else:
        def get(key):
            p = path / key
            return p.read_bytes() if p.is_file() else None
    tree = meta["tree_metadata"]
    first = next(iter(tree.values()), None)
    root = _Seq() if first and first["key_metadata"][0]["key_type"] == 1 \
        else {}
    try:
        for where, entry in tree.items():
            keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
            if only is not None and keys[0][0] not in only:
                continue
            vtype = entry["value_metadata"]["value_type"]
            if vtype in _EMPTY:
                value = _EMPTY[vtype]()
            elif vtype in _VALUE_TYPES_READ:
                value = read_zarr(get, ".".join(str(k) for k, _ in keys))
                if vtype == "scalar":
                    value = value.item()
            else:
                raise OrbaxFormatError(f"{where}: value_type {vtype!r} is "
                                       "not read")
            _place(root, keys, value, where)
        return _finish(root)
    finally:
        if store is not None:
            store.close()


def restore_checkpoint(directory, step: int | None = None
                       ) -> tuple[dict, Path]:
    """The tree of `directory`'s `checkpoint_iteration<step>` (the newest
    when None; `directory` may itself be one), and the path read."""
    path = find_checkpoint(directory, step)
    if path is None:
        raise FileNotFoundError(f"no orbax checkpoint_iteration<N> in "
                                f"{directory}")
    return restore(path), path
