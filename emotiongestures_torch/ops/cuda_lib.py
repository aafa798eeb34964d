"""Build and load the hand-written CUDA kernels of `emotiongestures_torch/csrc`.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`. The build happens
at first use, into `emotiongestures_torch/_build/` (git-ignored), under a
file name that carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. `build_all()`
starts one `nvcc` per source, all at once. `build_variants()` builds edited
copies of a source the same way, for tools that time or check a kernel with
parts of it changed, and `using()` routes a wrapper to one of them.

Nothing here runs when a module is imported: the CPU tests import every
module of the package on machines that have no `nvcc`.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("attention", "mel", "se_stage")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of each exported function, per source; pointers and the stream
# as c_void_p
SIGNATURES = {
    "attention": [("eg_attention", [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])],
    "mel": [("eg_mel", [_P, _LL, _I, _I, _I] + [_P] * 7)],
    "se_stage": [("eg_se_stage_fp32", [_P] * 16 + [_I] * 5 + [_P]),
                 ("eg_se_stage_bf16", [_P] * 11 + [_I] * 8 + [_P]),
                 ("eg_se_active_clusters", [_I, _I])],
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's output (ptxas register counts)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)


def build_all(names=SOURCES) -> None:
    """Compile every listed source that is not built yet, in parallel."""
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _loaded:
            _loaded[name] = _open(_target(name), name)
    return _loaded[name]


def _open(path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name]:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def edited_source(name: str, edits) -> str:
    """`csrc/<name>.cu` with each (text, replacement) of `edits` applied;
    each text must occur exactly once."""
    text = (CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/{name}.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def build_variants(name: str, sources: dict[str, str],
                   out: Path) -> dict[str, ctypes.CDLL]:
    """Compile each variant's source text (a changed `csrc/<name>.cu`) into
    `out`, one nvcc each, all at once, and load each library."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (variant, text) in enumerate(sources.items()):
        src, lib = out / f"{name}_{i}.cu", out / f"lib{name}_{i}.so"
        src.write_text(text)
        procs[variant] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {variant!r} of "
                               f"csrc/{name}.cu:\n{log}")
        libs[variant] = _open(lib, name)
    return libs


@contextlib.contextmanager
def using(name: str, lib: ctypes.CDLL):
    """Inside the block, `load(name)` returns `lib`."""
    with _lock:
        before = _loaded.get(name)
        _loaded[name] = lib
    try:
        yield
    finally:
        with _lock:
            if before is None:
                _loaded.pop(name, None)
            else:
                _loaded[name] = before


def check_launch(code: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaGetLastError() code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with "
                           f"cudaError_t {code}")
