"""Builds the port's native sources into shared libraries and loads them.

A CUDA source (``.cu``) is compiled by ``nvcc`` for ``sm_90a``, a host
source (``.cpp``, the image decoder) by the host C++ compiler with
``HOST_FLAGS`` and linked with ``HOST_LIBS``; either way into a plain C
shared object (no PyTorch headers, so a build takes seconds) bound with
``ctypes``.  Builds happen on first use, never at import, into
``build/css_tpu_torch/`` at the root of the checkout; the file name carries a
hash of the source and the command's flags, so an edited source is rebuilt
and a stale library is never loaded.  :func:`build_all` starts one compiler
per library at once, and so does the first :func:`load_library` of a CUDA
source for every source of ``SOURCES`` not yet built: the first use pays one
build's time, not one for each library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "HOST_FLAGS", "HOST_LIBS", "SOURCES",
           "load_library", "build_all"]

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "css_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("contrastive_kernels.cu", "batchnorm_kernels.cu")   # every CUDA source of the port
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
HOST_LIBS = ("-ljpeg", "-lpng", "-lz")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use "
                       "and need the CUDA toolkit")


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) on the PATH: the image decoder "
                       "is built on first use")


def _flags(src: Path) -> Tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS + HOST_LIBS


def _target(source: str) -> Tuple[Path, Path]:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode())
    return src, BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str):
    """Starts the compiler for ``source`` unless its library exists;
    returns (library path, process or None, temporary output path)."""
    src, lib = _target(source)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    if src.suffix == ".cu":
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    else:   # the libraries after the source, for the linker
        cmd = [_cxx(), *HOST_FLAGS, "-o", str(tmp), str(src), *HOST_LIBS]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc, tmp


def _finish(source: str, lib: Path, proc, tmp) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    build_logs[source] = out
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(proc.args[0]).name} failed on {source} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def _build(sources: List[str]) -> List[Path]:
    """Builds every source at once, one compiler each (the caller holds
    ``_lock``); returns the libraries."""
    started = [(s, *_start(s)) for s in sources]
    for source, lib, proc, tmp in started:
        _finish(source, lib, proc, tmp)
    return [lib for _, lib, _, _ in started]


def build_all(sources: Iterable[str]) -> List[Path]:
    """Builds every source at once, one nvcc each; returns the libraries."""
    with _lock:
        return _build(list(sources))


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``, built if needed
    (with the other CUDA sources, for a source of ``SOURCES``)."""
    with _lock:
        if source not in _loaded:
            together = list(SOURCES) if source in SOURCES else [source]
            libs = dict(zip(together, _build(together)))
            _loaded[source] = ctypes.CDLL(str(libs[source]))
        return _loaded[source]
