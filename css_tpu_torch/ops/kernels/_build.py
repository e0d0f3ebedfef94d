"""Builds the port's CUDA sources into shared libraries and loads them.

Each library is compiled by ``nvcc`` for ``sm_90a`` into a plain C shared
object (no PyTorch headers, so a build takes seconds) and bound with
``ctypes``.  Builds happen on first use, never at import, into
``build/css_tpu_torch/`` at the root of the checkout; the file name carries a
hash of the source, so an edited source is rebuilt and a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per library at once.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "load_library", "build_all"]

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "css_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("contrastive_kernels.cu",)   # every CUDA source of the port

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


def _target(source: str) -> Tuple[Path, Path]:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str):
    """Starts nvcc for ``source`` unless its library exists; returns
    (library path, process or None, temporary output path)."""
    src, lib = _target(source)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, proc, tmp


def _finish(source: str, lib: Path, proc, tmp) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    build_logs[source] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def build_all(sources: Iterable[str]) -> List[Path]:
    """Builds every source at once, one nvcc each; returns the libraries."""
    sources = list(sources)
    with _lock:
        started = [(s, *_start(s)) for s in sources]
        for source, lib, proc, tmp in started:
            _finish(source, lib, proc, tmp)
    return [lib for _, lib, _, _ in started]


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``, built if needed."""
    with _lock:
        if source not in _loaded:
            lib, proc, tmp = _start(source)
            _finish(source, lib, proc, tmp)
            _loaded[source] = ctypes.CDLL(str(lib))
        return _loaded[source]
