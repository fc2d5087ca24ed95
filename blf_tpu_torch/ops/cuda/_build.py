"""Builder and loader of the port's hand-written CUDA kernels.

No counterpart in ``blf_tpu`` (Pallas kernels are compiled by JAX). A kernel
source under ``blf_tpu_torch/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [-D...] -o blf_tpu_torch/_build/<name>_<hash>.so <src>

The build happens at first use, never at import, so every module of the
package imports on a machine with no ``nvcc`` and no GPU. The library's name
carries a hash of the source, of every header of ``csrc/`` it includes
(``#include "..."``, followed through headers), of the flags and of the
compile-time definitions, so a stale library is never loaded: a changed
source or header builds anew. A failed build or load raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

from blf_tpu_torch._paths import BUILD_DIR, PACKAGE_DIR

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "source_files",
           "library_path", "build_library", "load_library", "last_build_log"]

CSRC_DIR = PACKAGE_DIR / "csrc"

#: No ``-use_fast_math``: divisions and square roots stay IEEE (see
#: ``blf_tpu_torch/ops/precision.py``). ``-Xptxas -v`` makes the compiler
#: report registers, shared memory and spills, which the build log keeps.
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin):"
        " the CUDA kernels of blf_tpu_torch are compiled at first use and"
        " need the CUDA toolkit")


def _definition_flags(defines: Optional[Mapping[str, object]]) -> Tuple[str, ...]:
    return tuple(f"-D{k}={v}" for k, v in sorted((defines or {}).items()))


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(source: str) -> List[Path]:
    """``csrc/<source>`` and every header it includes with ``#include "..."``,
    directly or through another header, in the order first met."""
    found: List[Path] = []
    todo = [CSRC_DIR / source]
    while todo:
        path = todo.pop(0).resolve()
        if path in found:
            continue
        found.append(path)
        todo.extend(path.parent / name
                    for name in _LOCAL_INCLUDE.findall(path.read_text()))
    return found


def library_path(source: str, defines: Optional[Mapping[str, object]] = None) -> Path:
    """Where the library of ``csrc/<source>`` with these definitions lives."""
    src = CSRC_DIR / source
    h = hashlib.sha256()
    for path in source_files(source):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _definition_flags(defines)).encode())
    tag = "_".join(f"{k.lower()}{v}" for k, v in sorted((defines or {}).items()))
    stem = src.stem + (f"_{tag}" if tag else "")
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build_library(source: str, defines: Optional[Mapping[str, object]] = None) -> Path:
    """Compile ``csrc/<source>`` unless an up-to-date library exists."""
    out = library_path(source, defines)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, *_definition_flags(defines),
           "-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    _logs[out.name] = log
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {source}:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent process never loads half a file
    return out


def load_library(source: str, defines: Optional[Mapping[str, object]] = None) -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
    with _lock:
        path = build_library(source, defines)
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _loaded[path] = lib
        return lib


def last_build_log(source: str, defines: Optional[Mapping[str, object]] = None) -> str:
    """The compiler's output for this library (empty if it was not built in
    this process and left no log)."""
    path = library_path(source, defines)
    if path.name in _logs:
        return _logs[path.name]
    log = path.with_suffix(".log")
    return log.read_text() if log.is_file() else ""
