"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``build/`` at the root of
the checkout at first use. The file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source name -> nvcc's output (ptxas report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources) -> dict[str, float]:
    """Compile every source that is not built yet, one ``nvcc`` each, all
    started together. Returns seconds per source built. Raises with the
    compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            tmp, out, time.perf_counter(),
        )
    seconds = {}
    failed = []
    for source, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        build_log[source] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc/`` source, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        lib.swd_error_string.argtypes = [ctypes.c_int]
        lib.swd_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.swd_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
