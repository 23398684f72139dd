"""ctypes bindings for the native host library (``csrc/swd_native.cpp``,
the port's copy of the JAX package's ``native/swd_native.cpp``).

Built with ``g++`` on first use into ``build/`` at the root of the
checkout, under a name that carries a hash of the source and the flags
(an edited source is rebuilt, a stale library never loaded). When the
toolchain is missing, ``gf2_rank`` falls back to numpy and the other
entry points raise, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache

import numpy as np

from .utils.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "swd_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"swd_native-{digest[:16]}.so"


@lru_cache(maxsize=1)
def load_library():
    """Build (if needed) and load the native library; None on failure."""
    out = library_path()
    try:
        if not out.exists():
            cxx = shutil.which(os.environ.get("CXX", "g++"))
            if cxx is None:
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True)
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.SubprocessError):
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")

    lib.gf2_rank_packed.restype = ctypes.c_int
    lib.gf2_rank_packed.argtypes = [u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.gf2_rref_packed.restype = ctypes.c_int
    lib.gf2_rref_packed.argtypes = [
        u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
    ]
    lib.gf2_ordered_solve_packed.restype = ctypes.c_int
    lib.gf2_ordered_solve_packed.argtypes = [
        u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, u8p, u8p,
    ]
    lib.serial_bp_decode.restype = ctypes.c_int
    lib.serial_bp_decode.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f64p, u8p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        u8p, f64p, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dem_merge_signatures.restype = ctypes.c_int
    lib.dem_merge_signatures.argtypes = [
        u64p, ctypes.c_int, ctypes.c_int, i32p, i32p,
    ]
    return lib


def available() -> bool:
    return load_library() is not None


def _pack64(H: np.ndarray) -> tuple[np.ndarray, int]:
    H = (np.asarray(H) != 0).astype(np.uint8)
    m, n = H.shape
    W = -(-n // 64)
    padded = np.zeros((m, W * 64), dtype=np.uint8)
    padded[:, :n] = H
    bits = padded.reshape(m, W, 64).astype(np.uint64)
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return np.ascontiguousarray((bits * weights).sum(axis=2, dtype=np.uint64)), W


def gf2_rank(H: np.ndarray) -> int:
    """Rank over GF(2); native if possible, numpy fallback otherwise."""
    lib = load_library()
    if lib is None:
        from .ops.gf2_solve import gf2_rank_packed as _fallback

        return _fallback(H)
    rows, W = _pack64(H)
    m, n = np.asarray(H).shape
    return int(lib.gf2_rank_packed(rows, m, W, n))


def gf2_ordered_solve(H, order, syndrome):
    """Solve H x = s with greedy pivots in the given column order.

    Returns (x, rank) or (None, -1) when inconsistent.
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    H = np.asarray(H)
    m, n = H.shape
    rows, W = _pack64(H)
    x = np.zeros(n, dtype=np.uint8)
    r = lib.gf2_ordered_solve_packed(
        rows, m, W, n,
        np.ascontiguousarray(order, dtype=np.int32),
        np.ascontiguousarray(syndrome, dtype=np.uint8),
        x,
    )
    if r < 0:
        return None, -1
    return x, int(r)


def serial_bp_decode(H, prior_llr, syndrome, *, max_iter=100, alpha=1.0, clip=50.0):
    """Reference-semantics serial min-sum decode (float64 oracle).

    Returns dict(error, posterior, converged, iterations).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    H = (np.asarray(H) != 0).astype(np.uint8)
    m, n = H.shape
    rows, cols = np.nonzero(H)
    counts = np.bincount(rows, minlength=m)
    row_ptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    col_idx = cols.astype(np.int32)
    error = np.zeros(n, dtype=np.uint8)
    posterior = np.zeros(n, dtype=np.float64)
    iters = ctypes.c_int32(0)
    conv = lib.serial_bp_decode(
        np.ascontiguousarray(row_ptr),
        np.ascontiguousarray(col_idx),
        m, n, len(col_idx),
        np.ascontiguousarray(prior_llr, dtype=np.float64),
        np.ascontiguousarray(syndrome, dtype=np.uint8),
        int(max_iter), float(alpha), float(clip),
        error, posterior, ctypes.byref(iters),
    )
    return {
        "error": error,
        "posterior": posterior,
        "converged": bool(conv),
        "iterations": int(iters.value),
    }
