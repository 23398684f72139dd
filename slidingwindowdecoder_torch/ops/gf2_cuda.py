"""Wrapper of the hand-written CUDA Gauss-Jordan kernel (``csrc/gauss_jordan.cu``).

The counterpart of the JAX package's ``ops/gf2_pallas.py``: the batched
reliability-ordered GF(2) elimination of OSD. The kernel takes float keys,
so it serves both forms of the JAX package: the float-keyed elimination of
the main path (``gauss_jordan_key``) and the integer-order form of the
Pallas kernel (``gauss_jordan_order``, whose order becomes rank-position
keys). On a CPU tensor the wrapper runs the plain version
``ops.gf2_solve.ordered_gauss_jordan_key``; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .gf2_solve import gj_outputs, ordered_gauss_jordan_key

SOURCE = "gauss_jordan.cu"
MAX_SMEM = 232_448  # bytes of shared memory a block can use on an H100


def smem_bytes(m: int, n: int, W: int) -> int:
    """Shared memory the kernel needs for one shot (the packed state, the
    keys, the live words and two row flags)."""
    return m * (W + 1) * 4 + n * 4 + W * 4 + 2 * m


def gj_cuda_supported(m: int, n: int, W: int) -> bool:
    """Shape gate: one shot's elimination state must fit a block's shared
    memory."""
    return smem_bytes(m, n, W) <= MAX_SMEM


@functools.cache
def _entry():
    """(library, C entry point) of the kernel."""
    lib = cuda_build.load(SOURCE)
    fn = lib.gauss_jordan_key
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def gauss_jordan_key(H_words, syndrome, key, *, m: int, n: int, rank: int):
    """Reliability-ordered Gauss-Jordan with float keys.

    H_words: [m, W] int32 packed PCM rows; syndrome: [B, m] 0/1 (any
    integer dtype); key: [B, n] float32, smaller = tried first, ties to the
    lower column. Returns the dict of ``ops.gf2_solve.gj_outputs``.
    ``gauss_jordan_key.launches`` counts kernel launches,
    ``gauss_jordan_key.plain_calls`` the calls that ran the plain version.
    """
    dev = syndrome.device
    if dev.type == "cpu":
        gauss_jordan_key.plain_calls += 1
        return ordered_gauss_jordan_key(H_words, syndrome, key, m=m, n=n, rank=rank)
    if dev.type != "cuda":
        raise ValueError(f"gauss_jordan_key: unsupported device {dev}")
    B = syndrome.shape[0]
    W = -(-n // 32)
    if (
        H_words.device != dev or H_words.dtype != torch.int32
        or tuple(H_words.shape) != (m, W)
    ):
        raise ValueError(
            f"gauss_jordan_key: H_words must be int32 [{m}, {W}] on {dev}, "
            f"got {H_words.dtype} {tuple(H_words.shape)} on {H_words.device}"
        )
    if tuple(syndrome.shape) != (B, m) or syndrome.dtype.is_floating_point:
        raise ValueError(f"gauss_jordan_key: syndrome must be integer [B, {m}]")
    if key.device != dev or key.dtype != torch.float32 or tuple(key.shape) != (B, n):
        raise ValueError(
            f"gauss_jordan_key: key must be float32 [{B}, {n}] on {dev}, "
            f"got {key.dtype} {tuple(key.shape)} on {key.device}"
        )
    if not 0 <= rank <= m:
        raise ValueError(f"gauss_jordan_key: rank {rank} outside [0, {m}]")
    if not gj_cuda_supported(m, n, W):
        raise ValueError(
            f"gauss_jordan_key: {smem_bytes(m, n, W)} bytes of shared memory "
            f"per shot exceed {MAX_SMEM}"
        )
    H_words = H_words.contiguous()
    synd_u8 = syndrome.to(torch.uint8).contiguous()
    key = key.contiguous()
    state = torch.empty((B, m, W + 1), dtype=torch.int32, device=dev)
    pcol = torch.empty((B, rank), dtype=torch.int32, device=dev)
    prow = torch.empty((B, rank), dtype=torch.int32, device=dev)
    incons = torch.empty((B,), dtype=torch.uint8, device=dev)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        code = fn(
            H_words.data_ptr(), synd_u8.data_ptr(), key.data_ptr(),
            state.data_ptr(), pcol.data_ptr(), prow.data_ptr(), incons.data_ptr(),
            m, n, W, rank, B, torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, code, "gauss_jordan_key kernel")
    gauss_jordan_key.launches += 1
    return gj_outputs(state.permute(1, 2, 0), pcol.T, prow.T, incons, n=n)


gauss_jordan_key.launches = 0
gauss_jordan_key.plain_calls = 0


def rank_position_keys(order) -> torch.Tensor:
    """[B, n] column order -> [B, n] f32 keys: key[b, order[b, p]] = p, the
    rank positions the JAX Pallas wrapper feeds its kernel (exact in f32
    below 2**24)."""
    B, n = order.shape
    pos = torch.arange(n, dtype=torch.float32, device=order.device).expand(B, n)
    return torch.empty((B, n), dtype=torch.float32, device=order.device).scatter_(
        1, order.long(), pos
    )


def gauss_jordan_order(H_words, syndrome, order, *, m: int, n: int, rank: int):
    """Integer-order form: ``order`` [B, n] lists each shot's columns in
    reliability order (tried first to last). Same result dict."""
    return gauss_jordan_key(
        H_words, syndrome, rank_position_keys(order), m=m, n=n, rank=rank
    )
