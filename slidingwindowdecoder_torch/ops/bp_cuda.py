"""Wrapper of the hand-written CUDA check-node kernel (``csrc/cn_update.cu``).

The counterpart of the JAX package's ``ops/bp_pallas.py``: the min-sum
check-node update of the BP iteration, unmasked or pinned (masked BP). On a
CPU tensor the wrapper runs the plain version ``ops.bp._cn_update_sm``; on
a CUDA tensor it launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .bp import BIG, PIN_THRESH, _cn_update_sm

SOURCE = "cn_update.cu"
_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def cn_cuda_supported(mv: torch.Tensor) -> bool:
    """Shape gate (replaces the JAX ``cn_pallas_supported``): the kernel
    takes any [dc, m_pad, B] block in f32 or bf16 — one thread per (check,
    shot), no shared memory — as long as the grid fits one launch."""
    return (
        mv.ndim == 3
        and mv.dtype in _ENTRY
        and mv.shape[1] * mv.shape[2] <= 256 * (2**31 - 1)
    )


@functools.cache
def _entry(dtype: torch.dtype, pinned: bool):
    """(library, C entry point) of the kernel for one message dtype and
    mode; the pinned entry points take ``thresh`` after ``big``."""
    lib = cuda_build.load(SOURCE)
    fn = getattr(lib, f"cn_update_{'pinned_' if pinned else ''}{_ENTRY[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        *[ctypes.c_float] * (4 if pinned else 3), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _storage_round(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype).float())


def cn_update(mv, cn_valid_sm, parity, *, alpha: float, clip: float,
              pinned: bool = False):
    """Check-node update of slot-major messages.

    mv: [dc, m_pad, B] f32 or bf16; cn_valid_sm: [dc, m_pad] bool;
    parity: [m_pad, B] int32 sign seed. Returns mc, same shape and dtype.
    ``pinned=True`` is the masked-BP mode: messages >= PIN_THRESH are pins.
    ``cn_update.launches`` counts launches of the unmasked kernel,
    ``cn_update.pinned_launches`` those of the pinned one, and
    ``cn_update.plain_calls`` the calls that ran the plain version (CPU
    tensors, either mode).
    """
    if mv.device.type == "cpu":
        cn_update.plain_calls += 1
        return _cn_update_sm(mv, cn_valid_sm, parity, alpha=alpha, clip=clip,
                             pinned=pinned)
    if mv.device.type != "cuda":
        raise ValueError(f"cn_update: unsupported device {mv.device}")
    if not cn_cuda_supported(mv):
        raise ValueError(f"cn_update: unsupported messages {tuple(mv.shape)} {mv.dtype}")
    dc, m_pad, B = mv.shape
    for name, t, shape, dtype in (
        ("cn_valid_sm", cn_valid_sm, (dc, m_pad), torch.bool),
        ("parity", parity, (m_pad, B), torch.int32),
    ):
        if t.device != mv.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"cn_update: {name} must be {dtype} {shape} on {mv.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    mv = mv.contiguous()
    cn_valid_sm = cn_valid_sm.contiguous()
    parity = parity.contiguous()
    mc = torch.empty_like(mv)
    lib, fn = _entry(mv.dtype, pinned)
    consts = [_storage_round(x, mv.dtype)
              for x in (alpha, clip, BIG, *((PIN_THRESH,) if pinned else ()))]
    stream = torch.cuda.current_stream(mv.device).cuda_stream
    with torch.cuda.device(mv.device):
        code = fn(
            mv.data_ptr(), cn_valid_sm.data_ptr(), parity.data_ptr(), mc.data_ptr(),
            dc, m_pad, B, *consts, stream,
        )
    cuda_build.check(lib, code, "cn_update kernel")
    if pinned:
        cn_update.pinned_launches += 1
    else:
        cn_update.launches += 1
    return mc


cn_update.launches = 0
cn_update.pinned_launches = 0
cn_update.plain_calls = 0
