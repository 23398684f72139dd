"""Wrappers of the hand-written CUDA kernels of BP.

The counterparts of the JAX package's ``ops/bp_pallas.py``:

- ``cn_update`` (``csrc/cn_update.cu``): the min-sum check-node update of
  one BP iteration, unmasked or pinned (masked BP). Plain version
  ``ops.bp._cn_update_sm``.
- ``bp_span`` (``csrc/bp_span.cu``): a whole ``bp_run`` call, every
  iteration of it in one launch with the message block in shared memory,
  unmasked or pinned, with a float32 or bfloat16 history ring. Plain
  version ``ops.bp.bp_loop``.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .bp import BIG, PIN, PIN_THRESH, _cn_update_sm, bp_loop

SOURCE = "cn_update.cu"
SPAN_SOURCE = "bp_span.cu"
SMEM_MAX = 232_448  # dynamic shared memory one block may use on Hopper
MAX_THREADS = 1024
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


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def span_smem_bytes(garr, dtype: torch.dtype, shots: int) -> int:
    """Dynamic shared memory of one ``bp_span.cu`` block holding ``shots``
    shots: its ``make_layout``, array by array."""
    n, m_pad, dc, dv = garr["n"], garr["m_pad"], garr["dc"], garr["dv"]
    t = dtype.itemsize
    return sum(_align16(x) for x in (
        (dc * m_pad + 1) * shots * t,  # messages and the zero fill row
        n * shots * t,  # rounded posteriors
        4 * n,  # prior
        2 * dc * m_pad,  # cn_vn
        2 * n * dv,  # vn_from_cn
        2 * m_pad,  # check degrees
        n * shots,  # decimation states
        m_pad * shots,  # CN sign seeds
        m_pad * shots,  # syndrome bits
        16 * shots,  # done, iters, ran, mismatch
    ))


def span_tables(garr):
    """The int16 tables of ``bp_span.cu`` for one graph, built once and
    kept in ``garr``: ``cn_vn`` (= ``garr["cn_vn_clip"]``), ``vfc`` (=
    ``garr["vn_from_cn_flat"]``, whose fill index dc*m_pad selects the zero
    row) and ``deg``, the valid slots of each check row. None when the
    kernel cannot take the graph: an index beyond int16, or a row whose
    valid slots are not its first ``deg`` ones."""
    if "bp_span_tables" not in garr:
        n, dc, m_pad = garr["n"], garr["dc"], garr["m_pad"]
        valid = garr["cn_valid_sm"]
        deg = valid.sum(dim=0, dtype=torch.int16)
        slots = torch.arange(dc, device=valid.device)[:, None]
        ok = (max(n, dc * m_pad + 1) <= torch.iinfo(torch.int16).max
              and bool(torch.equal(valid, slots < deg[None])))
        garr["bp_span_tables"] = {
            "cn_vn": garr["cn_vn_clip"].to(torch.int16),
            "vfc": garr["vn_from_cn_flat"].to(torch.int16),
            "deg": deg,
        } if ok else None
    return garr["bp_span_tables"]


def max_shots_per_block(garr, dtype: torch.dtype) -> int:
    """The most shots one block holds within ``SMEM_MAX`` (0: not one)."""
    s = 0
    while s < MAX_THREADS and span_smem_bytes(garr, dtype, s + 1) <= SMEM_MAX:
        s += 1
    return s


def bp_span_supported(garr, B: int, dtype: torch.dtype) -> bool:
    """Shape gate of the fused kernel: f32 or bf16 messages, int16 index
    tables, check rows valid from slot 0, and one shot's message block,
    posteriors and states with the graph's tables within ``SMEM_MAX`` bytes
    of shared memory. The flagship windows (dc 35, m_pad 224, n <= 1728)
    hold 4 shots per block in f32 and 8 in bf16; an interior [[288]] W=4
    window (576x4896, m_pad 608) fits one bf16 shot (180,608 B) and no f32
    one (232,960 B), and the [[144]] global DEM graph (m_pad 960) none in
    either dtype. ``bp_run`` runs ``bp_loop`` for those. The history ring
    lives in device memory, so its dtype does not enter the gate."""
    return (
        dtype in _ENTRY
        and 0 < B < 2**31
        and span_tables(garr) is not None
        and max_shots_per_block(garr, dtype) >= 1
    )


def shots_per_block(garr, B: int, dtype: torch.dtype, num_sms: int) -> int:
    """Shots per block: as many as fit, but no more than it takes to give
    every SM a block (B=512 f32 and B=1024 bf16 on the flagship windows
    run 128 blocks of 4 and 8 shots on a 132-SM card)."""
    return max(1, min(max_shots_per_block(garr, dtype), -(-B // num_sms)))


@functools.cache
def _span_entry(dtype: torch.dtype, masked: bool, ring: torch.dtype):
    lib = cuda_build.load(SPAN_SOURCE)
    suffix = "_ring_bf16" if ring == torch.bfloat16 else ""
    fn = getattr(lib, f"bp_span_{'pinned_' if masked else ''}{_ENTRY[dtype]}{suffix}")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, ll, ll, ll, *[p] * 16, i, i, i, i, ll, i, i, i, i, *[f] * 5, p]
    fn.restype = ctypes.c_int
    return lib, fn


def bp_span(garr, mv, prior, parity, synd_t, vn_state, hist, error, done, iters, *,
            num_iter: int, hist_from: int, alpha: float, clip: float, masked: bool,
            freeze_messages: bool = True, posterior_matmul: bool = False,
            return_synd: bool = False):
    """One ``bp_run`` call's iterations: the arguments and results of
    ``ops.bp.bp_loop`` (``synd_hat`` [m_pad, B] int8 last when
    ``return_synd``: the kernel writes it only when asked).

    On CPU tensors this runs ``bp_loop`` (``bp_span.plain_calls``). On CUDA
    tensors it launches ``csrc/bp_span.cu`` once (``bp_span.launches``
    unmasked, ``bp_span.pinned_launches`` masked), or raises: the prior
    must be 1-D, ``posterior_matmul`` False and the graph admitted by
    ``bp_span_supported``. The kernel freezes every done shot, which
    ``freeze_messages=False`` permits; either way its outputs equal
    ``bp_loop``'s with ``freeze_messages=True``. ``hist`` [n, 4, B], f32
    or bf16 (the ring's type selects the kernel's entry point; a bf16 ring
    stores each f32 posterior rounded once to nearest even), is written in
    place; ``bp_span.bf16_ring_launches`` and
    ``bp_span.pinned_bf16_ring_launches`` count the unmasked and the masked
    launches that took a bf16 ring. A block holds ``shots_per_block`` shots
    and the most threads, up to 1024, that are a multiple of them.
    """
    if mv.device.type == "cpu":
        bp_span.plain_calls += 1
        return bp_loop(garr, mv, prior, parity, synd_t, vn_state, hist, error, done,
                       iters, num_iter=num_iter, hist_from=hist_from, alpha=alpha,
                       clip=clip, masked=masked, freeze_messages=freeze_messages,
                       posterior_matmul=posterior_matmul, return_synd=return_synd)
    if mv.device.type != "cuda":
        raise ValueError(f"bp_span: unsupported device {mv.device}")
    n, dc, m_pad, dv = garr["n"], garr["dc"], garr["m_pad"], garr["dv"]
    B = synd_t.shape[1]
    if posterior_matmul or prior.ndim != 1 or not bp_span_supported(garr, B, mv.dtype):
        raise ValueError(
            f"bp_span: unsupported call (messages {tuple(mv.shape)} {mv.dtype}, "
            f"prior {tuple(prior.shape)}, posterior_matmul={posterior_matmul})")
    write_hist = hist_from < num_iter
    checks = [
        ("mv", mv, (dc, m_pad, B), mv.dtype), ("prior", prior, (n,), torch.float32),
        ("parity", parity, (m_pad, B), torch.int32),
        ("synd_t", synd_t, (m_pad, B), torch.int32),
        ("error", error, (B, n), torch.int8), ("done", done, (B,), torch.bool),
        ("iters", iters, (B,), torch.int32),
    ]
    if masked and vn_state is not None:
        checks.append(("vn_state", vn_state, (B, n), torch.int8))
    ring = hist.dtype if write_hist else torch.float32
    if write_hist:
        if ring not in _ENTRY:
            raise ValueError(f"bp_span: hist must be float32 or bfloat16, got {ring}")
        checks.append(("hist", hist, (n, 4, B), ring))
    for name, t, shape, dtype in checks:
        if t.device != mv.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"bp_span: {name} must be {dtype} {shape} on {mv.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if write_hist and not hist.is_contiguous():
        raise ValueError("bp_span: hist must be contiguous (it is written in place)")

    tables = span_tables(garr)  # on the graph's device, as garr
    sms = torch.cuda.get_device_properties(mv.device).multi_processor_count
    shots = shots_per_block(garr, B, mv.dtype, sms)
    threads = MAX_THREADS // shots * shots
    prior, parity, synd_t, error, done, iters = (
        t.contiguous() for t in (prior, parity, synd_t, error, done, iters))
    vn = vn_state.contiguous() if masked and vn_state is not None else None
    mv_out = torch.empty((dc, m_pad, B), dtype=mv.dtype, device=mv.device)
    err_out, done_out, iters_out = (torch.empty_like(t) for t in (error, done, iters))
    synd_hat = (torch.empty((m_pad, B), dtype=torch.int8, device=mv.device)
                if return_synd else None)
    consts = [_storage_round(x, mv.dtype) for x in (alpha, clip, BIG, PIN_THRESH, PIN)]
    lib, fn = _span_entry(mv.dtype, masked, ring)
    stream = torch.cuda.current_stream(mv.device).cuda_stream
    with torch.cuda.device(mv.device):
        code = fn(
            mv.data_ptr(), *mv.stride(), mv_out.data_ptr(), prior.data_ptr(),
            parity.data_ptr(), synd_t.data_ptr(), vn.data_ptr() if vn is not None else None,
            hist.data_ptr() if write_hist else None, error.data_ptr(), err_out.data_ptr(),
            done.data_ptr(), done_out.data_ptr(), iters.data_ptr(), iters_out.data_ptr(),
            tables["cn_vn"].data_ptr(), tables["vfc"].data_ptr(), tables["deg"].data_ptr(),
            synd_hat.data_ptr() if return_synd else None,
            n, m_pad, dc, dv, B, shots, threads, num_iter, hist_from, *consts, stream,
        )
    cuda_build.check(lib, code, "bp_span kernel")
    bf16_ring = ring == torch.bfloat16
    if masked:
        bp_span.pinned_launches += 1
        bp_span.pinned_bf16_ring_launches += bf16_ring
    else:
        bp_span.launches += 1
        bp_span.bf16_ring_launches += bf16_ring
    out = (mv_out, hist, err_out, done_out, iters_out)
    return out + (synd_hat,) if return_synd else out


bp_span.launches = 0
bp_span.pinned_launches = 0
bp_span.bf16_ring_launches = 0
bp_span.pinned_bf16_ring_launches = 0
bp_span.plain_calls = 0
