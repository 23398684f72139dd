"""Wrappers of the hand-written CUDA kernels of BP.

The counterparts of the JAX package's ``ops/bp_pallas.py``:

- ``cn_update`` (``csrc/cn_update.cu``): the min-sum check-node update of
  one BP iteration, unmasked or pinned (masked BP). Plain version
  ``ops.bp._cn_update_sm``.
- ``bp_span`` (``csrc/bp_span.cu``): a whole ``bp_run`` call, every
  iteration of it in one launch with the message blocks in shared memory,
  unmasked or pinned, with a float32 or bfloat16 history ring. Plain
  version ``ops.bp.bp_loop``. Two table routes of one kernel template
  (``span_route``): the shared-table route (``bp_span_supported``) copies
  the graph's int16 index tables and prior into each block; the
  global-table route (``bp_span_wide_supported``) reads uint16 tables and
  the prior from device memory through the read-only cache, for graphs
  whose tables and message block do not fit one block together (the
  [[144]] global DEM, the interior [[288]] W=4 windows in f32). Either
  route runs in place for callers that rebind their carry
  (``bp_span(inplace=True)``), and then neither reads nor writes the
  columns done at entry.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .bp import BIG, PIN, PIN_THRESH, _cn_update_sm, bp_loop, column_major, is_column_major

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


# the table routes of ``bp_span.cu``: tables and prior in each block's
# shared memory, or read from device memory
SHARED, WIDE = "shared", "wide"


def span_smem_bytes(garr, dtype: torch.dtype, shots: int, route: str = SHARED) -> int:
    """Dynamic shared memory of one ``bp_span.cu`` block holding ``shots``
    columns on ``route``: its ``make_layout``, array by array (the wide
    route keeps no tables and no prior there)."""
    n, m_pad, dc, dv = garr["n"], garr["m_pad"], garr["dc"], garr["dv"]
    t = dtype.itemsize
    tab = route == SHARED
    return sum(_align16(x) for x in (
        (dc * m_pad + 1) * shots * t,  # messages and the zero fill row
        n * shots * t,  # rounded posteriors
        4 * n * tab,  # prior
        2 * dc * m_pad * tab,  # cn_vn
        2 * n * dv * tab,  # vn_from_cn
        2 * m_pad * tab,  # check degrees
        n * shots,  # decimation states
        m_pad * shots,  # CN sign seeds
        m_pad * shots,  # syndrome bits
        16 * shots,  # done, iters, ran, mismatch
    ))


def span_tables(garr, route: str = SHARED):
    """The index tables of ``bp_span.cu`` on ``route`` for one graph, built
    once and kept in ``garr``: ``cn_vn`` (= ``garr["cn_vn_clip"]``), ``vfc``
    (= ``garr["vn_from_cn_flat"]``, whose fill index dc*m_pad selects the
    zero row) and ``deg``, the valid slots of each check row; int16 on the
    shared-table route, uint16 on the wide route (held in int16 tensors:
    the kernel reads their bits as uint16). None when the route cannot take
    the graph: an index beyond its type, or a row whose valid slots are not
    its first ``deg`` ones."""
    key = "bp_span_tables" if route == SHARED else "bp_span_wide_tables"
    if key not in garr:
        n, dc, m_pad = garr["n"], garr["dc"], garr["m_pad"]
        valid = garr["cn_valid_sm"]
        deg = valid.sum(dim=0, dtype=torch.int16)
        slots = torch.arange(dc, device=valid.device)[:, None]
        top = torch.iinfo(torch.int16).max if route == SHARED else 2**16 - 1
        ok = (max(n, dc * m_pad + 1) <= top
              and bool(torch.equal(valid, slots < deg[None])))

        def idx(t):  # values below 2**16, as the bits of an int16 tensor
            return (t.to(torch.int32) - (t >= 2**15).to(torch.int32) * 2**16).to(torch.int16)

        garr[key] = {
            "cn_vn": idx(garr["cn_vn_clip"]),
            "vfc": idx(garr["vn_from_cn_flat"]),
            "deg": deg,
        } if ok else None
    return garr[key]


def max_shots_per_block(garr, dtype: torch.dtype, route: str = SHARED) -> int:
    """The most columns one block holds within ``SMEM_MAX`` on ``route``
    (0: not one), worked out once a graph, dtype and route and kept in
    ``garr`` (every launch asks)."""
    key = f"bp_span_max_shots_{route}_{dtype}"
    if key not in garr:
        s = 0
        while s < MAX_THREADS and span_smem_bytes(garr, dtype, s + 1, route) <= SMEM_MAX:
            s += 1
        garr[key] = s
    return garr[key]


def bp_span_supported(garr, B: int, dtype: torch.dtype) -> bool:
    """Shape gate of the shared-table route: f32 or bf16 messages, int16
    index tables, check rows valid from slot 0, and one column's message
    block, posteriors and states with the graph's tables within
    ``SMEM_MAX`` bytes of shared memory. The flagship windows (dc 35, m_pad
    224, n <= 1728) hold 4 columns per block in f32 and 8 in bf16; an
    interior [[288]] W=4 window (576x4896, m_pad 608) fits one bf16 column
    (180,608 B) and no f32 one (232,960 B), and the [[144]] global DEM
    graph (m_pad 960) none in either dtype: those take the wide route
    (``bp_span_wide_supported``). The history ring lives in device memory,
    so its dtype does not enter the gate."""
    return (
        dtype in _ENTRY
        and 0 < B < 2**31
        and span_tables(garr) is not None
        and max_shots_per_block(garr, dtype) >= 1
    )


def bp_span_wide_supported(garr, B: int, dtype: torch.dtype) -> bool:
    """Shape gate of the wide (global-table) route: f32 or bf16 messages,
    uint16 index tables (dc*m_pad + 1 and n below 2**16), check rows valid
    from slot 0, and one shot's per-shot state within ``SMEM_MAX``. The
    [[144]] global DEM holds one f32 shot a block (180,272 B) and two bf16
    (190,992 B); an interior [[288]] W=4 window two f32 shots (221,680 B)."""
    return (
        dtype in _ENTRY
        and 0 < B < 2**31
        and span_tables(garr, WIDE) is not None
        and max_shots_per_block(garr, dtype, WIDE) >= 1
    )


def span_route(garr, B: int, dtype: torch.dtype) -> str | None:
    """The table route a ``bp_run`` call of this graph, batch and message
    dtype takes on the card: ``SHARED`` where that route's gate admits it,
    else ``WIDE`` where the wide route's does, else None (``bp_run`` then
    runs ``bp_loop``)."""
    if bp_span_supported(garr, B, dtype):
        return SHARED
    if bp_span_wide_supported(garr, B, dtype):
        return WIDE
    return None


def shots_per_block(garr, B: int, dtype: torch.dtype, num_sms: int,
                    route: str = SHARED) -> int:
    """Columns per block: as many as fit on ``route``, but no more than it
    takes to give every SM a block (B=512 f32 and B=1024 bf16 on the
    flagship windows run 128 blocks of 4 and 8 columns on a 132-SM card)."""
    return max(1, min(max_shots_per_block(garr, dtype, route), -(-B // num_sms)))


@functools.cache
def _span_entry(dtype: torch.dtype, masked: bool, ring: torch.dtype, route: str = SHARED):
    lib = cuda_build.load(SPAN_SOURCE)
    suffix = "_ring_bf16" if ring == torch.bfloat16 else ""
    wide = "wide_" if route == WIDE else ""
    fn = getattr(lib, f"bp_span_{wide}{'pinned_' if masked else ''}{_ENTRY[dtype]}{suffix}")
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, ll, ll, ll, p, ll, ll, ll, p, p, p, p, ll, ll, p, p, p, ll, ll,
                   *[p] * 8, i, i, i, i, ll, *[i] * 5, *[f] * 5, p]
    fn.restype = ctypes.c_int
    return lib, fn


def bp_span(garr, mv, prior, parity, synd_t, vn_state, hist, error, done, iters, *,
            num_iter: int, hist_from: int, alpha: float, clip: float, masked: bool,
            freeze_messages: bool = True, posterior_matmul: bool = False,
            return_synd: bool = False, inplace: bool = False):
    """One ``bp_run`` call's iterations: the arguments and results of
    ``ops.bp.bp_loop`` (``synd_hat`` [m_pad, B] int8 last when
    ``return_synd``: the kernel writes it only when asked).

    On CPU tensors this runs ``bp_loop`` (``bp_span.plain_calls``). On CUDA
    tensors it launches ``csrc/bp_span.cu`` once on the table route
    ``span_route`` names: ``bp_span.launches`` unmasked and
    ``bp_span.pinned_launches`` masked count the shared-table route,
    ``bp_span.wide_launches`` and ``bp_span.pinned_wide_launches`` the wide
    one. It raises where the route cannot take the call: the prior must be
    1-D, ``posterior_matmul`` False and the graph admitted by the route's
    gate. The kernel freezes every done column, which
    ``freeze_messages=False`` permits; either way its outputs equal
    ``bp_loop``'s with ``freeze_messages=True``. ``hist`` [n, 4, B], f32
    or bf16 (the ring's type selects the kernel's entry point; a bf16 ring
    stores each f32 posterior rounded once to nearest even), is written in
    place; ``bp_span.bf16_ring_launches`` and
    ``bp_span.pinned_bf16_ring_launches`` count the unmasked and the masked
    launches that took a bf16 ring (either route).

    ``inplace=False``, the JAX package's functional contract: the inputs
    are left as they are (but for the ring) and the outputs are new; in
    masked mode a column done at entry leaves with its messages pinned at
    entry, as the JAX loop's. ``inplace=True``, for callers that rebind
    their carry: the messages (where contiguous or column-major,
    ``ops.bp.is_column_major``, else a column-major copy), error, done and
    iterations are written in place and returned, and a column done at
    entry is neither read nor written (but for its ``synd_hat``): it keeps
    every input, its messages unpinned (``bp_loop(keep_done=True)``). The
    shared-table route's new message blocks are column-major: the kernel
    then reads and writes each column's block whole.
    """
    if mv.device.type == "cpu":
        bp_span.plain_calls += 1
        out = bp_loop(garr, mv, prior, parity, synd_t, vn_state, hist, error, done, iters,
                      num_iter=num_iter, hist_from=hist_from, alpha=alpha, clip=clip,
                      masked=masked, freeze_messages=freeze_messages,
                      posterior_matmul=posterior_matmul, return_synd=return_synd,
                      keep_done=inplace)
        if not inplace:
            return out
        dense = mv.is_contiguous() or is_column_major(mv)
        res = [mv.copy_(out[0]) if dense else out[0], out[1],
               error.copy_(out[2]), done.copy_(out[3]), iters.copy_(out[4])]
        return tuple(res + list(out[5:]))
    if mv.device.type != "cuda":
        raise ValueError(f"bp_span: unsupported device {mv.device}")
    return _launch_span(span_route(garr, synd_t.shape[1], mv.dtype), garr, mv, prior, parity,
                        synd_t, vn_state, hist, error, done, iters, num_iter=num_iter,
                        hist_from=hist_from, alpha=alpha, clip=clip, masked=masked,
                        posterior_matmul=posterior_matmul, return_synd=return_synd,
                        inplace=inplace)


def _check_span_call(route, garr, mv, prior, parity, synd_t, vn_state, hist, error, done,
                     iters, *, num_iter, hist_from, masked, posterior_matmul):
    n, dc, m_pad = garr["n"], garr["dc"], garr["m_pad"]
    B = synd_t.shape[1]
    gate = {SHARED: bp_span_supported, WIDE: bp_span_wide_supported}.get(route)
    if posterior_matmul or prior.ndim != 1 or gate is None or not gate(garr, B, mv.dtype):
        raise ValueError(
            f"bp_span: unsupported call (messages {tuple(mv.shape)} {mv.dtype}, "
            f"prior {tuple(prior.shape)}, posterior_matmul={posterior_matmul}, "
            f"route {route})")
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
    return ring


def _dense(t: torch.Tensor) -> bool:
    """Whether a 1-D or 2-D ``t``'s elements each have their own storage
    (no broadcast), so a kernel may write it through its strides."""
    return t.is_contiguous() or t.T.is_contiguous()


def _launch_span(route, garr, mv, prior, parity, synd_t, vn_state, hist, error, done, iters,
                 *, num_iter: int, hist_from: int, alpha: float, clip: float, masked: bool,
                 freeze_messages: bool = True, posterior_matmul: bool = False,
                 return_synd: bool = False, inplace: bool = False):
    """``bp_span``'s launch on CUDA tensors on the table route ``route``
    (``SHARED`` or ``WIDE``); the checks of the wide route at shapes the
    shared one takes call it directly."""
    ring = _check_span_call(route, garr, mv, prior, parity, synd_t, vn_state, hist, error,
                            done, iters, num_iter=num_iter, hist_from=hist_from,
                            masked=masked, posterior_matmul=posterior_matmul)
    n, dc, m_pad, dv = garr["n"], garr["dc"], garr["m_pad"], garr["dv"]
    B = synd_t.shape[1]
    write_hist = hist_from < num_iter
    tables = span_tables(garr, route)  # on the graph's device, as garr
    prior, parity, synd_t = (t.contiguous() for t in (prior, parity, synd_t))
    synd_hat = (torch.empty((m_pad, B), dtype=torch.int8, device=mv.device)
                if return_synd else None)
    consts = [_storage_round(x, mv.dtype) for x in (alpha, clip, BIG, PIN_THRESH, PIN)]
    lib, fn = _span_entry(mv.dtype, masked, ring, route)
    stream = torch.cuda.current_stream(mv.device).cuda_stream
    sms = torch.cuda.get_device_properties(mv.device).multi_processor_count
    shots = shots_per_block(garr, B, mv.dtype, sms, route)
    vn = vn_state if masked and vn_state is not None else None
    done_in, iters_in = done.contiguous(), iters.contiguous()
    if inplace:  # the caller's tensors where they are dense, else copies
        mv_in = mv if mv.is_contiguous() or is_column_major(mv) else column_major(mv)
        err_in = error if _dense(error) else error.contiguous()
        mv_out, err_out, done_out, iters_out = mv_in, err_in, done_in, iters_in
    else:  # new outputs, the error [B, n] contiguous as bp_loop's
        mv_in, err_in = mv, error.contiguous()
        mv_out = (torch.empty((B, dc, m_pad), dtype=mv.dtype, device=mv.device).permute(1, 2, 0)
                  if route == SHARED else
                  torch.empty((dc, m_pad, B), dtype=mv.dtype, device=mv.device))
        err_out = torch.empty_like(err_in)
        done_out, iters_out = torch.empty_like(done_in), torch.empty_like(iters_in)
    with torch.cuda.device(mv.device):
        code = fn(
            mv_in.data_ptr(), *mv_in.stride(), mv_out.data_ptr(), *mv_out.stride(),
            prior.data_ptr(), parity.data_ptr(), synd_t.data_ptr(),
            vn.data_ptr() if vn is not None else None, *(vn.stride() if vn is not None else (0, 0)),
            hist.data_ptr() if write_hist else None, err_in.data_ptr(), err_out.data_ptr(),
            *err_in.stride(), done_in.data_ptr(), done_out.data_ptr(), iters_in.data_ptr(),
            iters_out.data_ptr(), tables["cn_vn"].data_ptr(), tables["vfc"].data_ptr(),
            tables["deg"].data_ptr(), synd_hat.data_ptr() if return_synd else None,
            n, m_pad, dc, dv, B, shots, MAX_THREADS // shots * shots, num_iter, hist_from,
            int(inplace), *consts, stream)
    cuda_build.check(lib, code, "bp_span kernel")
    if inplace:  # back into the caller's done and iterations where they were copied
        if done_out is not done:
            done.copy_(done_out)
            done_out = done
        if iters_out is not iters:
            iters.copy_(iters_out)
            iters_out = iters
    out = (mv_out, hist, err_out, done_out, iters_out)
    bf16_ring = ring == torch.bfloat16
    counter = f"{'pinned_' if masked else ''}{'wide_' if route == WIDE else ''}launches"
    setattr(bp_span, counter, getattr(bp_span, counter) + 1)
    if masked:
        bp_span.pinned_bf16_ring_launches += bf16_ring
    else:
        bp_span.bf16_ring_launches += bf16_ring
    return out + (synd_hat,) if return_synd else out


bp_span.launches = 0
bp_span.pinned_launches = 0
bp_span.wide_launches = 0
bp_span.pinned_wide_launches = 0
bp_span.bf16_ring_launches = 0
bp_span.pinned_bf16_ring_launches = 0
bp_span.plain_calls = 0
