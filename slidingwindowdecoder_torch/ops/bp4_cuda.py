"""Wrapper of the hand-written CUDA kernel of BP4: a whole ``bp4_run`` call.

``bp4_span`` (``csrc/bp4_span.cu``) runs every iteration of one
``ops.bp4.bp4_run`` call in one launch, one block a shot, both graphs'
messages of the shot in shared memory: kernel A's check stage, the per-variable sums, the
posteriors and hard decision, the edge stage and the convergence test.
Plain version ``ops.bp4.bp4_loop`` (the per-op loop: kernel A, then torch
ops). Its tables: per graph, the check offsets and the variable of each
edge (the check-major edge order, each check's valid slots in order), and
a CSR table of each variable's edges in its slot order, the order of the
plain ``_col_sums`` (``bp4_span_tables``).

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches its kernel, or raises for graphs past its shared-memory gate
(``bp4_span_supported``) — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import cuda_build
from .bp import BIG
from .bp4 import bp4_initial_values, bp4_loop
from .bp_cuda import SMEM_MAX, _align16, _storage_round

SOURCE = "bp4_span.cu"
IDX_MAX = 2**15 - 1  # the tables are int16


def bp4_span_tables(garr):
    """One graph's tables of ``bp4_span.cu``, built once and kept in
    ``garr`` (on its device): ``row_ptr`` [m + 1] (each check's first edge
    in the check-major edge order), ``row_vn`` [nnz] (the variable of each
    edge), ``var_ptr`` [n + 1] and ``var_edge`` [nnz] (each variable's
    edges in its slot order: ``vn_from_cn_flat``'s valid slots), all int16.
    None when the kernel cannot take the graph: an index past int16, or a
    check whose valid slots are not its first ones."""
    if "bp4_span_tables" not in garr:
        n, dc, m, m_pad = garr["n"], garr["dc"], garr["m"], garr["m_pad"]
        valid = garr["cn_valid_sm"].cpu().numpy()  # [dc, m_pad]
        deg = valid.sum(axis=0)
        row_ptr = np.concatenate([[0], np.cumsum(deg[:m])])
        nnz = int(row_ptr[-1])
        ok = (max(n, nnz) <= IDX_MAX and not deg[m:].any()
              and np.array_equal(valid, np.arange(dc)[:, None] < deg[None]))
        tables = None
        if ok:
            cn_vn = garr["cn_vn_clip"].cpu().numpy().reshape(dc, m_pad)
            row_vn = cn_vn[:, :m].T[valid[:, :m].T]  # check by check, slot by slot
            vn_valid = garr["vn_valid"].cpu().numpy()
            vfc = garr["vn_from_cn_flat"].cpu().numpy().reshape(vn_valid.shape)
            slot, row = np.divmod(vfc[vn_valid], m_pad)  # variable by variable
            var_ptr = np.concatenate([[0], np.cumsum(vn_valid.sum(axis=1))])
            dev = garr["cn_valid_sm"].device
            tables = {k: torch.as_tensor(np.asarray(v, dtype=np.int16), device=dev)
                      for k, v in (("row_ptr", row_ptr), ("row_vn", row_vn),
                                   ("var_ptr", var_ptr), ("var_edge", row_ptr[row] + slot))}
            tables["nnz"] = nnz
        garr["bp4_span_tables"] = tables
    return garr["bp4_span_tables"]


def bp4_span_smem_bytes(gx, gz) -> int:
    """Dynamic shared memory of one ``bp4_span.cu`` block (one shot): its
    ``make_layout``, array by array."""
    n, rows = gx["n"], gx["m"] + gz["m"]
    nnz = bp4_span_tables(gx)["nnz"] + bp4_span_tables(gz)["nnz"]
    return sum(_align16(x) for x in (
        4 * nnz,  # messages of the valid edges
        3 * 4 * n,  # lprx, lpry, lprz
        2 * 4 * n,  # log1pexp(-lprx), log1pexp(-lprz)
        n,  # variable flags
        rows,  # check flags
        16,  # done, iters, ran, mismatch
    ))


def bp4_span_supported(gx, gz, B: int) -> bool:
    """Shape gate: both graphs' tables within int16 (``bp4_span_tables``),
    one grid's blocks, and one shot's messages, posteriors and flags within
    ``SMEM_MAX`` bytes of shared memory: [[882]] (441x882 twice) takes
    40,624 B, [[362]] (171x362 twice) 35,344 B."""
    return (
        0 < B < 2**31
        and gx["n"] == gz["n"]
        and bp4_span_tables(gx) is not None
        and bp4_span_tables(gz) is not None
        and bp4_span_smem_bytes(gx, gz) <= SMEM_MAX
    )


def bind(lib: ctypes.CDLL):
    """(library, C entry point) of a built ``bp4_span.cu``: the package's
    build, or the stage-clock probe's (``tools/torch_probe_bp4_span.py``)."""
    fn = lib.bp4_span_f32
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    graph = [p, ll, ll, ll, *[p] * 7, i, i, i, i]
    fn.argtypes = [*graph, *graph, *[p] * 11, i, ll, i, f, f, f, p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _entry():
    return bind(cuda_build.load(SOURCE))


def bp4_span(gx, gz, mvx, mvz, llr_x, llr_y, llr_z, synd_x, synd_z, vn_state, cn_x, cn_z,
             done, iters, *, num_iter: int, alpha: float = 1.0, clip: float = 50.0):
    """One ``bp4_run`` call: its arguments and results (``ops.bp4.bp4_run``).

    On CPU tensors this runs the plain loop ``ops.bp4.bp4_loop``
    (``bp4_span.plain_calls``). On CUDA tensors it launches
    ``csrc/bp4_span.cu`` once (``bp4_span.launches``), or raises where the
    gate ``bp4_span_supported`` refuses the graphs. The incoming messages
    are read as they are, at their strides (``bp4_init_messages`` gives
    stride-0 views over the batch). The syndromes and sign seeds must hold
    0/1 and are read as uint8; ``vn_state`` holds -1 or the Pauli 0-3.
    Returns contiguous tensors: messages [dc, m_pad, B] f32 with 0 at
    invalid slots (or, for a shot that never ran, the incoming values),
    posteriors [B, n] f32, errors [B, n] int8, ``done``, ``iters``.
    """
    if mvx.device.type == "cpu":
        bp4_span.plain_calls += 1
        return bp4_loop(gx, gz, mvx, mvz, llr_x, llr_y, llr_z, synd_x, synd_z, vn_state,
                        cn_x, cn_z, done, iters, num_iter=num_iter, alpha=alpha, clip=clip)
    if mvx.device.type != "cuda":
        raise ValueError(f"bp4_span: unsupported device {mvx.device}")
    out = launch(_entry(), gx, gz, mvx, mvz, llr_x, llr_y, llr_z, synd_x, synd_z, vn_state,
                 cn_x, cn_z, done, iters, num_iter=num_iter, alpha=alpha, clip=clip)
    bp4_span.launches += 1
    return out


def launch(entry, gx, gz, mvx, mvz, llr_x, llr_y, llr_z, synd_x, synd_z, vn_state, cn_x, cn_z,
           done, iters, *, num_iter: int, alpha: float, clip: float):
    """``bp4_span``'s launch on CUDA tensors through ``entry`` (``bind``'s
    pair), uncounted (the probe build's calls go through it directly):
    one block of 256 threads a shot. Raises for graphs past the gate
    ``bp4_span_supported`` before it touches the card."""
    n, B, dev = gx["n"], synd_x.shape[0], mvx.device
    if not bp4_span_supported(gx, gz, B):
        raise ValueError(f"bp4_span: unsupported graphs ({gx['m']}x{n}, {gz['m']}x{gz['n']}) "
                         f"at B={B}")
    checks = [("mvx", mvx, (gx["dc"], gx["m_pad"], B), torch.float32),
              ("mvz", mvz, (gz["dc"], gz["m_pad"], B), torch.float32),
              ("vn_state", vn_state, (B, n), torch.int8), ("done", done, (B,), torch.bool),
              ("iters", iters, (B,), torch.int32)]
    checks += [(name, t, (n,), torch.float32)
               for name, t in (("llr_x", llr_x), ("llr_y", llr_y), ("llr_z", llr_z))]
    checks += [(name, t, (B, g["m"]), t.dtype) for name, t, g in
               (("synd_x", synd_x, gx), ("synd_z", synd_z, gz), ("cn_x", cn_x, gx),
                ("cn_z", cn_z, gz))]
    for name, t, shape, dtype in checks:
        if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"bp4_span: {name} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")

    sx, sz, cx, cz = (t.to(torch.uint8).contiguous() for t in (synd_x, synd_z, cn_x, cn_z))
    vn_state, done, iters = (t.contiguous() for t in (vn_state, done, iters))
    vconst = torch.stack([llr_x, llr_y, llr_z, *bp4_initial_values(llr_x, llr_y, llr_z)])
    mv_out = [torch.empty((g["dc"], g["m_pad"], B), dtype=torch.float32, device=dev)
              for g in (gx, gz)]
    lpr = [torch.empty((B, n), dtype=torch.float32, device=dev) for _ in range(3)]
    err = [torch.empty((B, n), dtype=torch.int8, device=dev) for _ in range(2)]
    done_out, iters_out = torch.empty_like(done), torch.empty_like(iters)

    def graph(g, mv, out, synd, seed):
        t = bp4_span_tables(g)
        return [mv.data_ptr(), *mv.stride(), out.data_ptr(), synd.data_ptr(), seed.data_ptr(),
                *(t[k].data_ptr() for k in ("row_ptr", "row_vn", "var_ptr", "var_edge")),
                g["m"], g["m_pad"], g["dc"], t["nnz"]]

    lib, fn = entry
    consts = [_storage_round(x, torch.float32) for x in (alpha, clip, BIG)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(*graph(gx, mvx, mv_out[0], sx, cx), *graph(gz, mvz, mv_out[1], sz, cz),
                  vn_state.data_ptr(), vconst.data_ptr(), done.data_ptr(), done_out.data_ptr(),
                  iters.data_ptr(), iters_out.data_ptr(), *(t.data_ptr() for t in lpr),
                  *(t.data_ptr() for t in err), n, B, num_iter, *consts, stream)
    cuda_build.check(lib, code, "bp4_span kernel")
    return (*mv_out, *lpr, *err, done_out, iters_out)


bp4_span.launches = 0
bp4_span.plain_calls = 0
