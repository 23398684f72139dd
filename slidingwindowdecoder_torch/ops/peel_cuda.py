"""Wrapper of the hand-written CUDA kernel of the peel (``csrc/peel.cu``).

``peel_fixpoint`` runs degree-1 check forcing to the fixpoint of the JAX
package's ``peel`` / ``peel_t`` while-loops on the card: one warp a column,
the column's state in shared memory for all its sweeps, and two launches
of one kernel on the stream with no host read in between (the first runs
each column to its own fixpoint or death and takes the batch's sweep
count on the card; the second carries the dead columns on to it). Its
plain version is ``ops.decimation._peel_loop``, which
``ops.decimation.peel`` / ``peel_t`` run on CPU tensors; on CUDA tensors
they call this wrapper, which launches the kernel or raises.

Counters: ``peel_fixpoint.launches`` (calls that launched the kernel's two
passes) and ``.plain_calls`` (the plain loops' calls, counted by
``ops.decimation``); ``sweep_stats(device)`` is a device tensor [2]
(int64) to which every call adds the batch's sweeps and the column-sweeps
its warps ran. Only a caller that wants them reads it (a host read).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .bp_cuda import SMEM_MAX, _align16

SOURCE = "peel.cu"
MAX_COLS = 8  # columns (warps) a block, csrc/peel.cu:kMaxCols
INT32_MAX = 2**31 - 1
_stats: dict[torch.device, torch.Tensor] = {}


def smem_per_column(n: int, rows: int) -> int:
    """Shared memory of one column (``make_layout`` in ``peel.cu``): its
    VN states and packed force bytes, its check states, int32 degrees and
    int32 deltas."""
    r4 = (n + 3) & ~3
    return _align16(r4) + _align16(r4) + _align16(rows) + 2 * _align16(4 * rows)


def columns_per_block(n: int, rows: int) -> int:
    """Columns a block holds: ``MAX_COLS``, or as many as fit in shared
    memory (0: not one)."""
    return min(MAX_COLS, SMEM_MAX // smem_per_column(n, rows))


def peel_tables(garr):
    """The kernel's int32 tables, made once on the graph's device and kept
    in ``garr`` (device-side casts, no host read): ``cn_vn`` [m, dc] (pad
    n) and ``vn_cn`` [n, dv] (pad m)."""
    if "peel_tables" not in garr:
        garr["peel_tables"] = (garr["cn_vn"].to(torch.int32).contiguous(),
                               garr["vn_cn"].to(torch.int32).contiguous())
    return garr["peel_tables"]


def sweep_stats(device) -> torch.Tensor:
    """The device counter [2] int64 of ``device``: the batch sweeps and the
    column-sweeps of every call so far."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _stats:
        _stats[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return _stats[dev]


@functools.cache
def _entry():
    lib = cuda_build.load(SOURCE)
    fn = lib.peel_run
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [*[p] * 10, i, i, i, i, i, ll, i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return lib, fn


def peel_fixpoint(garr, vn, cn, deg, dead, *, transposed: bool, max_sweeps: int | None = None):
    """The peel of ``ops.decimation.peel`` (``transposed`` False: vn [B, n],
    cn and deg [B, m]) or ``peel_t`` (True: vn [n, B], cn and deg [m_pad,
    B] with inert pad rows), on CUDA tensors: vn and cn int8, deg int32,
    dead bool [B]. Returns new tensors (vn, cn, deg, dead); the inputs are
    not written. ``max_sweeps`` caps the batch's sweeps as JAX's loop does
    (the first sweep always runs). Raises for other devices, dtypes or
    shapes, and for graphs one column of whose state exceeds shared
    memory."""
    dev = vn.device
    if dev.type != "cuda":
        raise ValueError(f"peel_fixpoint: unsupported device {dev}")
    n, m = garr["n"], garr["m"]
    rows = garr["m_pad"] if transposed else m
    B = vn.shape[1] if transposed else vn.shape[0]
    shape = (lambda r: (r, B)) if transposed else (lambda r: (B, r))
    for name, t, want, dtype in (("vn", vn, shape(n), torch.int8),
                                 ("cn", cn, shape(rows), torch.int8),
                                 ("deg", deg, shape(rows), torch.int32),
                                 ("dead", dead, (B,), torch.bool)):
        if t.device != dev or tuple(t.shape) != want or t.dtype != dtype:
            raise ValueError(f"peel_fixpoint: {name} must be {dtype} {want} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    cols = columns_per_block(n, rows)
    if not cols:
        raise ValueError(f"peel_fixpoint: one column of a {rows}x{n} graph exceeds shared "
                         f"memory ({smem_per_column(n, rows)} B)")
    vn, cn, deg, dead = (t.contiguous() for t in (vn, cn, deg, dead))
    out = [torch.empty_like(t) for t in (vn, cn, deg, dead)]
    if B == 0:
        return tuple(out)
    cap = INT32_MAX if max_sweeps is None else min(max(1, int(max_sweeps)), INT32_MAX)
    cn_vn, vn_cn = peel_tables(garr)
    status = torch.empty((B,), dtype=torch.int32, device=dev)
    S = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(vn.data_ptr(), cn.data_ptr(), deg.data_ptr(), dead.data_ptr(),
                  *(t.data_ptr() for t in out), cn_vn.data_ptr(), vn_cn.data_ptr(), n, m,
                  rows, garr["dc"], garr["dv"], B, int(transposed), cap, cols,
                  status.data_ptr(), S.data_ptr(), sweep_stats(dev).data_ptr(), stream)
    cuda_build.check(lib, code, "peel kernel")
    peel_fixpoint.launches += 1
    return tuple(out)


peel_fixpoint.launches = 0
peel_fixpoint.plain_calls = 0
