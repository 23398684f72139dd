"""Wrapper of the hand-written CUDA kernel that decides and peels (``csrc/peel.cu``).

``peel_fixpoint`` applies one decision as the JAX package's
``vn_set_values`` / ``vn_set_values_t`` does (a mask with values, or a VN
index, a value and a do-set flag a column, or none) and then runs
degree-1 check forcing to the fixpoint of its ``peel`` / ``peel_t``
while-loops, on the card, in one cooperative launch with no host read: one
warp a column, the column's state in shared memory for the decision and
all its sweeps; the columns that die while still forcing pause, and after
one grid barrier the grid's warps carry them on to the batch's sweep
count. Its plain version is ``ops.decimation``'s ``vn_set_values(_t)``
followed by ``_peel_loop``, which ``ops.decimation`` runs on CPU tensors;
on CUDA tensors it calls this wrapper, which launches the kernel or raises.

Counters: ``peel_fixpoint.launches`` (calls that launched the kernel),
``.decide_launches`` (those of them that applied a decision) and
``.plain_calls`` (the plain versions' calls, counted by
``ops.decimation``); ``sweep_stats(device)`` is a device tensor [2]
(int64) to which every call adds the batch's sweeps and the column-sweeps
its warps ran. Only a caller that wants them reads it (a host read).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..utils import cuda_build
from .bp_cuda import SMEM_MAX, _align16

SOURCE = "peel.cu"
MAX_COLS = 32  # columns (warps) a block in the transposed layout, csrc/peel.cu:kMaxCols
BATCH_MAJOR_COLS = 4  # a column is contiguous there: small blocks spread over the SMs
SMEM_BUDGET = SMEM_MAX - 1024  # csrc/peel.cu:kMaxSmem
MAX_DC = 255  # a check's 8-bit delta fields
HEADER = 8  # scratch words before the paused list, csrc/peel.cu:kHeader
INT32_MAX = 2**31 - 1
_stats: dict[torch.device, torch.Tensor] = {}
_scratch: dict[tuple[torch.device, int], torch.Tensor] = {}


def smem_per_column(n: int, rows: int) -> int:
    """Shared memory of one column (``make_layout`` in ``peel.cu``): its
    int8 VN states, 2-bit force fields, int8 check states, int32 degrees
    and 16-bit deltas, and 4 bytes that set columns an odd number of words
    apart (no bank conflicts)."""
    return (_align16(n) + _align16(4 * ((n + 15) // 16)) + _align16(rows) + _align16(4 * rows)
            + _align16(4 * ((rows + 1) // 2)) + 4)


def columns_per_block(n: int, rows: int, transposed: bool) -> int:
    """Columns a block holds, a power of two: ``MAX_COLS`` in the
    transposed layout (a warp's int8 row a whole 32-byte sector),
    ``BATCH_MAJOR_COLS`` in the batch-major one, halved until they fit in
    shared memory (0: not one)."""
    cols = MAX_COLS if transposed else BATCH_MAJOR_COLS
    while cols and cols * smem_per_column(n, rows) > SMEM_BUDGET:
        cols //= 2
    return cols


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


def _scratch_for(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    """The kernel's scratch for calls on one stream: ``HEADER`` counters
    and the paused list of up to ``B`` columns, zero between calls (the
    kernel leaves it so); made once, and anew only for a larger batch."""
    buf = _scratch.get((dev, stream))
    if buf is None or buf.numel() < HEADER + 2 * B:
        buf = torch.zeros(HEADER + 2 * B, dtype=torch.int32, device=dev)
        _scratch[dev, stream] = buf
    return buf


@functools.cache
def _entry():
    lib = cuda_build.load(SOURCE)
    fn = lib.peel_run
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [*[p] * 8, i, *[p] * 7, i, i, i, i, i, ll, i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return lib, fn


_BYTE = (torch.bool, torch.int8, torch.uint8)


def _check(name, t, dev, shape, dtypes):
    if t.device != dev or tuple(t.shape) != shape or t.dtype not in dtypes:
        raise ValueError(f"peel_fixpoint: {name} must be {dtypes} {shape} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def peel_fixpoint(garr, vn, cn, deg, dead, *, transposed: bool, max_sweeps: int | None = None,
                  set_mask=None, values=None, index=None, value=None, do_set=None):
    """A decision, then the peel of ``ops.decimation.peel`` (``transposed``
    False: vn [B, n], cn and deg [B, m]) or ``peel_t`` (True: vn [n, B],
    cn and deg [m_pad, B] with inert pad rows), on CUDA tensors: vn and cn
    int8, deg int32, dead bool [B]. The decision is ``set_mask`` with
    ``values`` (both in vn's layout, bool or 0/1 bytes; ``values`` None:
    all 0), as ``vn_set_values(_t)`` takes them; or ``index`` [B] (int64 or
    int32), ``value`` [B] and ``do_set`` [B] bool, the one-hot ``(VN ==
    index) & do_set`` with ``value`` broadcast; or none. Returns new
    tensors (vn, cn, deg, dead); the inputs are not written. ``max_sweeps``
    caps the batch's sweeps as JAX's loop does (the first sweep always
    runs). Raises for other devices, dtypes or shapes, for both decision
    forms at once, and for graphs one column of whose state exceeds shared
    memory or whose checks exceed ``MAX_DC`` neighbours."""
    dev = vn.device
    if dev.type != "cuda":
        raise ValueError(f"peel_fixpoint: unsupported device {dev}")
    n, m = garr["n"], garr["m"]
    rows = garr["m_pad"] if transposed else m
    B = vn.shape[1] if transposed else vn.shape[0]
    vshape = (n, B) if transposed else (B, n)
    cshape = (rows, B) if transposed else (B, rows)
    _check("vn", vn, dev, vshape, (torch.int8,))
    _check("cn", cn, dev, cshape, (torch.int8,))
    _check("deg", deg, dev, cshape, (torch.int32,))
    _check("dead", dead, dev, (B,), (torch.bool,))
    mode = 0
    if set_mask is not None:
        if index is not None:
            raise ValueError("peel_fixpoint: a mask decision or an index one, not both")
        mode = 1
        _check("set_mask", set_mask, dev, vshape, _BYTE)
        if values is not None:
            _check("values", values, dev, vshape, _BYTE)
            values = values.contiguous()
        set_mask = set_mask.contiguous()
    elif index is not None:
        mode = 2
        _check("index", index, dev, (B,), (torch.int64, torch.int32))
        _check("value", value, dev, (B,), _BYTE)
        _check("do_set", do_set, dev, (B,), (torch.bool,))
        index = index.to(torch.int64).contiguous()
        value, do_set = value.contiguous(), do_set.contiguous()
    if garr["dc"] > MAX_DC:
        raise ValueError(f"peel_fixpoint: check degree {garr['dc']} > {MAX_DC}")
    cols = columns_per_block(n, rows, transposed)
    if not cols:
        raise ValueError(f"peel_fixpoint: one column of a {rows}x{n} graph exceeds shared "
                         f"memory ({smem_per_column(n, rows)} B)")
    vn, cn, deg, dead = (t.contiguous() for t in (vn, cn, deg, dead))
    out = [torch.empty_like(t) for t in (vn, cn, deg, dead)]
    if B == 0:
        return tuple(out)
    cap = INT32_MAX if max_sweeps is None else min(max(1, int(max_sweeps)), INT32_MAX)
    cn_vn, vn_cn = peel_tables(garr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch_for(dev, stream, B)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib, fn = _entry()
    same = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        code = fn(vn.data_ptr(), cn.data_ptr(), deg.data_ptr(), dead.data_ptr(),
                  *(t.data_ptr() for t in out), mode, ptr(set_mask), ptr(values), ptr(index),
                  ptr(value), ptr(do_set), cn_vn.data_ptr(), vn_cn.data_ptr(), n, m, rows,
                  garr["dc"], garr["dv"], B, int(transposed), cap, cols.bit_length() - 1,
                  scratch.data_ptr(), sweep_stats(dev).data_ptr(), stream)
    cuda_build.check(lib, code, "peel kernel")
    peel_fixpoint.launches += 1
    peel_fixpoint.decide_launches += mode != 0
    return tuple(out)


peel_fixpoint.launches = 0
peel_fixpoint.decide_launches = 0
peel_fixpoint.plain_calls = 0
