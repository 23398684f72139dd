"""Wrappers of the hand-written CUDA kernel of OSD (``csrc/gauss_jordan.cu``).

The counterpart of the JAX package's ``ops/gf2_pallas.py``: the batched
reliability-ordered GF(2) elimination of OSD, and the OSD-CS sweep fused
onto it. One kernel template, two entry points:

- ``gauss_jordan_key``: the elimination alone, with float keys. It serves
  both forms of the JAX package: the float-keyed elimination
  (``ops/gf2_solve.py:ordered_gauss_jordan_key``) and the integer-order
  form of the Pallas kernel (``gauss_jordan_order``, whose order becomes
  rank-position keys). Plain version ``ops.gf2_solve.
  ordered_gauss_jordan_key``.
- ``osd_cs_fused``: the elimination and the OSD-CS sweep in one launch, the
  reduced state never leaving shared memory. Plain version
  ``ordered_gauss_jordan_key`` followed by ``ops.gf2_solve.
  _osd_sweep_cs_sortless``.

Each entry point has two routes on the card. A shot whose state fits one
block (``gj_cuda_supported``: the sliding windows of [[144]], the [[882]]
code-capacity PCM) runs one block per shot; a larger one (a [[288]] W=4
window, the [[144]] global DEM) runs one thread-block cluster of C blocks
per shot, its rows split among the blocks (``gj_cluster_supported``); a
shape that fits neither raises. Both routes compute the same bits.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from .gf2_solve import _osd_sweep_cs_sortless, gj_outputs, ordered_gauss_jordan_key

SOURCE = "gauss_jordan.cu"
MAX_SMEM = 232_448  # bytes of shared memory a block can use on an H100
# the kernel's constants (csrc/gauss_jordan.cu): warps per block, 32-row
# words of the unused-row mask, 32-word chunks of a row a lane holds, the
# most columns of the OSD-CS pairs
WARPS, ROW_WORDS, ROW_CHUNKS, MAX_ORDER_W = 8, 16, 4, 32
MAX_COLUMNS = 32 * (32 * ROW_CHUNKS - 1)  # W + 1 packed words per row


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def smem_layout(m: int, n: int, W: int, fused: bool = False) -> dict[str, int]:
    """Bytes of each shared-memory array of one block (one shot), in the
    order of the kernel's ``make_layout``."""
    arrays = {
        # the sort's (key, column) pairs first, then the packed state
        "state": max(m * (W + 1) * 4, _next_pow2(n) * 8),
        "sorted_order": 2 * n,
        "pivot_columns": 2 * m,
        "pivot_rows": 2 * m,
        "candidate_tests": 2 * WARPS * (ROW_WORDS + 1) * 4,
    }
    if fused:
        arrays.update(column_sums=4 * n, row_weights=4 * m, column_masks=3 * W * 4)
    return arrays


def smem_bytes(m: int, n: int, W: int, fused: bool = False) -> int:
    """Dynamic shared memory of one block: ``smem_layout``, each array
    aligned to 16 bytes."""
    return sum(_align16(x) for x in smem_layout(m, n, W, fused).values())


def gj_cuda_supported(m: int, n: int, W: int, fused: bool = False) -> bool:
    """Shape gate: at most ``32 * ROW_WORDS`` rows and ``MAX_COLUMNS``
    columns, and one shot's arrays within a block's shared memory. The
    flagship windows (216x1728) need 52,928 bytes, 61,360 fused."""
    return (m <= 32 * ROW_WORDS and n <= MAX_COLUMNS
            and smem_bytes(m, n, W, fused) <= MAX_SMEM)


# the cluster route: blocks per shot it takes (8 is the portable cluster
# size), the most weight-2 pairs of its fused sweep, the candidates a round
# tests, and the most words from one row of a block's state to the next
CLUSTER_SIZES = (2, 4, 8)
MAX_PAIRS = MAX_ORDER_W * (MAX_ORDER_W - 1) // 2
ROUND_CANDIDATES = 2 * WARPS
MAX_CLUSTER_STRIDE = 512


def cluster_rows(m: int, C: int) -> int:
    """Rows of the state each block of a C-block cluster holds (the last
    blocks may hold fewer)."""
    return -(-m // C)


def cluster_stride(W: int) -> int:
    """Words from one row of a cluster block's state to the next: W + 1
    rounded up to a multiple of 4 (every row starts on 16 bytes)."""
    return (W + 4) // 4 * 4


def cluster_smem_layout(m: int, n: int, W: int, C: int, fused: bool = False) -> dict[str, int]:
    """Bytes of each shared-memory array of one block of a C-block cluster,
    in the order of the kernel's ``make_cluster_layout``."""
    R = cluster_rows(m, C)
    arrays = {
        # the sort's pairs first, then the block's rows of the state
        "state": max(R * cluster_stride(W) * 4, _next_pow2(n) * 8),
        "sorted_order": 2 * n,
        "pivot_columns": 2 * m,
        "pivot_rows": 2 * m,
        "round_posts": 2 * CLUSTER_SIZES[-1] * ROUND_CANDIDATES * 4,
        "holding_masks": ROUND_CANDIDATES * ROW_WORDS * 4,
    }
    if fused:
        arrays.update(column_sums=4 * n, pair_sums=4 * MAX_PAIRS, row_weights=4 * R,
                      column_masks=4 * W * 4)
    return arrays


def cluster_smem_bytes(m: int, n: int, W: int, C: int, fused: bool = False) -> int:
    """Dynamic shared memory of one cluster block: ``cluster_smem_layout``,
    each array aligned to 16 bytes."""
    return sum(_align16(x) for x in cluster_smem_layout(m, n, W, C, fused).values())


def _cluster_fits(m: int, n: int, W: int, C: int, fused: bool) -> bool:
    return (C in CLUSTER_SIZES and max(m, n) <= 65536
            and cluster_rows(m, C) <= 32 * ROW_WORDS
            and cluster_stride(W) <= MAX_CLUSTER_STRIDE
            and cluster_smem_bytes(m, n, W, C, fused) <= MAX_SMEM)


def gj_cluster_supported(m: int, n: int, W: int, fused: bool = False) -> int:
    """Shape gate of the cluster route: the least C of ``CLUSTER_SIZES``
    whose blocks each hold their ``cluster_rows`` (at most ``32 *
    ROW_WORDS``, each at most ``MAX_CLUSTER_STRIDE`` words: a lane holds
    four 16-byte chunks of the pivot row) and arrays within ``MAX_SMEM``;
    0 if none does. A [[288]]
    W=4 window (576x4896) takes C=2 and the [[144]] global DEM (936x8784)
    C=8."""
    return next((C for C in CLUSTER_SIZES if _cluster_fits(m, n, W, C, fused)), 0)


def gj_route(m: int, n: int, W: int, fused: bool = False, cluster_blocks: int | None = None,
             what: str = "kernel B") -> int:
    """The route a CUDA call takes: 0 for the single-block route, else the
    blocks per shot of the cluster route; raises for a shape neither takes.
    ``cluster_blocks`` forces the cluster route with that many blocks (to
    check it at small shapes)."""
    if cluster_blocks is not None:
        if not _cluster_fits(m, n, W, cluster_blocks, fused):
            raise ValueError(f"{what}: {m}x{n} does not fit clusters of {cluster_blocks} "
                             f"blocks (C in {CLUSTER_SIZES})")
        return cluster_blocks
    if gj_cuda_supported(m, n, W, fused):
        return 0
    C = gj_cluster_supported(m, n, W, fused)
    if not C:
        raise ValueError(
            f"{what}: {m}x{n} outside both routes' gates (one block: "
            f"{smem_bytes(m, n, W, fused)} bytes of shared memory per shot, at most "
            f"{MAX_SMEM}, {32 * ROW_WORDS} rows and {MAX_COLUMNS} columns; a cluster of "
            f"{CLUSTER_SIZES[-1]}: {cluster_smem_bytes(m, n, W, CLUSTER_SIZES[-1], fused)} "
            f"bytes a block)"
        )
    return C


@functools.cache
def _entry(name: str):
    """(library, C entry point) of the kernel."""
    lib = cuda_build.load(SOURCE)
    fn = getattr(lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        "gauss_jordan_key": [p] * 7 + [i] * 5 + [p],
        "osd_cs_fused": [p] * 10 + [i] * 7 + [p],
        "gauss_jordan_key_cluster": [p] * 7 + [i] * 6 + [p],
        "osd_cs_fused_cluster": [p] * 10 + [i] * 8 + [p],
    }[name]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(what, H_words, syndrome, key, *, m, n, rank):
    """Device, dtype and shape checks of a CUDA call; returns W."""
    dev = syndrome.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    B = syndrome.shape[0]
    W = -(-n // 32)
    if (
        H_words.device != dev or H_words.dtype != torch.int32
        or tuple(H_words.shape) != (m, W)
    ):
        raise ValueError(
            f"{what}: H_words must be int32 [{m}, {W}] on {dev}, "
            f"got {H_words.dtype} {tuple(H_words.shape)} on {H_words.device}"
        )
    if tuple(syndrome.shape) != (B, m) or syndrome.dtype.is_floating_point:
        raise ValueError(f"{what}: syndrome must be integer [B, {m}]")
    if key.device != dev or key.dtype != torch.float32 or tuple(key.shape) != (B, n):
        raise ValueError(
            f"{what}: key must be float32 [{B}, {n}] on {dev}, "
            f"got {key.dtype} {tuple(key.shape)} on {key.device}"
        )
    if not 0 <= rank <= m:
        raise ValueError(f"{what}: rank {rank} outside [0, {m}]")
    return W


def gauss_jordan_key(H_words, syndrome, key, *, m: int, n: int, rank: int,
                     cluster_blocks: int | None = None):
    """Reliability-ordered Gauss-Jordan with float keys.

    H_words: [m, W] int32 packed PCM rows; syndrome: [B, m] 0/1 (any
    integer dtype); key: [B, n] float32, smaller = tried first, ties to the
    lower column; ``rank`` the PCM's GF(2) rank. Returns the dict of
    ``ops.gf2_solve.gj_outputs``. ``cluster_blocks`` forces the cluster
    route (see ``gj_route``). ``gauss_jordan_key.launches`` counts launches
    of the single-block route, ``.cluster_launches`` those of the cluster
    route, ``.plain_calls`` the calls that ran the plain version.
    """
    if syndrome.device.type == "cpu":
        gauss_jordan_key.plain_calls += 1
        return ordered_gauss_jordan_key(H_words, syndrome, key, m=m, n=n, rank=rank)
    W = _check_inputs("gauss_jordan_key", H_words, syndrome, key, m=m, n=n, rank=rank)
    C = gj_route(m, n, W, False, cluster_blocks, "gauss_jordan_key")
    dev, B = syndrome.device, syndrome.shape[0]
    H_words = H_words.contiguous()
    synd_u8 = syndrome.to(torch.uint8).contiguous()
    key = key.contiguous()
    state = torch.empty((B, m, W + 1), dtype=torch.int32, device=dev)
    pcol = torch.empty((B, rank), dtype=torch.int32, device=dev)
    prow = torch.empty((B, rank), dtype=torch.int32, device=dev)
    incons = torch.empty((B,), dtype=torch.uint8, device=dev)
    lib, fn = _entry("gauss_jordan_key_cluster" if C else "gauss_jordan_key")
    with torch.cuda.device(dev):
        code = fn(
            H_words.data_ptr(), synd_u8.data_ptr(), key.data_ptr(),
            state.data_ptr(), pcol.data_ptr(), prow.data_ptr(), incons.data_ptr(),
            m, n, W, rank, B, *((C,) if C else ()),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, code, "gauss_jordan_key kernel")
    if C:
        gauss_jordan_key.cluster_launches += 1
    else:
        gauss_jordan_key.launches += 1
    return gj_outputs(state.permute(1, 2, 0), pcol.T, prow.T, incons, n=n)


gauss_jordan_key.launches = 0
gauss_jordan_key.cluster_launches = 0
gauss_jordan_key.plain_calls = 0


def osd_cs_fused(H_words, syndrome, key, channel_llr, pair_i, pair_j, *, m: int, n: int,
                 rank: int, order_w: int, cluster_blocks: int | None = None):
    """OSD-CS: the elimination by ``key`` and the sweep of its candidates.

    The arguments of ``gauss_jordan_key``, with ``channel_llr`` [n] f32
    (1-D: the kernel takes one prior for every shot), the weight-2 pairs
    ``pair_i``/``pair_j`` [P] (indices into the ``order_w`` most unreliable
    non-pivot columns) and ``order_w``. Returns solution [B, n] uint8,
    osd0 [B, n] uint8, min_pm [B] f32 and inconsistent [B] bool, the dict
    of ``ops.gf2_solve.osd_decode``. ``cluster_blocks`` forces the cluster
    route (see ``gj_route``). ``osd_cs_fused.launches`` counts launches of the
    single-block route, ``.cluster_launches`` those of the cluster route,
    ``.plain_calls`` the calls that ran the plain version (CPU tensors).
    """
    dev = syndrome.device
    if dev.type == "cpu":
        osd_cs_fused.plain_calls += 1
        gj = ordered_gauss_jordan_key(H_words, syndrome, key, m=m, n=n, rank=rank)
        solution, min_pm = _osd_sweep_cs_sortless(gj, key, channel_llr, pair_i, pair_j,
                                                  order_w=order_w)
        return {"solution": solution, "osd0": gj["osd0"], "min_pm": min_pm,
                "inconsistent": gj["inconsistent"]}
    W = _check_inputs("osd_cs_fused", H_words, syndrome, key, m=m, n=n, rank=rank)
    C = gj_route(m, n, W, True, cluster_blocks, "osd_cs_fused")
    llr = torch.as_tensor(channel_llr)
    if llr.device != dev or llr.dtype != torch.float32 or tuple(llr.shape) != (n,):
        raise ValueError(
            f"osd_cs_fused: channel_llr must be float32 [{n}] on {dev}, got "
            f"{llr.dtype} {tuple(llr.shape)} on {llr.device}"
        )
    pair_i = torch.as_tensor(pair_i, dtype=torch.int32, device=dev).contiguous()
    pair_j = torch.as_tensor(pair_j, dtype=torch.int32, device=dev).contiguous()
    if (not 0 <= order_w <= min(MAX_ORDER_W, n - rank) or pair_i.shape != pair_j.shape
            or pair_i.shape[0] > MAX_PAIRS):
        raise ValueError(
            f"osd_cs_fused: order_w {order_w} outside [0, min({MAX_ORDER_W}, n - rank = "
            f"{n - rank})], or pairs of unequal shapes or more than {MAX_PAIRS}"
        )
    B = syndrome.shape[0]
    H_words = H_words.contiguous()
    synd_u8 = syndrome.to(torch.uint8).contiguous()
    key, llr = key.contiguous(), llr.contiguous()
    solution = torch.empty((B, n), dtype=torch.uint8, device=dev)
    osd0 = torch.empty((B, n), dtype=torch.uint8, device=dev)
    min_pm = torch.empty((B,), dtype=torch.float32, device=dev)
    incons = torch.empty((B,), dtype=torch.uint8, device=dev)
    lib, fn = _entry("osd_cs_fused_cluster" if C else "osd_cs_fused")
    with torch.cuda.device(dev):
        code = fn(
            H_words.data_ptr(), synd_u8.data_ptr(), key.data_ptr(), llr.data_ptr(),
            pair_i.data_ptr(), pair_j.data_ptr(), solution.data_ptr(), osd0.data_ptr(),
            min_pm.data_ptr(), incons.data_ptr(), m, n, W, rank, order_w,
            pair_i.shape[0], B, *((C,) if C else ()),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, code, "osd_cs_fused kernel")
    if C:
        osd_cs_fused.cluster_launches += 1
    else:
        osd_cs_fused.launches += 1
    return {"solution": solution, "osd0": osd0, "min_pm": min_pm,
            "inconsistent": incons.bool()}


osd_cs_fused.launches = 0
osd_cs_fused.cluster_launches = 0
osd_cs_fused.plain_calls = 0


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
