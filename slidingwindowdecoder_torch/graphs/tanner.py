"""Dense-padded Tanner-graph compilation.

Converts a binary parity-check matrix into fixed-shape edge tables suitable
for batched message passing: a CN-major table (per check: its variable
neighbors, padded to the max check degree) and a VN-major table (per
variable: its check neighbors, padded to the max variable degree), plus the
two static permutations that move a flattened edge-message array between the
layouts. All shapes are static, so every batch of one graph has the same shapes.

This replaces the reference's doubly-linked
``mod2sparse`` structure (src/include/mod2sparse.h:46-107): instead of
pointer chasing per edge, message updates become masked vector ops over
[..., m, dc] / [..., n, dv] arrays and two static gathers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TannerGraph:
    m: int
    n: int
    dc: int  # max check (row) degree
    dv: int  # max variable (column) degree
    cn_vn: np.ndarray  # [m, dc] int32: VN index per check slot; n (dummy) pads
    cn_valid: np.ndarray  # [m, dc] bool
    vn_cn: np.ndarray  # [n, dv] int32: CN index per var slot; m (dummy) pads
    vn_valid: np.ndarray  # [n, dv] bool
    # flat-edge permutations; invalid slots point at the trailing dummy slot
    cn_from_vn: np.ndarray  # [m*dc] int32 indices into a [n*dv + 1] flat array
    vn_from_cn: np.ndarray  # [n*dv] int32 indices into a [m*dc + 1] flat array
    cn_degree: np.ndarray  # [m] int32
    vn_degree: np.ndarray  # [n] int32
    # slot-major tables for the BP hot loop. CN-major edge arrays live as
    # [dc, m_pad, B] (shot index fastest, so the CN kernel's reads
    # coalesce); the flatten to [dc*m_pad, B] is a free view.
    m_pad: int
    cn_vn_sm: np.ndarray  # [dc, m_pad] int32: VN per slot; n pads
    cn_valid_sm: np.ndarray  # [dc, m_pad] bool
    vn_from_cn_sm: np.ndarray  # [n, dv] int32 into [dc*m_pad] flat; OOB pads

    @property
    def num_edges(self) -> int:
        return int(self.cn_valid.sum())


def compile_graph(H: np.ndarray) -> TannerGraph:
    """Compile a dense 0/1 PCM into padded edge tables."""
    H = np.asarray(H)
    if H.ndim != 2:
        raise ValueError("PCM must be 2-D")
    H = (H != 0)
    m, n = H.shape
    cn_degree = H.sum(axis=1).astype(np.int32)
    vn_degree = H.sum(axis=0).astype(np.int32)
    dc = max(1, int(cn_degree.max(initial=0)))
    dv = max(1, int(vn_degree.max(initial=0)))

    cn_vn = np.full((m, dc), n, dtype=np.int32)
    vn_cn = np.full((n, dv), m, dtype=np.int32)
    cn_valid = np.zeros((m, dc), dtype=bool)
    vn_valid = np.zeros((n, dv), dtype=bool)
    # slot position of edge (i, j) in each layout
    cn_slot = np.full((m, n), -1, dtype=np.int32)
    vn_slot = np.full((m, n), -1, dtype=np.int32)

    for i in range(m):
        cols = np.nonzero(H[i])[0]
        cn_vn[i, : cols.size] = cols
        cn_valid[i, : cols.size] = True
        cn_slot[i, cols] = np.arange(cols.size)
    for j in range(n):
        rows = np.nonzero(H[:, j])[0]
        vn_cn[j, : rows.size] = rows
        vn_valid[j, : rows.size] = True
        vn_slot[rows, j] = np.arange(rows.size)

    rows, cols = np.nonzero(H)
    # cn-major flat index of each edge, and vn-major flat index
    cn_flat = rows * dc + cn_slot[rows, cols]
    vn_flat = cols * dv + vn_slot[rows, cols]

    cn_from_vn = np.full(m * dc, n * dv, dtype=np.int32)  # dummy pad slot
    cn_from_vn[cn_flat] = vn_flat
    vn_from_cn = np.full(n * dv, m * dc, dtype=np.int32)
    vn_from_cn[vn_flat] = cn_flat

    # at least ONE inert pad row beyond m (the JAX package's layout, kept
    # so both sides share one table set): CN-side arrays can be gathered
    # through ``vn_cn``'s dummy index m without a separate pad row
    m_pad = -(-(m + 1) // 32) * 32
    cn_vn_sm = np.full((dc, m_pad), n, dtype=np.int32)
    cn_vn_sm[:, :m] = cn_vn.T
    cn_valid_sm = np.zeros((dc, m_pad), dtype=bool)
    cn_valid_sm[:, :m] = cn_valid.T
    # slot-major flat index of edge (i, j): slot * m_pad + i
    vn_from_cn_sm = np.full((n, dv), dc * m_pad, dtype=np.int32)
    vn_from_cn_sm[cols, vn_slot[rows, cols]] = (
        cn_slot[rows, cols] * m_pad + rows
    )

    return TannerGraph(
        m=m,
        n=n,
        dc=dc,
        dv=dv,
        cn_vn=cn_vn,
        cn_valid=cn_valid,
        vn_cn=vn_cn,
        vn_valid=vn_valid,
        cn_from_vn=cn_from_vn,
        vn_from_cn=vn_from_cn,
        cn_degree=cn_degree,
        vn_degree=vn_degree,
        m_pad=m_pad,
        cn_vn_sm=cn_vn_sm,
        cn_valid_sm=cn_valid_sm,
        vn_from_cn_sm=vn_from_cn_sm,
    )


def vn_incidence_host(graph: TannerGraph) -> np.ndarray:
    """Dense 0/1 VN-incidence over slot-major flat edges: A[v, s*m_pad+i]
    = 1 iff check-slot (s, i) is a valid edge of VN v.

    ``A @ mc_flat`` is then the per-VN sum of incoming CN messages. The
    port keeps it only as the JAX ``posterior_matmul`` form for the CPU
    tests' comparison: at B=16384 the dense product costs ~443 GFLOP per
    BP iteration, where the gather sums ~6 edges per VN."""
    A = np.zeros((graph.n, graph.dc * graph.m_pad), dtype=np.float32)
    s, i = np.nonzero(graph.cn_valid_sm)
    A[graph.cn_vn_sm[s, i], s * graph.m_pad + i] = 1.0
    return A


def graph_tensors(graph: TannerGraph, device=None):
    """The static tables consumed by the BP and OSD code, as torch tensors.

    The same numpy tables the JAX package turns into device arrays, moved
    to ``device`` (default ``"cuda"``; raises when no card is present).
    ``cn_vn_clip`` and ``vn_from_cn_flat`` are the gather indices of the
    BP iteration. They reproduce the JAX ``take`` semantics as plain
    in-bounds gathers: the posterior gather (``mode="clip"``) clamps the
    pad index n to n - 1, and the message gather (``mode="fill"``) reads
    its pad index dc*m_pad from one trailing zero row of the source.
    ``cn_valid``, ``vn_cn``, ``vn_valid``, ``cn_degree``, ``vn_cn_cols``
    and ``cn_vn_fill`` are the tables of the decimation ops
    (``ops.decimation``); GDG reads ``vn_degree``.
    """
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    n, dc, m_pad = graph.n, graph.dc, graph.m_pad
    cn_vn_flat = graph.cn_vn_sm.reshape(-1).astype(np.int64)
    return {
        "cn_vn": t(graph.cn_vn),  # [m, dc], pad n
        "cn_valid": t(graph.cn_valid),  # [m, dc]
        "vn_cn": t(graph.vn_cn),  # [n, dv], pad m
        "vn_valid": t(graph.vn_valid),  # [n, dv]
        "cn_degree": t(graph.cn_degree),  # [m]
        "vn_degree": t(graph.vn_degree),  # [n]
        # the transposed decimation's gathers: per VN slot, the check (index
        # m reads a pad row); per check slot, the VN (index n reads a zero
        # row appended to the source)
        "vn_cn_cols": t(graph.vn_cn.T.astype(np.int64)),  # [dv, n]
        "cn_vn_fill": t(cn_vn_flat),  # [dc*m_pad]
        "cn_valid_sm": t(graph.cn_valid_sm),  # [dc, m_pad]
        "cn_vn_clip": t(np.minimum(cn_vn_flat, n - 1)),  # [dc*m_pad]
        # message gather: index dc*m_pad is the zero fill row
        "vn_from_cn_flat": t(graph.vn_from_cn_sm.reshape(-1).astype(np.int64)),
        "n": n,
        "m": graph.m,
        "dc": dc,
        "dv": graph.dv,
        "m_pad": m_pad,
    }
