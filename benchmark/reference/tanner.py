"""Padded Tanner-graph tables of a parity-check matrix, for the reference.

A frozen copy of ``slidingwindowdecoder_torch/graphs/tanner.py``
(``compile_graph``, ``graph_tensors``) at commit 6c64bcc, trimmed to the
tables the plain BP and decimation below read: a check-major table padded
to the largest check degree, a variable-major one padded to the largest
variable degree, and the slot-major [dc, m_pad] layout of the check side
with at least one inert pad row.
"""

from __future__ import annotations

import numpy as np
import torch


def graph_tables(H, device) -> dict:
    H = np.asarray(H) != 0
    m, n = H.shape
    cn_degree = H.sum(axis=1).astype(np.int32)
    vn_degree = H.sum(axis=0).astype(np.int32)
    dc = max(1, int(cn_degree.max(initial=0)))
    dv = max(1, int(vn_degree.max(initial=0)))
    cn_vn = np.full((m, dc), n, dtype=np.int32)
    vn_cn = np.full((n, dv), m, dtype=np.int32)
    cn_valid = np.zeros((m, dc), dtype=bool)
    vn_valid = np.zeros((n, dv), dtype=bool)
    cn_slot = np.full((m, n), -1, dtype=np.int32)
    vn_slot = np.full((m, n), -1, dtype=np.int32)
    for i in range(m):
        cols = np.nonzero(H[i])[0]
        cn_vn[i, :cols.size] = cols
        cn_valid[i, :cols.size] = True
        cn_slot[i, cols] = np.arange(cols.size)
    for j in range(n):
        rows = np.nonzero(H[:, j])[0]
        vn_cn[j, :rows.size] = rows
        vn_valid[j, :rows.size] = True
        vn_slot[rows, j] = np.arange(rows.size)
    rows, cols = np.nonzero(H)
    m_pad = -(-(m + 1) // 32) * 32
    cn_vn_sm = np.full((dc, m_pad), n, dtype=np.int32)
    cn_vn_sm[:, :m] = cn_vn.T
    cn_valid_sm = np.zeros((dc, m_pad), dtype=bool)
    cn_valid_sm[:, :m] = cn_valid.T
    # slot-major flat index of edge (i, j): slot * m_pad + i; the pad index
    # dc * m_pad reads a zero row appended to the messages
    vn_from_cn_sm = np.full((n, dv), dc * m_pad, dtype=np.int32)
    vn_from_cn_sm[cols, vn_slot[rows, cols]] = cn_slot[rows, cols] * m_pad + rows
    cn_vn_flat = cn_vn_sm.reshape(-1).astype(np.int64)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return {
        "n": n, "m": m, "dc": dc, "dv": dv, "m_pad": m_pad,
        "edges": int(cn_valid.sum()),
        "cn_vn": t(cn_vn), "cn_valid": t(cn_valid),
        "vn_cn": t(vn_cn), "vn_valid": t(vn_valid),
        "cn_degree": t(cn_degree), "vn_degree": t(vn_degree),
        "vn_cn_cols": t(vn_cn.T.astype(np.int64)),
        "cn_vn_fill": t(cn_vn_flat),
        "cn_valid_sm": t(cn_valid_sm),
        "cn_vn_clip": t(np.minimum(cn_vn_flat, n - 1)),
        "vn_from_cn_flat": t(vn_from_cn_sm.reshape(-1).astype(np.int64)),
    }
