"""Plain ordered-statistics decoding (OSD-CS) for the reference.

A frozen copy of the plain versions in
``slidingwindowdecoder_torch/ops/gf2_solve.py`` at commit 6c64bcc
(``pack_rows_host``, ``gf2_rank_packed``, the OSD-CS candidate layout,
``ordered_gauss_jordan_key``, ``gj_outputs``, ``_osd_sweep_cs_sortless``
and their helpers): the reliability-ordered Gauss-Jordan elimination over
row-packed int32 words (pivot = the live column of least key, ties to the
lower column), then every weight-1 flip of a non-pivot column and every
pair among the ``order`` least reliable ones, each path metric summed in
float32 in one stated order, the least taken where it beats OSD-0.
"""

from __future__ import annotations

import numpy as np
import torch

_W = 32


def pack_rows(H) -> np.ndarray:
    H = (np.asarray(H) != 0).astype(np.uint8)
    m, n = H.shape
    W = -(-n // _W)
    padded = np.zeros((m, W * _W), dtype=np.uint8)
    padded[:, :n] = H
    bits = padded.reshape(m, W, _W).astype(np.uint32)
    return (bits * (np.uint32(1) << np.arange(_W, dtype=np.uint32))).sum(axis=2,
                                                                            dtype=np.uint32)


def gf2_rank(H) -> int:
    rows = [int("".join(map(str, r[::-1])), 2) for r in (np.asarray(H) != 0).astype(np.uint8)]
    rank = 0
    for j in range(np.asarray(H).shape[1]):
        bit = 1 << j
        hit = next((i for i in range(rank, len(rows)) if rows[i] & bit), None)
        if hit is None:
            continue
        rows[rank], rows[hit] = rows[hit], rows[rank]
        for i in range(len(rows)):
            if i != rank and rows[i] & bit:
                rows[i] ^= rows[rank]
        rank += 1
    return rank


def cs_pairs(order: int):
    """The weight-2 candidates of OSD-CS: every pair within the first
    ``order`` non-pivot columns (i < j), in the reference's order."""
    pi = [i for i in range(order) for j in range(i + 1, order)]
    pj = [j for i in range(order) for j in range(i + 1, order)]
    return np.asarray(pi, np.int64), np.asarray(pj, np.int64)


def _or_fold_rows(x):
    r = x.shape[0]
    rp = 1
    while rp < r:
        rp *= 2
    if rp != r:
        x = torch.cat([x, x.new_zeros((rp - r, *x.shape[1:]))])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] | x[h:]
    return x[0]


def gauss_jordan(H_words, syndrome, key, *, m: int, n: int, rank: int):
    dev = syndrome.device
    B = syndrome.shape[0]
    W = H_words.shape[1]
    state = torch.cat([H_words[:, :, None].expand(m, W, B),
                       syndrome.T.to(torch.int32)[:, None, :]], dim=1).contiguous()
    unused = torch.ones((m, B), dtype=torch.bool, device=dev)
    piv_col = torch.full((rank, B), -1, dtype=torch.int32, device=dev)
    piv_row = torch.full((rank, B), -1, dtype=torch.int32, device=dev)
    key_t = key.to(torch.float32).T
    inf = torch.tensor(float("inf"), device=dev)
    iota_m = torch.arange(m, device=dev)[:, None]
    shifts = torch.arange(_W, dtype=torch.int32, device=dev)[None, :, None]
    for r in range(rank):
        mat = state[:, :W, :]
        live_words = _or_fold_rows(torch.where(unused[:, None, :], mat, 0))
        live_bits = ((live_words[:, None, :] >> shifts) & 1).reshape(W * _W, B)[:n]
        jstar = torch.where(live_bits > 0, key_t, inf).argmin(dim=0)
        colw = torch.gather(mat, 1, (jstar // _W).view(1, 1, B).expand(m, 1, B))[:, 0]
        colbits = ((colw >> (jstar % _W).to(torch.int32)[None, :]) & 1) > 0
        istar = torch.where(colbits & unused, iota_m, m + 1).argmin(dim=0)
        prow = torch.gather(state, 0, istar.view(1, 1, B).expand(1, W + 1, B))
        sel = colbits & (iota_m != istar[None, :])
        state = torch.where(sel[:, None, :], state ^ prow, state)
        unused = unused & (iota_m != istar[None, :])
        piv_col[r] = jstar.to(torch.int32)
        piv_row[r] = istar.to(torch.int32)
    synd_bits = (state[:, W, :] & 1).to(torch.int32)
    sol_bits = torch.gather(synd_bits, 0, piv_row.long())
    osd0 = torch.zeros((n, B), dtype=torch.uint8, device=dev)
    osd0.scatter_(0, piv_col.long(), sol_bits.to(torch.uint8))
    return {"osd0": osd0.T.contiguous(), "piv_col": piv_col, "piv_row": piv_row,
            "reduced_wm": state[:, :W, :].permute(1, 0, 2).contiguous(),
            "sol_bits": sol_bits}


def _extract_bitcols(reduced_wm, col_ids):
    W, m, B = reduced_wm.shape
    cols = []
    for cid in col_ids:
        cid = cid.long()
        colw = torch.gather(reduced_wm, 0, (cid // _W).view(1, 1, B).expand(1, m, B))[0]
        cols.append(((colw >> (cid % _W).to(torch.int32)[None, :]) & 1).to(torch.float32))
    return torch.stack(cols)


def _weighted_bit_sums(reduced_wm, w_rows, n):
    W, m, B = reduced_wm.shape
    shifts = torch.arange(_W, dtype=torch.int32, device=reduced_wm.device)[None, :, None]
    acc = torch.zeros((n, B), dtype=torch.float32, device=reduced_wm.device)
    for i in range(m):  # ascending row from +0.0, one rounding per add
        bits = ((reduced_wm[:, i, :][:, None, :] >> shifts) & 1).reshape(W * _W, B)[:n]
        acc = acc + torch.where(bits != 0, w_rows[i], 0.0)
    return acc


def osd_cs(H_words, syndrome, rel, llr, pair_i, pair_j, *, m: int, n: int, rank: int,
           order: int):
    """OSD-CS of ``syndrome`` [B, m] with reliability key ``rel`` [B, n]
    (smaller = tried first) and priors ``llr`` [n]: [B, n] uint8."""
    gj = gauss_jordan(H_words, syndrome, rel, m=m, n=n, rank=rank)
    osd0 = gj["osd0"]
    B = osd0.shape[0]
    dev = osd0.device
    reduced = gj["reduced_wm"]
    piv_col = gj["piv_col"].long()
    piv_row = gj["piv_row"].long()
    sol = gj["sol_bits"].to(torch.float32)
    lane = torch.arange(B, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    llr_bm = llr[:, None].expand(n, B)
    llr_piv = torch.gather(llr_bm, 0, piv_col)
    # pm0 in ascending pivot column from +0.0
    _, perm = torch.sort(piv_col, dim=0)
    terms = torch.gather(torch.where(sol != 0, llr_piv, 0.0), 0, perm)
    pm0 = torch.zeros((B,), dtype=torch.float32, device=dev)
    for t in terms:
        pm0 = pm0 + t
    w_rows = torch.zeros((m, B), dtype=torch.float32, device=dev)
    w_rows.scatter_(0, piv_row, llr_piv * (1.0 - 2.0 * sol))
    a_all = _weighted_bit_sums(reduced, w_rows, n)
    nonpiv = torch.ones((n, B), dtype=torch.bool, device=dev)
    nonpiv.scatter_(0, piv_col, False)
    pm_w1 = torch.where(nonpiv, pm0[None, :] + a_all + llr_bm, inf)
    best1_col = pm_w1.argmin(dim=0)
    best1_pm = pm_w1.amin(dim=0)
    # the ``order`` least reliable non-pivot columns (ties to the lower)
    keyr = torch.where(nonpiv, rel.to(torch.float32).T, inf)
    iota_n = torch.arange(n, device=dev)[:, None]
    tops = []
    for _ in range(order):
        tid = keyr.argmin(dim=0)
        tops.append(tid)
        keyr = torch.where(iota_n == tid[None, :], inf, keyr)
    top_ids = torch.stack(tops)
    pair_i = torch.as_tensor(pair_i, device=dev)
    pair_j = torch.as_tensor(pair_j, device=dev)
    a_top = torch.gather(a_all, 0, top_ids)
    llr_top = torch.gather(llr_bm, 0, top_ids)
    sub_cols = _extract_bitcols(reduced, top_ids)
    both = (sub_cols[pair_i] * sub_cols[pair_j]) != 0
    gram = torch.zeros((pair_i.shape[0], B), dtype=torch.float32, device=dev)
    for i in range(m):
        gram = gram + torch.where(both[:, i], w_rows[i], 0.0)
    pm_w2 = (pm0[None, :] + a_top[pair_i] + a_top[pair_j] - 2.0 * gram
             + llr_top[pair_i] + llr_top[pair_j])
    best2_idx = pm_w2.argmin(dim=0)
    best2_pm = pm_w2.amin(dim=0)
    is_pair = best2_pm < best1_pm
    use_cand = torch.minimum(best1_pm, best2_pm) < pm0
    c1 = torch.where(is_pair, torch.gather(top_ids, 0, pair_i[best2_idx][None, :])[0],
                     best1_col)
    c2 = torch.gather(top_ids, 0, pair_j[best2_idx][None, :])[0]
    win = _extract_bitcols(reduced, torch.stack([c1, c2]))
    f1 = torch.gather(win[0], 0, piv_row)
    f2 = torch.gather(win[1], 0, piv_row)
    y = torch.remainder(sol + torch.remainder(f1 + torch.where(is_pair[None, :], f2, 0.0),
                                              2.0), 2.0)
    out = torch.zeros((n + 1, B), dtype=torch.uint8, device=dev)
    out.scatter_(0, piv_col, y.to(torch.uint8))
    out[c1, lane] = 1
    out[torch.where(is_pair, c2, n), lane] = 1
    return torch.where(use_cand[:, None], out[:n].T, osd0)
