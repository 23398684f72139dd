"""Batched GF(2) elimination and OSD-CS, in PyTorch.

The counterpart of the JAX package's ``ops/gf2_solve.py`` for the main
path: the host helpers (numpy), the float-keyed reliability-ordered
Gauss-Jordan ``ordered_gauss_jordan_key`` (the plain version of the CUDA
kernel in ``ops.gf2_cuda``), and the sortless OSD-CS sweep.

The PCM is shared by every shot; only the reliability order of columns
differs per shot. The elimination keeps the matrix row-packed ([m, W+1, B]
words over the column axis, the syndrome appended as an extra word) and at
each of the ``rank`` pivot steps selects the live column with the smallest
per-shot key — the greedy first-independent-column rule of the reference's
``mod2sparse_decomp_osd`` — with full Gauss-Jordan (clear above and
below), so OSD-0 is a direct read-out and every non-pivot column's reduced
bits are its coordinates in the pivot basis.

Packed words are stored as int32 (torch's uint32 lacks most operations).
``(x >> s) & 1`` still extracts bit s under the arithmetic shift, and OR
and XOR do not care about the sign.
"""

from __future__ import annotations

import numpy as np
import torch

_W = 32


def _num_words(n: int) -> int:
    return -(-n // _W)


# ---------------------------------------------------------------------------
# host-side helpers (numpy)
# ---------------------------------------------------------------------------


def pack_rows_host(H: np.ndarray) -> np.ndarray:
    """Pack a 0/1 matrix's rows into uint32 words (little-endian bits)."""
    H = (np.asarray(H) != 0).astype(np.uint8)
    m, n = H.shape
    W = _num_words(n)
    padded = np.zeros((m, W * _W), dtype=np.uint8)
    padded[:, :n] = H
    bits = padded.reshape(m, W, _W).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(_W, dtype=np.uint32))
    return (bits * weights).sum(axis=2, dtype=np.uint32)


def gf2_rank_packed(H: np.ndarray) -> int:
    """Rank over GF(2) via packed elimination (fast host path for big PCMs)."""
    H = (np.asarray(H) != 0).astype(np.uint8)
    m, n = H.shape
    W64 = -(-n // 64)
    padded = np.zeros((m, W64 * 64), dtype=np.uint8)
    padded[:, :n] = H
    bits = padded.reshape(m, W64, 64).astype(np.uint64)
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    rows = (bits * weights).sum(axis=2, dtype=np.uint64)
    rank = 0
    one = np.uint64(1)
    for j in range(n):
        w, s = j >> 6, np.uint64(j & 63)
        col = (rows[rank:, w] >> s) & one
        hits = np.nonzero(col)[0]
        if hits.size == 0:
            continue
        p = rank + hits[0]
        if p != rank:
            rows[[rank, p]] = rows[[p, rank]]
        sel = ((rows[:, w] >> s) & one).astype(bool)
        sel[rank] = False
        rows[sel] ^= rows[rank]
        rank += 1
        if rank == m:
            break
    return rank


def osd_candidate_patterns(k: int, order: int, method: str) -> np.ndarray:
    """Candidate inputs over the k non-pivot columns (host, static).

    Mirrors the reference candidate lists exactly: OSD-E enumerates all
    ``2**order`` patterns over the first ``order`` columns
    (osd_window.pyx:128-132); OSD-CS takes every weight-1 pattern plus the
    weight-2 pairs within the first ``order`` columns (:134-155). The
    all-zero pattern (== OSD-0) is excluded; the caller compares against the
    OSD-0 path metric anyway.
    """
    pats: list[np.ndarray] = []
    if method == "osd_e":
        for v in range(1, 2**order):
            row = np.zeros(k, dtype=np.uint8)
            for b in range(order):
                row[b] = (v >> b) & 1
            pats.append(row)
    elif method == "osd_cs":
        for i in range(k):
            row = np.zeros(k, dtype=np.uint8)
            row[i] = 1
            pats.append(row)
        for i in range(order):
            for j in range(i + 1, order):
                row = np.zeros(k, dtype=np.uint8)
                row[i] = row[j] = 1
                pats.append(row)
    elif method == "osd_0":
        pass
    else:
        raise ValueError(f"unknown OSD method {method!r}")
    if not pats:
        return np.zeros((0, k), dtype=np.uint8)
    return np.stack(pats)


def analyze_patterns(patterns, k: int) -> dict:
    """Host-side candidate-structure analysis (static per decoder).

    Recognizes the OSD-CS layout (k weight-1 rows followed by weight-2
    pairs) so the sweep can use the linearized path-metric trick; anything
    else is reported as ``"dense"`` (OSD-E), whose sweep is not ported yet.
    Index arrays are numpy; the caller moves them to its device.
    """
    pats = np.asarray(patterns, dtype=np.uint8)
    K = pats.shape[0]
    if K == 0:
        return {"kind": "none"}
    weights = pats.sum(axis=1)
    if (
        K >= k
        and k > 0
        and np.array_equal(pats[:k], np.eye(k, dtype=np.uint8))
        and (weights[k:] == 2).all()
    ):
        pi, pj = [], []
        for row in pats[k:]:
            i, j = np.nonzero(row)[0]
            pi.append(i)
            pj.append(j)
        return {
            "kind": "cs",
            "pair_i": np.asarray(pi, np.int64),
            "pair_j": np.asarray(pj, np.int64),
            "order_w": (max(pj) + 1) if pj else 0,
        }
    supp = int(np.nonzero(pats.any(axis=0))[0].max()) + 1
    return {"kind": "dense", "patterns": pats, "support": supp}


# ---------------------------------------------------------------------------
# batched ordered Gauss-Jordan (plain version of the CUDA kernel)
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _or_fold_rows(x):
    """[R, ...] -> [...] bitwise OR over the leading axis (halving folds)."""
    r = x.shape[0]
    rp = _next_pow2(r)
    if rp != r:
        x = torch.cat([x, x.new_zeros((rp - r, *x.shape[1:]))])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] | x[h:]
    return x[0]


def gj_outputs(state, piv_col, piv_row, inconsistent, *, n: int):
    """The result dict of the elimination, as the JAX package forms it.

    state: [m, W+1, B] int32 reduced rows with the syndrome word last;
    piv_col / piv_row: [rank, B]; inconsistent: [B] (any dtype, nonzero
    where a syndrome bit is left outside the pivot span).
    """
    m, Wp1, B = state.shape
    W = Wp1 - 1
    synd_bits = (state[:, W, :] & 1).to(torch.int32)  # [m, B]
    sol_bits = torch.gather(synd_bits, 0, piv_row.long())  # [rank, B]
    osd0 = torch.zeros((n, B), dtype=torch.uint8, device=state.device)
    osd0.scatter_(0, piv_col.long(), sol_bits.to(torch.uint8))
    return {
        "osd0": osd0.T.contiguous(),
        "piv_col": piv_col.T.contiguous(),
        "piv_row": piv_row.T.contiguous(),
        "reduced_wm": state[:, :W, :].permute(1, 0, 2).contiguous(),
        "synd_bits": synd_bits.T.contiguous(),
        "sol_bits": sol_bits.T.to(torch.uint8).contiguous(),
        "inconsistent": inconsistent.bool(),
    }


def ordered_gauss_jordan_key(H_words, syndrome, key, *, m: int, n: int, rank: int,
                             count_xor: bool = False):
    """Reliability-ordered Gauss-Jordan with FLOAT keys (batch-minor).

    ``H_words`` [m, W] int32 tensor of packed PCM rows;
    ``syndrome`` [B, m] 0/1; ``key`` [B, n] float32, smaller = more likely
    in error = tried first. Pivot column = argmin of the key over live
    columns, ties to the lower column id. Returns the dict of
    ``gj_outputs``: osd0 [B, n] uint8, piv_col / piv_row [B, rank] int32,
    reduced_wm [W, m, B] int32, synd_bits [B, m], sol_bits [B, rank]
    uint8, inconsistent [B] bool. ``count_xor=True`` adds ``xor_rows`` [B]
    int64: the rows these inputs XOR with a pivot row, summed over the
    steps (each such row costs W+1 word XORs), for the kernel's bound.
    """
    dev = syndrome.device
    B = syndrome.shape[0]
    Hw = H_words.to(device=dev, dtype=torch.int32)
    W = Hw.shape[1]
    state = torch.cat(
        [Hw[:, :, None].expand(m, W, B),
         syndrome.T.to(torch.int32)[:, None, :]], dim=1
    ).contiguous()  # [m, W+1, B]
    unused = torch.ones((m, B), dtype=torch.bool, device=dev)
    piv_col = torch.full((rank, B), -1, dtype=torch.int32, device=dev)
    piv_row = torch.full((rank, B), -1, dtype=torch.int32, device=dev)
    key_t = key.to(torch.float32).T  # [n, B]
    inf = torch.tensor(float("inf"), device=dev)
    iota_m = torch.arange(m, device=dev)[:, None]
    shifts = torch.arange(_W, dtype=torch.int32, device=dev)[None, :, None]
    xor_rows = torch.zeros((B,), dtype=torch.int64, device=dev)

    for r in range(rank):
        mat = state[:, :W, :]
        live_words = _or_fold_rows(torch.where(unused[:, None, :], mat, 0))  # [W, B]
        live_bits = ((live_words[:, None, :] >> shifts) & 1).reshape(W * _W, B)[:n]
        jstar = torch.where(live_bits > 0, key_t, inf).argmin(dim=0)  # [B]

        colw = torch.gather(mat, 1, (jstar // _W).view(1, 1, B).expand(m, 1, B))[:, 0]
        colbits = ((colw >> (jstar % _W).to(torch.int32)[None, :]) & 1) > 0  # [m, B]

        istar = torch.where(colbits & unused, iota_m, m + 1).argmin(dim=0)  # [B]
        prow = torch.gather(state, 0, istar.view(1, 1, B).expand(1, W + 1, B))
        sel = colbits & (iota_m != istar[None, :])
        state = torch.where(sel[:, None, :], state ^ prow, state)
        if count_xor:
            xor_rows += sel.sum(dim=0)

        unused = unused & (iota_m != istar[None, :])
        piv_col[r] = jstar.to(torch.int32)
        piv_row[r] = istar.to(torch.int32)

    inconsistent = ((state[:, W, :] & 1).bool() & unused).any(dim=0)
    out = gj_outputs(state, piv_col, piv_row, inconsistent, n=n)
    if count_xor:
        out["xor_rows"] = xor_rows
    return out


# ---------------------------------------------------------------------------
# OSD-CS candidate sweep (sortless)
# ---------------------------------------------------------------------------


def _extract_bitcols(reduced_wm, col_ids_bm):
    """Bits of per-shot columns from packed rows.

    reduced_wm: [W, m, B]; col_ids_bm: [T, B] per-lane column ids.
    Returns [T, m, B] float32 bits.
    """
    W, m, B = reduced_wm.shape
    cols = []
    for cid in col_ids_bm:
        cid = cid.long()
        colw = torch.gather(reduced_wm, 0, (cid // _W).view(1, 1, B).expand(1, m, B))[0]
        bits = (colw >> (cid % _W).to(torch.int32)[None, :]) & 1
        cols.append(bits.to(torch.float32))
    return torch.stack(cols)  # [T, m, B]


def _weighted_bit_sums(reduced_wm, w_rows, n):
    """a_all[j, b] = sum_i bit(row i, col j) * w_rows[i, b], for all columns.

    The rows are added in ascending order from +0.0, one rounding per add:
    the order of the fused kernel (``csrc/gauss_jordan.cu``), which adds
    only the set bits. A zero term leaves such a sum unchanged (it never
    holds -0.0), so both give the same bits.
    """
    W, m, B = reduced_wm.shape
    shifts = torch.arange(_W, dtype=torch.int32, device=reduced_wm.device)[None, :, None]
    acc = torch.zeros((n, B), dtype=torch.float32, device=reduced_wm.device)
    for i in range(m):
        bits = ((reduced_wm[:, i, :][:, None, :] >> shifts) & 1).reshape(W * _W, B)[:n]
        acc = acc + torch.where(bits != 0, w_rows[i], 0.0)
    return acc  # [n, B]


def _sum_in_column_order(piv_col_bm, terms):
    """[B] sum over the pivots of ``terms`` [R, B], taken in ascending pivot
    column from +0.0 (the kernel's order for pm0)."""
    _, perm = torch.sort(piv_col_bm, dim=0)
    terms = torch.gather(terms, 0, perm)
    acc = torch.zeros(terms.shape[1:], dtype=torch.float32, device=terms.device)
    for t in terms:
        acc = acc + t
    return acc


def _support_metric(solution, llr_bm):
    """[B] f32 path metric of ``solution`` [B, n]: the sum of ``llr_bm``
    [n, B] over its support, in ascending column from +0.0 in float64,
    rounded once to float32 (the kernel's order for ``min_pm``)."""
    B, n = solution.shape
    dev = solution.device
    iota_n = torch.arange(n, device=dev)[:, None]
    cols, _ = torch.sort(torch.where(solution.T != 0, iota_n, n), dim=0)
    terms = torch.cat([llr_bm.double(), torch.zeros((1, B), dtype=torch.float64, device=dev)])
    support = int((solution != 0).sum(dim=1).max()) if B else 0
    terms = torch.gather(terms, 0, cols[:support])
    acc = torch.zeros((B,), dtype=torch.float64, device=dev)
    for t in terms:
        acc = acc + t
    return acc.float()


def _top_nonpivot_columns(rel_t, nonpiv, order_w):
    """[order_w, B] the most unreliable non-pivot columns, by ``order_w``
    iterated masked argmins of ``rel_t`` [n, B] (ties to the lower column:
    the first non-pivot columns of the (key, column) order)."""
    inf = torch.tensor(float("inf"), device=rel_t.device)
    iota_n = torch.arange(rel_t.shape[0], device=rel_t.device)[:, None]
    keyr = torch.where(nonpiv, rel_t, inf)
    tops = []
    for _ in range(order_w):
        tid = keyr.argmin(dim=0)  # [B]
        tops.append(tid)
        keyr = torch.where(iota_n == tid[None, :], inf, keyr)
    return torch.stack(tops)


def _osd_sweep_cs_sortless(gj, rel, channel_llr, pair_i, pair_j, *, order_w):
    """OSD-CS sweep without a sort.

    The weight-1 candidate set is ALL non-pivot columns (exactly k = n -
    rank of them), evaluated masked over the full column axis; the
    weight-2 pair set needs only the ``order_w`` most unreliable non-pivot
    columns, found by ``order_w`` iterated masked argmins (ties to the
    lower column id — the stable-argsort order). Returns (solution [B, n]
    uint8, min_pm [B] f32).

    Every f32 sum is taken in the stated order of the fused CUDA kernel
    (``ops.gf2_cuda.osd_cs_fused``), so that it is bit-exact against this
    function: pm0 in ascending column, a_j and the Gram terms in ascending
    row, each add rounded once. ``min_pm`` is the chosen solution's metric
    taken anew from its support (``_support_metric``): in reals it equals
    the least candidate metric, and the f64 sum keeps it within rounding of
    the exact value, where the f32 sums of the candidates drift by a few
    ulps.
    """
    osd0 = gj["osd0"]
    B, n = osd0.shape
    dev = osd0.device
    reduced = gj["reduced_wm"]  # [W, m, B]
    m = reduced.shape[1]
    piv_col_bm = gj["piv_col"].T.long()  # [R, B]
    piv_row_bm = gj["piv_row"].T.long()
    sol_bm = gj["sol_bits"].T.to(torch.float32)  # [R, B]
    lane = torch.arange(B, device=dev)
    inf = torch.tensor(float("inf"), device=dev)

    llr = torch.as_tensor(channel_llr, dtype=torch.float32, device=dev)
    llr_bm = llr[:, None].expand(n, B) if llr.ndim == 1 else llr.T
    llr_piv = torch.gather(llr_bm, 0, piv_col_bm)  # [R, B]
    pm0 = _sum_in_column_order(piv_col_bm, torch.where(sol_bm != 0, llr_piv, 0.0))  # [B]
    w = llr_piv * (1.0 - 2.0 * sol_bm)
    w_rows = torch.zeros((m, B), dtype=torch.float32, device=dev)
    w_rows.scatter_(0, piv_row_bm, w)

    a_all = _weighted_bit_sums(reduced, w_rows, n)  # [n, B]

    nonpiv = torch.ones((n, B), dtype=torch.bool, device=dev)
    nonpiv.scatter_(0, piv_col_bm, False)
    pm_w1 = torch.where(nonpiv, pm0[None, :] + a_all + llr_bm, inf)  # [n, B]
    best1_col = pm_w1.argmin(dim=0)  # [B]
    best1_pm = pm_w1.amin(dim=0)

    rel_t = rel.to(torch.float32).T  # [n, B]
    pair_i = torch.as_tensor(pair_i, dtype=torch.long, device=dev)
    pair_j = torch.as_tensor(pair_j, dtype=torch.long, device=dev)
    P = pair_i.shape[0]
    if P:
        top_ids = _top_nonpivot_columns(rel_t, nonpiv, order_w)  # [order_w, B]
        a_top = torch.gather(a_all, 0, top_ids)  # [ow, B]
        llr_top = torch.gather(llr_bm, 0, top_ids)
        sub_cols = _extract_bitcols(reduced, top_ids)  # [ow, m, B]
        both = (sub_cols[pair_i] * sub_cols[pair_j]) != 0  # [P, m, B]
        gram = torch.zeros((P, B), dtype=torch.float32, device=dev)
        for i in range(m):  # ascending row; only pivot rows weigh
            gram = gram + torch.where(both[:, i], w_rows[i], 0.0)
        pm_w2 = (
            pm0[None, :]
            + a_top[pair_i] + a_top[pair_j]
            - 2.0 * gram
            + llr_top[pair_i] + llr_top[pair_j]
        )  # [P, B]
        best2_idx = pm_w2.argmin(dim=0)
        best2_pm = pm_w2.amin(dim=0)
    else:
        best2_idx = torch.zeros((B,), dtype=torch.long, device=dev)
        best2_pm = inf.expand(B)

    is_pair = best2_pm < best1_pm
    best_pm = torch.minimum(best1_pm, best2_pm)
    use_cand = best_pm < pm0

    if P:
        c1 = torch.where(
            is_pair,
            torch.gather(top_ids, 0, pair_i[best2_idx][None, :])[0],
            best1_col,
        )
        c2 = torch.gather(top_ids, 0, pair_j[best2_idx][None, :])[0]
    else:
        c1, c2 = best1_col, torch.zeros((B,), dtype=torch.long, device=dev)

    win_cols = _extract_bitcols(reduced, torch.stack([c1, c2]))  # [2, m, B]
    f1 = torch.gather(win_cols[0], 0, piv_row_bm)
    f2 = torch.gather(win_cols[1], 0, piv_row_bm)
    flip = torch.remainder(f1 + torch.where(is_pair[None, :], f2, 0.0), 2.0)
    y = torch.remainder(sol_bm + flip, 2.0)  # [R, B]

    out = torch.zeros((n + 1, B), dtype=torch.uint8, device=dev)
    out.scatter_(0, piv_col_bm, y.to(torch.uint8))
    out[c1, lane] = 1
    c2_or_pad = torch.where(is_pair, c2, n)  # pad row swallows non-pairs
    out[c2_or_pad, lane] = 1
    solution = torch.where(use_cand[:, None], out[:n].T, osd0)
    return solution, _support_metric(solution, llr_bm)


def osd_decode(
    H_words,
    syndrome,
    reliability,
    channel_llr,
    *,
    m: int,
    n: int,
    rank: int,
    k: int,
    meta: dict,
):
    """OSD-CS or OSD-0: eliminate by reliability, sweep the candidates.

    ``reliability``: [B, n] float — smaller = more likely in error = tried
    first. ``meta`` is the static ``analyze_patterns`` result with its
    pair indices already on the device. The CS branch (float keys,
    sortless sweep) and the OSD-0 branch (``meta["kind"] == "none"`` or
    ``k == 0``: the elimination and its OSD-0 solution) of the JAX
    ``osd_decode`` are ported; OSD-E is not. With a 1-D ``channel_llr``
    the CS branch is ``ops.gf2_cuda.osd_cs_fused`` (one fused launch on
    the card, the plain elimination and sweep on the CPU); a 2-D prior and
    the OSD-0 branch run the elimination through ``ops.gf2_cuda.
    gauss_jordan_key`` and the sweep here. The JAX OSD-0 branch eliminates
    in the order of a stable argsort of the reliability; the float-keyed
    elimination picks the same pivots (the smallest live key, ties to the
    lower column), so both branches feed it the reliability directly.
    """
    from .gf2_cuda import gauss_jordan_key, osd_cs_fused

    if meta["kind"] not in ("none", "cs") and k != 0:
        raise NotImplementedError(
            f"OSD with candidate structure {meta['kind']!r} is not ported"
        )
    cs = meta["kind"] == "cs" and k != 0
    if cs and torch.as_tensor(channel_llr).ndim == 1:
        return osd_cs_fused(
            H_words, syndrome, reliability, channel_llr, meta["pair_i"], meta["pair_j"],
            m=m, n=n, rank=rank, order_w=int(meta["order_w"]),
        )
    gj = gauss_jordan_key(H_words, syndrome, reliability, m=m, n=n, rank=rank)
    if not cs:
        llr = torch.as_tensor(channel_llr, dtype=torch.float32, device=syndrome.device)
        pm0 = (llr * gj["osd0"]).sum(dim=1)
        return {
            "solution": gj["osd0"],
            "osd0": gj["osd0"],
            "min_pm": pm0,
            "inconsistent": gj["inconsistent"],
        }
    solution, min_pm = _osd_sweep_cs_sortless(
        gj, reliability, channel_llr, meta["pair_i"], meta["pair_j"],
        order_w=int(meta["order_w"]),
    )
    return {
        "solution": solution,
        "osd0": gj["osd0"],
        "min_pm": min_pm,
        "inconsistent": gj["inconsistent"],
    }
