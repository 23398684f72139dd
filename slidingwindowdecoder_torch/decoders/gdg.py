"""Guided decimation with guessing (GDG) as a branch ensemble, in PyTorch.

The counterpart of the JAX package's ``decoders/gdg.py`` (the multi-thread
``bpgdg_decoder`` of the reference, bp_guessing_decoder.pyx:160-338 and
bpgd.cpp:419-688): a *main* path decimating the favored value each step,
*tree* branches forcing every +/- combination of the first
``max_tree_depth`` decisions, a *tree-side* branch per tree branch with one
more anti-decision at ``max_tree_depth``, and *side* branches continuing the
main path with one anti-decision at depths [tree_depth, side_depth). Every
branch is a column of one batch: branch b differs from the main path only
through the static per-(branch, depth) flip table, so the ensemble is one
masked-BP + decimation loop over B*NB columns, and the reference's
mutex race for the best path metric becomes a per-shot argmin.

Layout: the carry is batch-minor ("transposed"), each shot's NB branch
columns consecutive: messages slot-major [dc, m_pad, BN] in the message
dtype, history [n, 4, BN] in the ring's dtype (``hist_dtype``, f32 or
bf16: each write rounds the f32 posterior once; every reader takes f32
images), VN arrays [n, BN], CN arrays [m_pad, BN]
with inert pad rows. Each decimation step is one masked ``bp_run`` burst
(on the card one launch of the pinned fused kernel ``csrc/bp_span.cu``),
the select, the aggressive decimation and its peel, the guess and its
peel (on the card each decision with its peel one launch of
``csrc/peel.cu``) and the side-branch message reinit.
The JAX package's default "fused" form (``gdg_ensemble``) runs all
``D_max`` steps with no host read between the first and the reduce (or,
with ``early_exit``, reads one flag a step: whether any column is
unfinished). Its "host_loop" form reads that flag after every step and
stops once every column has finished, which is ``gdg_ensemble`` with
``early_exit``. The two differ only in the columns that died in a peel,
which the extra steps' peels keep sweeping; ``_ensemble_reduce`` reads
such a column only for a shot none of whose branches converged. Its
"spans" form cuts the depth loop into static spans and, before each,
sorts the finished columns out of the walk (row compaction); a side or
tree-side column stays dormant until its activation depth and then
copies its source column (lane dormancy).

``multi_thread=False`` runs the reference's default, the serial work
queue ``gdg_serial`` (bp_guessing_decoder.pyx:254-338): batch-major state,
all shots in lockstep, a host loop over the main branch's depths and then
over the queue's slots and each side branch's steps, one host read of
whether to go on each time. Each step's BP is one masked ``bp_run`` call
(on the card one ``bp_span_pinned`` launch).

Path metrics (``min_pm``, the per-shot choice among converged branches and
the serial queue's ``pm < min_pm``) are the priors of the correction's
support summed in float64. Every partial sum of these priors is exact in
float64 (f32 values of bounded exponent range, at most n of them), so the
sum is that of any order, ascending VN order included, on either device;
``min_pm`` is it rounded once to float32. The JAX package sums in float32
in XLA's order, so its ``min_pm`` may differ in the last bits. Under
jittered priors both pick the same branch; under uniform priors a partial
sum of k equal terms is k times one term on both sides, so the serial
queue's comparisons go the same way too. Where two ensemble branches'
supports differ but weigh the same, the JAX rounding may pick the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.tanner import compile_graph, graph_tensors
from ..ops.bp import (
    bp_init_messages,
    bp_init_messages_sm,
    bp_run,
    column_major,
    decode_bp,
    fresh_bp_state,
    hist_torch_dtype,
    msg_torch_dtype,
    take_columns,
)
from ..ops.decimation import (
    init_decimation_state,
    set_index_and_peel,
    set_index_and_peel_t,
    set_values_and_peel,
    set_values_and_peel_t,
    unsatisfied_counts,
    unsatisfied_counts_t,
)
from ..utils.device import resolve_device
from .base import DecodeResult, as_batch, pad_pow2
from .bposd import _divisor_bucket

MAX_PM = 1e4  # reference sentinel (bpgd.cpp:11)


def build_branch_tables(
    max_step: int,
    max_tree_depth: int,
    max_side_depth: int,
    max_tree_branch_step: int,
    max_side_branch_step: int,
):
    """Static per-branch flip/threshold/budget tables (numpy; the JAX
    package's, array for array).

    Branch layout: [main | tree (2^td - 1) | tree-side (2^td - 1) | side
    (sd - td)]; total = 2*(2^td - 1) + (sd - td) + 1 — the reference's
    ``max_guess`` + 1 (bp_guessing_decoder.pyx:181). Thresholds (A, A_sum)
    follow bpgd.cpp:431-468,588,631: main path (-3, -16 at depth 0 else
    -12); once a branch has taken an anti-favored decision, (0, -10).
    ``copy_from``/``copy_at`` say which lane a lane equals up to which
    depth (the snapshot structure the spans form uses).
    """
    td, sd = max_tree_depth, max_side_depth
    branches = []  # (flip_depths: set, budget, reinit_depth or -1)
    branches.append((frozenset(), max_step, -1))  # main
    for tid in range(1, 2**td):
        bits = {d for d in range(td) if (tid >> (td - 1 - d)) & 1}
        budget = max_tree_branch_step + td + 1  # bpgd.cpp:449 loop bound
        branches.append((frozenset(bits), budget, -1))
    for tid in range(1, 2**td):
        bits = {d for d in range(td) if (tid >> (td - 1 - d)) & 1}
        budget = td + 1 + max_tree_branch_step
        branches.append((frozenset(bits | {td}), budget, td))
    for j in range(sd - td):
        fd = td + j
        branches.append((frozenset({fd}), fd + 1 + max_side_branch_step, fd))

    NB = len(branches)
    D_max = max(b[1] for b in branches)
    flip_now = np.zeros((NB, D_max), dtype=bool)
    reinit = np.zeros((NB, D_max), dtype=bool)
    budget = np.zeros(NB, dtype=np.int32)
    A_arr = np.zeros((NB, D_max), dtype=np.float32)
    Asum_arr = np.zeros((NB, D_max), dtype=np.float32)
    for b, (bits, bud, rd) in enumerate(branches):
        budget[b] = bud
        first_flip = min(bits) if bits else D_max + 1
        for d in range(D_max):
            flip_now[b, d] = d in bits
            on_side = d > first_flip
            A_arr[b, d] = 0.0 if on_side else -3.0
            Asum_arr[b, d] = -10.0 if on_side else (-16.0 if d == 0 else -12.0)
        if rd >= 0:
            reinit[b, rd] = True

    copy_from = np.full(NB, -1, dtype=np.int32)
    copy_at = np.full(NB, -1, dtype=np.int32)
    for tid in range(1, 2**td):
        copy_from[(2**td - 1) + tid] = tid  # tree-side <- its tree lane
        copy_at[(2**td - 1) + tid] = td
    for j in range(sd - td):
        b = 2 * (2**td - 1) + 1 + j
        copy_from[b] = 0  # side lane <- main
        copy_at[b] = td + j
    return {
        "flip_now": flip_now,
        "reinit": reinit,
        "budget": budget,
        "A": A_arr,
        "A_sum": Asum_arr,
        "copy_from": copy_from,
        "copy_at": copy_at,
        "num_branches": NB,
        "D_max": D_max,
    }


def tile_branch_tables(tables, BK: int, device):
    """Per-column branch tables, depth-major: [D_max, BN] tiles of the
    [NB, D_max] per-branch tables over ``BK`` shots (column r is branch
    r % NB), plus the [BN] budget; on ``device``."""
    def tile_cols(a):
        return torch.as_tensor(np.tile(np.asarray(a).T, (1, BK)), device=device)

    return {
        "flipT": tile_cols(tables["flip_now"]),
        "reinitT": tile_cols(tables["reinit"]),
        "AT": tile_cols(tables["A"]),
        "AsumT": tile_cols(tables["A_sum"]),
        "budget_row": torch.as_tensor(np.tile(np.asarray(tables["budget"]), BK),
                                      device=device),
    }


def _hist_stats(hist, dim: int):
    """(min, max, sum, all_neg) over the ring's slot axis ``dim`` of the
    history (f32 or bf16): each [n, B] from the slot-major [n, 4, B] (dim
    1), [B, n] from the batch-major [B, n, 4] (dim -1). Every stat is taken
    on the f32 images of the stored values (min and max of bf16 values are
    bf16 values, as in JAX). The sum runs slot by slot in f32, the order of
    XLA's reduce on the CPU (``ops.bp.history_sum``), so that exact ties of
    the guess key are the JAX package's."""
    h = hist.float()
    s = [h.select(dim, k) for k in range(4)]
    return (h.amin(dim=dim), h.amax(dim=dim), s[0] + s[1] + s[2] + s[3],
            (h <= 0.0).all(dim=dim))


def _select_and_decimate(
    garr,
    hist_stats,
    error,
    synd,
    vn_state,
    cn_state,
    cn_degree,
    dead,
    active,
    A_row,
    A_sum_row,
    c_allowed,
    *,
    low_error_mode: bool,
    scan_rank,
):
    """Batch-major ``_select_and_decimate_t`` (the JAX
    ``_select_and_decimate``), the serial work queue's select: the same
    decisions on [B, n] / [B, m] state. ``hist_stats`` [B, n] each;
    ``error`` [B, n] gives ``num_flip``'s decoded syndrome; ``active``,
    ``A_row``, ``A_sum_row`` and ``c_allowed`` (the depth < 4 gate of the C
    rule) [B]; ``scan_rank`` [B, n]. Returns (vn_state, cn_state,
    cn_degree, dead, guess_vn, favor, has_cand)."""
    C_thr, D_thr = 30.0, 3.0
    hist_min, hist_max, hist_sum, all_neg = hist_stats
    eligible = (vn_state == -1) & (garr["vn_degree"][None, :] > 2) & active[:, None]

    if low_error_mode:
        mA = torch.zeros_like(eligible)
        agg = mA
    else:
        num_flip = unsatisfied_counts(garr, error, synd, cn_state)
        mC = eligible & (hist_min >= C_thr) & c_allowed[:, None]
        mD = eligible & ~mC & (num_flip >= 3) & (hist_min >= D_thr)
        mA = (eligible & ~mC & ~mD & (hist_max <= A_row[:, None])
              & (hist_sum < A_sum_row[:, None]))
        agg = mC | mD | mA

    cand = eligible & ~agg
    big = torch.tensor(MAX_PM, dtype=torch.float32, device=vn_state.device)
    key_any = torch.where(cand, hist_sum, big)
    key_neg = torch.where(cand & all_neg, hist_sum, big)
    has_neg = (key_neg < big).any(dim=1)
    has_any = (key_any < big).any(dim=1)
    big_i = torch.tensor(1 << 30, dtype=scan_rank.dtype, device=vn_state.device)
    kmin_neg = key_neg.amin(dim=1, keepdim=True)
    kmin_any = key_any.amin(dim=1, keepdim=True)
    vn_neg = torch.where(key_neg <= kmin_neg, scan_rank, big_i).argmin(dim=1)
    vn_any = torch.where(key_any <= kmin_any, scan_rank, big_i).argmin(dim=1)
    guess_vn = torch.where(has_neg, vn_neg, vn_any)
    favor = torch.where(has_neg, True, kmin_any[:, 0] <= 0.0).to(torch.int8)

    vn_state, cn_state, cn_degree, dead = set_values_and_peel(
        garr, vn_state, cn_state, cn_degree, dead, agg, mA)
    return vn_state, cn_state, cn_degree, dead, guess_vn, favor, has_neg | has_any


def _select_and_decimate_t(
    garr,
    hist_stats,
    synd_t,
    vn_t,
    cn_t,
    deg_t,
    dead,
    active,
    A_row,
    A_sum_row,
    c_allowed: bool,
    *,
    low_error_mode: bool,
    synd_hat_t,
    scan_rank_t,
):
    """The reference ``select_vn`` scan (bpgd.cpp:288-351 == pyx:340-442)
    on the transposed state: the aggressive C/D/A decimation applied at
    once and peeled, then the guess (the least history sum, all-negative
    histories first; an exact tie goes to the lowest scan rank, the most
    unreliable VN, as the reference's reliability-ordered scan with strict
    ``<`` does).

    ``hist_stats`` [n, B] each; ``synd_t``, ``synd_hat_t`` [m_pad, B] with
    equal pad rows; ``active``, ``A_row``, ``A_sum_row`` [B]; ``c_allowed``
    the depth < 4 gate of the C rule. Returns (vn_t, cn_t, deg_t, dead,
    guess_vn, favor, has_cand).
    """
    C_thr, D_thr = 30.0, 3.0
    hist_min, hist_max, hist_sum, all_neg = hist_stats
    eligible = (vn_t == -1) & (garr["vn_degree"][:, None] > 2) & active[None, :]

    if low_error_mode:
        mA = torch.zeros_like(eligible)
        agg = mA
    else:
        num_flip = unsatisfied_counts_t(garr, synd_hat_t, synd_t, cn_t)
        mC = eligible & (hist_min >= C_thr) & c_allowed
        mD = eligible & ~mC & (num_flip >= 3) & (hist_min >= D_thr)
        mA = (eligible & ~mC & ~mD & (hist_max <= A_row[None, :])
              & (hist_sum < A_sum_row[None, :]))
        agg = mC | mD | mA

    cand = eligible & ~agg
    # python scalars, not device tensors: no host-to-device copy
    key_any = torch.where(cand, hist_sum, MAX_PM)
    key_neg = torch.where(cand & all_neg, hist_sum, MAX_PM)
    has_neg = (key_neg < MAX_PM).any(dim=0)
    has_any = (key_any < MAX_PM).any(dim=0)
    kmin_neg = key_neg.amin(dim=0, keepdim=True)
    kmin_any = key_any.amin(dim=0, keepdim=True)
    # scan ranks are distinct within a column, so each argmin is unique
    vn_neg = torch.where(key_neg <= kmin_neg, scan_rank_t, 1 << 30).argmin(dim=0)
    vn_any = torch.where(key_any <= kmin_any, scan_rank_t, 1 << 30).argmin(dim=0)
    guess_vn = torch.where(has_neg, vn_neg, vn_any)
    favor = torch.where(has_neg, True, kmin_any[0] <= 0.0).to(torch.int8)

    vn_t, cn_t, deg_t, dead = set_values_and_peel_t(garr, vn_t, cn_t, deg_t, dead, agg, mA)
    return vn_t, cn_t, deg_t, dead, guess_vn, favor, has_neg | has_any


def _ensemble_init(garr, llr, syndrome, scan_rank, vn_state0, cn_state0, cn_degree0,
                   dead0, NB: int, msg_dtype: str = "float32", hist_dtype: str = "float32"):
    """Tile per-shot state over the NB branch columns (each shot's columns
    consecutive). ``syndrome`` [BK, m]; ``scan_rank``, ``vn_state0`` [BK,
    n]; ``cn_state0``, ``cn_degree0`` [BK, m]; ``dead0`` [BK]. The history
    ring is allocated in ``hist_dtype``. Returns (carry, synd [m_pad, BN]
    int8, scan rank [n, BN])."""
    BK, m = syndrome.shape
    n, m_pad = garr["n"], garr["m_pad"]
    dev = syndrome.device
    BN = BK * NB

    def tile_t(x_t):
        return x_t.repeat_interleave(NB, dim=-1)

    def pad_cn_t(x, fill, dtype):
        out = torch.full((m_pad, BK), fill, dtype=dtype, device=dev)
        out[:m] = x.T.to(dtype)
        return out

    dead = dead0.repeat_interleave(NB)
    carry = {
        # each column's messages contiguous: the fused kernel reads and
        # writes them whole, in place
        "mv": column_major(bp_init_messages_sm(garr, llr, BN, msg_dtype)),
        "history": torch.zeros((n, 4, BN), dtype=hist_torch_dtype(hist_dtype), device=dev),
        "error": torch.zeros((n, BN), dtype=torch.int8, device=dev),
        "vn": tile_t(vn_state0.T.to(torch.int8)),
        "cn": tile_t(pad_cn_t(cn_state0, -1, torch.int8)),
        "deg": tile_t(pad_cn_t(cn_degree0, 0, torch.int32)),
        "dead": dead,
        "halted": dead.clone(),  # halted starts as dead
        "converged": torch.zeros((BN,), dtype=torch.bool, device=dev),
        "conv_error": torch.zeros((n, BN), dtype=torch.int8, device=dev),
        "iters": torch.zeros((BN,), dtype=torch.int32, device=dev),
    }
    synd = tile_t(pad_cn_t(syndrome, 0, torch.int8))
    rank_b = tile_t(scan_rank.T.to(torch.int32))
    return carry, synd, rank_b


def _ensemble_step(garr, llr, synd, scan_rank, tt, reinit_any, d: int, carry, *,
                   num_iter: int, alpha: float, clip: float, low_error_mode: bool,
                   msg_dtype: str, hist_dtype: str = "float32", start_row=None):
    """One ensemble decimation step (the JAX ``_ensemble_step``): masked BP
    burst, select_vn, decimate, peel, side-branch message reinit. Updates
    ``carry`` in place of its entries. ``reinit_any``: whether any branch
    reinitializes its messages at depth ``d`` (a host bool). ``start_row``
    [BN] (spans form only) keeps dormant columns, which copy another
    column's state at their activation depth, frozen before that depth."""
    c = carry
    active = ~c["halted"] & (d < tt["budget_row"])
    if start_row is not None:
        active = active & (d >= start_row)

    # masked BP burst; tail history: only the burst's last 4 iterations
    # write the ring, which the select reads for rows still active. The
    # carry is rebound to the outputs below, so the burst updates it in
    # place (on the card a halted column is neither read nor written).
    mv, history, error, bp_done, iters, synd_hat = bp_run(
        garr, c["mv"], llr, synd, c["history"], c["error"], ~active, c["iters"],
        num_iter=num_iter, alpha=alpha, clip=clip, msg_dtype=msg_dtype,
        return_synd=True, io_layout="slot_major", history_mode="tail",
        hist_update="slice", state_layout="transposed", vn_state=c["vn"],
        cn_state=c["cn"], masked=True, hist_dtype=hist_dtype, inplace=True,
    )
    newly_conv = bp_done & active
    conv_error = torch.where(newly_conv[None, :], error, c["conv_error"])
    converged = c["converged"] | newly_conv
    halted = c["halted"] | newly_conv
    active = active & ~newly_conv

    vn, cn, deg, dead, guess_vn, favor, has_cand = _select_and_decimate_t(
        garr, _hist_stats(history, 1), synd, c["vn"], c["cn"], c["deg"], c["dead"],
        active, tt["AT"][d], tt["AsumT"][d], d < 4, low_error_mode=low_error_mode,
        synd_hat_t=synd_hat, scan_rank_t=scan_rank,
    )
    # no candidate: the branch ends (the reference's guess_vn == -1 break)
    halted = halted | (active & ~has_cand)

    # the decision: the favored value, flipped where this branch flips
    value = favor ^ tt["flipT"][d].to(torch.int8)
    do_set = active & ~halted & ~dead
    vn, cn, deg, dead = set_index_and_peel_t(garr, vn, cn, deg, dead, guess_vn, value, do_set)
    halted = halted | dead

    # side branches restart their messages from the priors at their flip
    if reinit_any:
        re = tt["reinitT"][d] & do_set
        mv = torch.where(re[None, None, :],
                         bp_init_messages_sm(garr, llr, vn.shape[1], msg_dtype), mv)

    # decided values show in the running error
    error = torch.where(vn != -1, vn, error)
    c.update(mv=mv, history=history, error=error, vn=vn, cn=cn, deg=deg, dead=dead,
             halted=halted, converged=converged, conv_error=conv_error, iters=iters)
    return c


def path_metric(llr, error_t):
    """[n, B] 0/1 error -> [B] float64 sum of the priors ``llr`` [n] on its
    support. The sum is exact (module docstring), so it is the same in
    every order and on either device."""
    return (error_t == 1).to(torch.float64).T @ llr.to(torch.float64)


def _ensemble_reduce(carry, llr, BK: int, NB: int):
    """The per-shot best converged branch (least path metric, the first
    branch on a tie), else the main branch's error. Returns batch-major
    outputs."""
    error, conv_error = carry["error"], carry["conv_error"]
    n = error.shape[0]
    conv_b = carry["converged"].view(BK, NB)
    key = torch.where(conv_b, path_metric(llr, conv_error).view(BK, NB), MAX_PM)
    kmin = key.amin(dim=1)
    lanes = torch.arange(NB, device=key.device)
    best = torch.where(key == kmin[:, None], lanes, NB).amin(dim=1)
    any_conv = conv_b.any(dim=1)
    best_err = conv_error.view(n, BK, NB).gather(
        2, best[None, :, None].expand(n, BK, 1))[:, :, 0]
    main_err = error.view(n, BK, NB)[:, :, 0]
    final = torch.where(any_conv[None, :], best_err, main_err)
    return {
        "error": final.T.to(torch.uint8),
        "converged": any_conv,
        "min_pm": kmin.to(torch.float32),
        "iterations": carry["iters"].view(BK, NB).sum(dim=1, dtype=torch.int32),
    }


def default_spans(D_max: int, budgets, span: int = 4, activations=()) -> tuple:
    """Static span schedule (the JAX ``default_spans``): compaction every
    ``span`` steps, plus a boundary at each branch-budget cliff where at
    least 1/8 of the ensemble goes inactive at once, plus one at every
    lane activation depth (dormant lanes copy their source at span
    starts, so each distinct ``copy_at`` needs a boundary)."""
    budgets = [int(b) for b in budgets]
    nb = max(len(budgets), 1)
    counts = {}
    for b in budgets:
        counts[b] = counts.get(b, 0) + 1
    cliffs = {b for b, c in counts.items() if 0 < b < D_max and c * 8 >= nb}
    acts = {int(a) for a in activations if 0 < a < D_max}
    bounds = sorted(set(range(span, D_max, span)) | cliffs | acts | {D_max})
    spans, prev = [], 0
    for b in bounds:
        if b > prev:
            spans.append(b - prev)
            prev = b
    return tuple(spans)


def _take_cols(carry, idx):
    """Columns ``idx`` of every entry of a batch-minor carry (rows on the
    last axis); the messages stay column-major (``take_columns``)."""
    return {k: take_columns(v, idx) for k, v in carry.items()}


def gdg_ensemble_spans(
    garr,
    llr,
    syndrome,
    scan_rank,
    vn_state0,
    cn_state0,
    cn_degree0,
    dead0,
    tables,
    *,
    num_iter: int,
    alpha: float,
    clip: float,
    low_error_mode: bool,
    msg_dtype: str = "float32",
    hist_dtype: str = "float32",
    spans: tuple,
    row_bucket: int | None = None,
    copy_plan=None,
):
    """The branch ensemble over ``BK`` shots (``syndrome`` [BK, m]), the
    JAX ``gdg_ensemble_spans``: ``_ensemble_step`` for each depth, the
    depth loop cut into the static ``spans``, then ``_ensemble_reduce``.
    ``tables``: the output of ``build_branch_tables``. Before each span,
    one host read of how many columns (shot x branch lanes) are
    unfinished; a span with none is skipped, and the ensemble ends once
    none is left and no dormant lane is still to wake (a finished column
    changes no output).

    ``row_bucket`` None: the span's steps run on every column. Else the
    columns are sorted unfinished-first (a stable sort) and only the
    buckets of ``row_bucket`` columns (the largest divisor of BN up to
    it) that cover unfinished columns run the span's steps, every step of
    it, as in JAX (row compaction); a bucket may hold finished columns,
    which the step freezes. Unit spans and ``row_bucket`` None give the
    host-stepped form of the JAX package (``gdg_ensemble`` with
    ``early_exit``, ``GDG``'s "host_loop").

    ``copy_plan`` = (copy_at, copy_from) per lane (``build_branch_tables``)
    turns on lane dormancy: a lane that shares another lane's decisions up
    to its activation depth stays frozen until then and copies that lane's
    state at the span boundary of that depth (the reference's snapshot
    handoff, bpgd.cpp:651-664), instead of recomputing the shared prefix.
    Every activation depth must be a span boundary. Every schedule gives
    the host-stepped form's results, up to columns that died in a peel
    (``_ensemble_reduce`` reads one only when no branch of its shot
    converged): such a column keeps being swept while a live column of its
    batch forces, and the batches differ."""
    BK = syndrome.shape[0]
    NB = tables["num_branches"]
    dev = syndrome.device
    carry, synd, rank_b = _ensemble_init(garr, llr, syndrome, scan_rank, vn_state0,
                                         cn_state0, cn_degree0, dead0, NB, msg_dtype,
                                         hist_dtype)
    tt = tile_branch_tables(tables, BK, dev)
    reinit_any = tables["reinit"].any(axis=0)
    BN = BK * NB
    lanes = np.arange(BN) % NB
    start_np = start_row = None
    if copy_plan is not None:
        copy_at, copy_from = (np.asarray(a, np.int32) for a in copy_plan)
        bounds = set(np.cumsum((0,) + tuple(spans)).tolist())
        acts = {int(a) for a in copy_at if a >= 0}
        if not acts <= bounds:
            raise ValueError(f"spans {spans} miss the activation depths "
                             f"{sorted(acts - bounds)} (default_spans adds them)")
        start_np = np.maximum(copy_at[lanes], 0)
        start_row = torch.as_tensor(start_np, device=dev)
    kw = dict(num_iter=num_iter, alpha=alpha, clip=clip, low_error_mode=low_error_mode,
              msg_dtype=msg_dtype, hist_dtype=hist_dtype)
    bucket = BN if row_bucket is None else _divisor_bucket(BN, row_bucket)
    last_wake = -1 if start_np is None else int(start_np.max())

    d0 = 0
    for sp in spans:
        if copy_plan is not None and (copy_at[lanes] == d0).any():
            # activations: each lane starting here copies its source lane
            src = np.where(copy_at[lanes] == d0, (np.arange(BN) // NB) * NB
                           + copy_from[lanes], np.arange(BN))
            carry = _take_cols(carry, torch.as_tensor(src, device=dev))
        finished = carry["halted"] | (d0 >= tt["budget_row"])
        if start_np is not None:  # dormant through the whole span
            finished = finished | (start_row >= d0 + sp)
        n_todo = int((~finished).sum())
        if not n_todo and last_wake < d0 + sp:  # nothing left, nothing to wake
            break
        if bucket == BN and n_todo:  # one bucket holds every column: no compaction
            for d in range(d0, d0 + sp):
                carry = _ensemble_step(garr, llr, synd, rank_b, tt, bool(reinit_any[d]), d,
                                       carry, start_row=start_row, **kw)
            d0 += sp
            continue
        order = torch.argsort(finished.to(torch.int8), stable=True)
        for b in range(-(-n_todo // bucket)):
            idx = order[b * bucket:(b + 1) * bucket]
            sub, tt_c = _take_cols(carry, idx), _take_cols(tt, idx)
            synd_c, rank_c = synd[:, idx], rank_b[:, idx]
            start_c = None if start_row is None else start_row[idx]
            for d in range(d0, d0 + sp):
                sub = _ensemble_step(garr, llr, synd_c, rank_c, tt_c, bool(reinit_any[d]), d,
                                     sub, start_row=start_c, **kw)
            for k, v in sub.items():
                carry[k][..., idx] = v
        d0 += sp
    return _ensemble_reduce(carry, llr, BK, NB)


def gdg_ensemble(
    garr,
    llr,
    syndrome,
    scan_rank,
    vn_state0,
    cn_state0,
    cn_degree0,
    dead0,
    tables,
    *,
    num_iter: int,
    alpha: float,
    clip: float,
    low_error_mode: bool,
    msg_dtype: str = "float32",
    hist_dtype: str = "float32",
    early_exit: bool = False,
):
    """The branch ensemble over ``BK`` shots (``syndrome`` [BK, m]) as the
    JAX ``gdg_ensemble`` runs it: ``_ensemble_init``, ``_ensemble_step``
    for each depth ``d`` in ``range(D_max)`` on every column, then
    ``_ensemble_reduce``. ``tables``: the output of
    ``build_branch_tables``; the per-shot inputs as ``gdg_ensemble_spans``
    takes them.

    ``early_exit`` False (JAX's ``fori_loop``): every step runs, with no
    host read from the first step to the reduce; a step whose columns have
    all finished still sweeps each column once in its peels, which moves
    only the columns that died. True (JAX's ``while_loop``): before step
    ``d``, one host read of whether any column is unfinished (not halted
    and ``d`` within its budget), and the loop stops when none is."""
    BK = syndrome.shape[0]
    NB, D_max = tables["num_branches"], tables["D_max"]
    dev = syndrome.device
    carry, synd, rank_b = _ensemble_init(garr, llr, syndrome, scan_rank, vn_state0,
                                         cn_state0, cn_degree0, dead0, NB, msg_dtype,
                                         hist_dtype)
    tt = tile_branch_tables(tables, BK, dev)
    reinit_any = tables["reinit"].any(axis=0)
    for d in range(D_max):
        if early_exit and not bool((~carry["halted"] & (d < tt["budget_row"])).any()):
            break
        carry = _ensemble_step(garr, llr, synd, rank_b, tt, bool(reinit_any[d]), d, carry,
                               num_iter=num_iter, alpha=alpha, clip=clip,
                               low_error_mode=low_error_mode, msg_dtype=msg_dtype,
                               hist_dtype=hist_dtype)
    return _ensemble_reduce(carry, llr, BK, NB)


def gdg_serial(
    garr,
    llr,
    syndrome,
    scan_rank,
    vn_state0,
    cn_state0,
    cn_degree0,
    dead0,
    *,
    num_iter: int,
    max_step: int,
    max_tree_depth: int,
    max_side_depth: int,
    max_side_branch_step: int,
    max_guess: int,
    alpha: float,
    clip: float,
    low_error_mode: bool,
    msg_dtype: str = "float32",
):
    """The reference's serial GDG (``bpgdg_decoder.gdg``,
    bp_guessing_decoder.pyx:254-338; the JAX ``gdg_serial``) over ``B``
    shots in lockstep, batch-major: ``syndrome`` [B, m]; ``scan_rank``,
    ``vn_state0`` [B, n]; ``cn_state0``, ``cn_degree0`` [B, m]; ``dead0``
    [B].

    Phase 1 grows the main (all-favored) branch for up to ``max_step``
    depths, pushing one anti-decision snapshot a depth (below
    ``max_side_depth``) onto each shot's queue of ``max_guess`` slots.
    Phase 2 walks the queue in push order: a snapshot deeper than the
    shot's ``min_conv_depth`` is pruned; otherwise its state is restored,
    the messages restart from the priors, the anti-decision is applied and
    the branch runs up to ``max_side_branch_step`` steps. A converging
    branch with a smaller path metric takes over (error, ``min_pm``,
    ``min_conv_depth``); a branch deeper than ``min_conv_depth + 2``
    stops; a branch no deeper than ``max_tree_depth`` pushes snapshots too.
    The history ring (f32, as in JAX) and the running error carry over
    from step to step and from branch to branch.

    The loops run on the host: one read of whether any shot is unfinished
    per main-branch depth (from depth 1 on: a step in which every shot is
    halted changes nothing), of the queue's fill per slot, and of whether
    any branch is active per side-branch step. Each step's BP is one
    masked ``bp_run`` call. Path metrics are ``path_metric``'s exact f64
    sums (module docstring).

    Returns error [B, n] uint8, converged, ``min_pm`` (f32), iterations,
    and the queue trace: ``q_guess``, ``q_val``, ``q_depth`` [B, G] (the
    pushed VN, its anti-value and depth, 1 << 30 where none), ``q_used``
    [B], ``explored`` [B, G] (slots run, not pruned) and ``min_conv_depth``
    [B].
    """
    B, m = syndrome.shape
    n = garr["n"]
    G = max_guess
    dev = syndrome.device
    rows = torch.arange(B, device=dev)
    # the queues hold a trash slot G: a row that does not push writes there
    q_vn = torch.zeros((B, G + 1, n), dtype=torch.int8, device=dev)
    q_cn = torch.zeros((B, G + 1, m), dtype=torch.int8, device=dev)
    q_deg = torch.zeros((B, G + 1, m), dtype=torch.int32, device=dev)
    q_guess = torch.zeros((B, G + 1), dtype=torch.int32, device=dev)
    q_val = torch.zeros((B, G + 1), dtype=torch.int8, device=dev)
    q_depth = torch.full((B, G + 1), 1 << 30, dtype=torch.int32, device=dev)
    used = torch.zeros((B,), dtype=torch.int32, device=dev)

    def push_snapshot(push, vn_state, cn_state, cn_degree, guess_vn, favor, depth):
        slot = torch.where(push, used, G).long()
        q_vn[rows, slot] = vn_state
        q_cn[rows, slot] = cn_state.to(torch.int8)
        q_deg[rows, slot] = cn_degree.to(torch.int32)
        q_guess[rows, slot] = guess_vn.to(torch.int32)
        q_val[rows, slot] = (1 - favor).to(torch.int8)
        q_depth[rows, slot] = torch.as_tensor(depth, dtype=torch.int32, device=dev).expand(B)
        return used + push.to(torch.int32)

    def decide_and_peel(vn_state, cn_state, cn_degree, dead, do_set, guess_vn, value):
        return set_index_and_peel(garr, vn_state, cn_state, cn_degree, dead, guess_vn, value,
                                  do_set)

    def select(history, error, state, active, A: float, A_sum: float, c_allowed):
        def fill(x):
            return torch.full((B,), x, dtype=torch.float32, device=dev)

        return _select_and_decimate(
            garr, _hist_stats(history, -1), error, syndrome, *state, active, fill(A),
            fill(A_sum), c_allowed, low_error_mode=low_error_mode, scan_rank=scan_rank)

    def bp(mv, history, error, done, iters, vn_state, cn_state):
        # the copying form: the batch-major messages and ring are converted
        # to the kernel's layouts at the call anyway
        return bp_run(garr, mv, llr, syndrome, history, error, done, iters,
                      num_iter=num_iter, alpha=alpha, clip=clip, msg_dtype=msg_dtype,
                      vn_state=vn_state, cn_state=cn_state, masked=True)

    mv = bp_init_messages(garr, llr, B)
    history, error, _, iters = fresh_bp_state(garr, B)
    state = (vn_state0, cn_state0, cn_degree0, dead0)
    halted = dead0.clone()
    converged = torch.zeros((B,), dtype=torch.bool, device=dev)
    min_pm = torch.full((B,), MAX_PM, dtype=torch.float64, device=dev)
    best_err = torch.zeros((B, n), dtype=torch.int8, device=dev)
    min_conv_depth = torch.full((B,), max_step, dtype=torch.int32, device=dev)

    # phase 1: the main branch
    for d in range(max_step):
        if d and bool(halted.all()):
            break
        active = ~halted
        mv, history, error, bp_done, iters = bp(mv, history, error, ~active, iters, *state[:2])
        newly = bp_done & active
        min_pm = torch.where(newly, path_metric(llr, error.T), min_pm)
        best_err = torch.where(newly[:, None], error, best_err)
        min_conv_depth = torch.where(newly, d, min_conv_depth)
        converged = converged | newly
        halted = halted | newly
        active = active & ~newly
        *state, guess_vn, favor, has_cand = select(
            history, error, state, active, -3.0, -16.0 if d == 0 else -12.0,
            torch.full((B,), d < 4, dtype=torch.bool, device=dev))
        do_set = active & ~state[3] & has_cand
        used = push_snapshot(do_set & (d < max_side_depth) & (used < G), *state[:3],
                             guess_vn, favor, d + 1)
        state = decide_and_peel(*state, do_set, guess_vn, favor)
        halted = halted | state[3] | (active & ~has_cand)
        error = torch.where(state[0] != -1, state[0], error)

    # unconverged shots keep the main branch's decisions (pyx:293-296)
    best_err = torch.where(converged[:, None], best_err, error)

    # phase 2: the side branches, in push order, with depth pruning
    explored = torch.zeros((B, G), dtype=torch.bool, device=dev)
    i = 0
    while i < G and i < int(used.max()):
        alt_depth = q_depth[:, i]
        valid = (i < used) & (alt_depth <= min_conv_depth)
        explored[:, i] = valid
        state = decide_and_peel(q_vn[:, i], q_cn[:, i], q_deg[:, i], ~valid, valid,
                                q_guess[:, i], q_val[:, i])
        b_active = valid & ~state[3]
        mv = bp_init_messages(garr, llr, B)  # set_masks -> init()
        j = 0
        while j < max_side_branch_step and bool(b_active.any()):
            cur_depth = alt_depth + j
            mv, history, error, bp_done, iters = bp(mv, history, error, ~b_active, iters,
                                                    *state[:2])
            newly = bp_done & b_active
            pm = path_metric(llr, error.T)
            better = newly & (pm < min_pm)
            min_pm = torch.where(better, pm, min_pm)
            best_err = torch.where(better[:, None], error, best_err)
            min_conv_depth = torch.where(better & (cur_depth < min_conv_depth), cur_depth,
                                         min_conv_depth)
            converged = converged | newly
            b_active = b_active & ~newly
            b_active = b_active & ~(cur_depth > min_conv_depth + 2)  # pyx:325-326
            *state, guess_vn, favor, has_cand = select(
                history, error, state, b_active, 0.0, -10.0, cur_depth < 4)
            do_set = b_active & ~state[3] & has_cand
            used = push_snapshot(do_set & (cur_depth <= max_tree_depth)
                                 & (cur_depth <= min_conv_depth) & (used < G),
                                 *state[:3], guess_vn, favor, cur_depth + 1)
            state = decide_and_peel(*state, do_set, guess_vn, favor)
            b_active = do_set & ~state[3]
            error = torch.where(state[0] != -1, state[0], error)
            j += 1
        i += 1

    return {
        "error": best_err.to(torch.uint8),
        "converged": converged,
        "min_pm": min_pm.to(torch.float32),
        "iterations": iters,
        "q_guess": q_guess[:, :G],
        "q_val": q_val[:, :G],
        "q_depth": q_depth[:, :G],
        "q_used": used,
        "explored": explored,
        "min_conv_depth": min_conv_depth,
    }


class GDG:
    """Batched GDG decoder mirroring ``bpgdg_decoder``
    (bp_guessing_decoder.pyx:160-338).

    The constructor is the JAX package's, less ``cn_engine`` (the kernels
    are chosen by shape), plus ``device`` (None means "cuda"; raises
    without a card). ``ensemble_mode``: "fused" (the default) runs
    ``gdg_ensemble``, all ``D_max`` steps of a bucket with no host read
    between the first step and the reduce; with ``ensemble_early_exit``
    it reads one flag a step and stops once every column has finished
    (the JAX while-form). "host_loop" is that early-exit form whatever
    ``ensemble_early_exit`` says (the JAX host-stepped form). "spans" runs
    ``gdg_ensemble_spans`` over ``ensemble_spans`` (default
    ``default_spans``) in buckets of ``row_bucket`` columns, one count
    read a span, with lane dormancy unless a user schedule misses an
    activation depth (then each lane recomputes its prefix); it too stops
    once every column has finished. The forms differ only where a column
    died in a peel and no branch of its shot converged (module docstring).
    ``hist_dtype`` ("float32" or "bfloat16", else ``ValueError``) is the
    ensemble's history ring. ``multi_thread=False`` runs the reference's
    default serial work queue ``gdg_serial`` instead of the ensemble (its
    ring is f32 whatever ``hist_dtype``, as in JAX), with ``max_guess``
    queue slots (pyx:181).

    Shortening decides the n - new_n most reliable columns (by the pre-BP
    history sum) to 0 on the full masked graph, then peels.
    """

    def __init__(
        self,
        pcm,
        channel_probs,
        *,
        max_iter: int = 50,
        max_iter_per_step: int = 6,
        max_step: int = 25,
        max_tree_depth: int = 3,
        max_side_depth: int = 10,
        max_tree_branch_step: int = 10,
        max_side_branch_step: int = 10,
        ms_scaling_factor: float = 1.0,
        gdg_factor: float = 1.0,
        new_n: int | None = None,
        low_error_mode: bool = False,
        clip: float = 50.0,
        ensemble_bucket: int = 64,
        msg_dtype: str = "float32",
        hist_dtype: str = "float32",
        multi_thread: bool = True,
        ensemble_mode: str = "fused",
        ensemble_spans=None,
        row_bucket: int = 2048,
        ensemble_early_exit: bool = False,
        device=None,
    ):
        if ensemble_mode not in ("fused", "host_loop", "spans"):
            raise ValueError("ensemble_mode must be 'fused', 'host_loop' or 'spans'")
        msg_torch_dtype(msg_dtype)  # validates
        hist_torch_dtype(hist_dtype)
        self.device = resolve_device(device)
        pcm = np.asarray(pcm)
        self.m, self.n = pcm.shape
        channel_probs = np.asarray(channel_probs, dtype=np.float64)
        if channel_probs.shape != (self.n,):
            raise ValueError(f"channel_probs must have shape ({self.n},)")
        if np.any((channel_probs <= 0) | (channel_probs >= 1)):
            raise ValueError("channel_probs must lie strictly in (0, 1)")
        self.max_iter = int(max_iter)
        self.alpha = float(ms_scaling_factor)
        self.gdg_factor = float(gdg_factor)
        self.clip = float(clip)
        self.num_iter_per_step = int(max_iter_per_step)
        self.low_error_mode = bool(low_error_mode)
        self.msg_dtype = str(msg_dtype)
        self.hist_dtype = str(hist_dtype)
        self.multi_thread = bool(multi_thread)
        self.max_step = int(max_step)
        self.max_tree_depth = int(max_tree_depth)
        self.max_side_depth = int(max_side_depth)
        self.max_side_branch_step = int(max_side_branch_step)
        # the reference's max_guess (bp_guessing_decoder.pyx:181)
        self.max_guess = 2 * (2**self.max_tree_depth - 1) + self.max_side_depth \
            - self.max_tree_depth
        self.new_n = min(self.n, 2 * self.m) if new_n is None else min(new_n, self.n)
        self.ensemble_bucket = int(ensemble_bucket)
        self.ensemble_mode = ensemble_mode
        self.ensemble_early_exit = bool(ensemble_early_exit)

        self.graph = compile_graph(pcm)
        self.garr = graph_tensors(self.graph, self.device)
        self.llr = np.log((1 - channel_probs) / channel_probs).astype(np.float32)
        self._llr_dev = torch.as_tensor(self.llr, device=self.device)
        self.tables = build_branch_tables(max_step, max_tree_depth, max_side_depth,
                                          max_tree_branch_step, max_side_branch_step)
        self.NB = self.tables["num_branches"]
        self.D_max = self.tables["D_max"]
        self.row_bucket = int(row_bucket)
        # the lane-dormancy plan of the spans form
        self._copy_plan = (self.tables["copy_at"], self.tables["copy_from"])
        if ensemble_spans is None:
            self.ensemble_spans = default_spans(self.D_max, self.tables["budget"].tolist(),
                                                activations=self.tables["copy_at"])
        else:
            self.ensemble_spans = tuple(int(s) for s in ensemble_spans)
            if sum(self.ensemble_spans) != self.D_max:
                raise ValueError(f"ensemble_spans must sum to D_max={self.D_max}")
            bounds = set(np.cumsum((0,) + self.ensemble_spans).tolist())
            if not {int(a) for a in self.tables["copy_at"] if a >= 0} <= bounds:
                # the schedule misses an activation depth: no dormancy, every
                # lane recomputes its prefix (as the JAX package falls back)
                self._copy_plan = None

    def _shorten_state(self, synds, llr_sum):
        """Decide the most reliable n - new_n columns to 0, then peel. Also
        returns each VN's position in the stable ascending argsort of the
        pre-BP history sums ``llr_sum`` [b, n] (the reference's column
        permutation, pyx:263): the scan order that breaks exact ties of
        the guess key."""
        b, n = synds.shape[0], self.n
        state = init_decimation_state(self.garr, synds)
        order = torch.argsort(llr_sum, dim=1, stable=True)
        rank_pos = torch.empty((b, n), dtype=torch.int32, device=synds.device)
        rank_pos.scatter_(1, order, torch.arange(n, dtype=torch.int32,
                                                 device=synds.device).expand(b, n))
        if self.new_n < n:
            state = set_values_and_peel(self.garr, *state, rank_pos >= self.new_n)
        return (*state, rank_pos)

    def core(self, synds):
        """Decode a [B, m] syndrome tensor on the decoder's device: pre-BP
        on the whole batch, then a host walk over buckets of the
        non-converged shots (sorted by syndrome weight, so that a bucket's
        columns finish together), each bucket shortened and run through the
        ensemble (or ``gdg_serial``). One host read of how many shots are
        left, then none inside the fused ensemble (one per step with
        ``ensemble_early_exit``), one per step (host-stepped form) or per
        span (spans form), or the serial queue's; on CPU tensors also the
        plain peels' reads.

        Returns dict: error [B, n] uint8, converged [B] bool, iterations
        [B] int32 (pre-BP plus all branches' burst iterations), min_pm [B]
        f32 (``MAX_PM`` where nothing converged)."""
        B = synds.shape[0]
        synds = synds.to(torch.uint8)
        pre = decode_bp(self.garr, self._llr_dev, synds, num_iter=self.max_iter,
                        alpha=self.alpha, clip=self.clip, msg_dtype=self.msg_dtype)
        converged = pre["converged"]
        error = pre["error"].to(torch.uint8)
        iters = pre["iterations"]
        llr_sum = pre["llr_sum"]
        min_pm = path_metric(self._llr_dev, error.T).to(torch.float32)

        bucket = _divisor_bucket(B, self.ensemble_bucket)
        synd_weight = synds.sum(dim=1, dtype=torch.int32)
        key = converged.to(torch.int32) * (self.m + 2) + synd_weight
        order = torch.argsort(key, stable=True)
        n_todo = int((~converged).sum())
        kw = dict(num_iter=self.num_iter_per_step, alpha=self.gdg_factor, clip=self.clip,
                  low_error_mode=self.low_error_mode, msg_dtype=self.msg_dtype,
                  hist_dtype=self.hist_dtype)
        ensemble = gdg_ensemble
        if self.ensemble_mode == "spans":
            ensemble = gdg_ensemble_spans
            kw.update(spans=self.ensemble_spans, row_bucket=self.row_bucket,
                      copy_plan=self._copy_plan)
        else:  # "fused"; "host_loop" is its early-exit form
            kw.update(early_exit=self.ensemble_early_exit or self.ensemble_mode == "host_loop")
        for b in range(-(-n_todo // bucket)):
            idx = order[b * bucket:(b + 1) * bucket]
            s = synds[idx]
            done_c = converged[idx]
            vn0, cn0, cd0, dead0, rank_pos = self._shorten_state(s, llr_sum[idx])
            if self.multi_thread:
                out = ensemble(self.garr, self._llr_dev, s, rank_pos, vn0, cn0, cd0, dead0,
                               self.tables, **kw)
            else:
                out = gdg_serial(
                    self.garr, self._llr_dev, s, rank_pos, vn0, cn0, cd0, dead0,
                    num_iter=self.num_iter_per_step, max_step=self.max_step,
                    max_tree_depth=self.max_tree_depth, max_side_depth=self.max_side_depth,
                    max_side_branch_step=self.max_side_branch_step,
                    max_guess=self.max_guess, alpha=self.gdg_factor, clip=self.clip,
                    low_error_mode=self.low_error_mode, msg_dtype=self.msg_dtype)
            # boundary buckets may straddle converged shots: keep theirs
            error[idx] = torch.where(done_c[:, None], error[idx], out["error"])
            converged[idx] = done_c | out["converged"]
            min_pm[idx] = torch.where(done_c, min_pm[idx], out["min_pm"])
            iters[idx] = iters[idx] + torch.where(done_c, 0, out["iterations"])
        return {"error": error, "converged": converged, "iterations": iters,
                "min_pm": min_pm}

    def decode_batch(self, syndromes) -> DecodeResult:
        """Host batch API: pad to a power of two (as the JAX package does),
        decode, trim."""
        syndromes, _ = as_batch(syndromes, self.m)
        B = syndromes.shape[0]
        synds = np.zeros((pad_pow2(B), self.m), dtype=np.uint8)
        synds[:B] = syndromes
        out = self.core(torch.as_tensor(synds, device=self.device))
        return DecodeResult(
            error=out["error"][:B].cpu().numpy(),
            converged=out["converged"][:B].cpu().numpy(),
            iterations=out["iterations"][:B].cpu().numpy(),
            min_pm=out["min_pm"][:B].cpu().numpy(),
        )

    def decode(self, syndrome) -> np.ndarray:
        return self.decode_batch(np.asarray(syndrome)[None, :]).error[0]
