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
dtype, history [n, 4, BN] f32, VN arrays [n, BN], CN arrays [m_pad, BN]
with inert pad rows. Each decimation step is one masked ``bp_run`` burst
(on the card one launch of the pinned fused kernel ``csrc/bp_span.cu``),
the select and aggressive decimation, the guess, two peels and the
side-branch message reinit, then one host read of whether every column has
finished. The JAX package's "fused" (one compiled loop over all steps) and
"host_loop" forms give identical results, so both run this host-stepped
form here.

Not ported (``NotImplementedError``): ``ensemble_mode="spans"`` (row
compaction and lane dormancy), ``multi_thread=False`` (the serial work
queue ``gdg_serial``) and the bfloat16 history ring.

Path metrics (``min_pm`` and the per-shot choice among converged branches)
are the priors of the correction's support summed in float64. Every
partial sum of these priors is exact in float64 (f32 values of bounded
exponent range, at most n of them), so the sum is that of any order,
ascending VN order included, on either device; ``min_pm`` is it rounded
once to float32. The JAX package sums in float32 in XLA's order, so its
``min_pm`` may differ in the last bits, and where two branches' supports
differ but weigh the same, its rounding may pick the other one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.tanner import compile_graph, graph_tensors
from ..ops.bp import bp_init_messages_sm, bp_run, decode_bp, msg_torch_dtype
from ..ops.decimation import (
    init_decimation_state,
    peel,
    peel_t,
    unsatisfied_counts_t,
    vn_set_values,
    vn_set_values_t,
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


def _hist_stats_sm(hist_t):
    """(min, max, sum, all_neg), each [n, B], from the slot-major history
    [n, 4, B]. The sum runs slot by slot, the order of XLA's reduce on the
    CPU (``ops.bp.history_sum``), so that exact ties of the guess key are
    the JAX package's."""
    h = hist_t.float()
    return (
        h.amin(dim=1),
        h.amax(dim=1),
        h[:, 0] + h[:, 1] + h[:, 2] + h[:, 3],
        (h <= 0.0).all(dim=1),
    )


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
    big = torch.tensor(MAX_PM, dtype=torch.float32, device=vn_t.device)
    key_any = torch.where(cand, hist_sum, big)
    key_neg = torch.where(cand & all_neg, hist_sum, big)
    has_neg = (key_neg < big).any(dim=0)
    has_any = (key_any < big).any(dim=0)
    big_i = torch.tensor(1 << 30, dtype=scan_rank_t.dtype, device=vn_t.device)
    kmin_neg = key_neg.amin(dim=0, keepdim=True)
    kmin_any = key_any.amin(dim=0, keepdim=True)
    # scan ranks are distinct within a column, so each argmin is unique
    vn_neg = torch.where(key_neg <= kmin_neg, scan_rank_t, big_i).argmin(dim=0)
    vn_any = torch.where(key_any <= kmin_any, scan_rank_t, big_i).argmin(dim=0)
    guess_vn = torch.where(has_neg, vn_neg, vn_any)
    favor = torch.where(has_neg, True, kmin_any[0] <= 0.0).to(torch.int8)

    vn_t, cn_t, deg_t, dead = vn_set_values_t(garr, vn_t, cn_t, deg_t, dead, agg,
                                              mA.to(torch.int8))
    vn_t, cn_t, deg_t, dead = peel_t(garr, vn_t, cn_t, deg_t, dead)
    return vn_t, cn_t, deg_t, dead, guess_vn, favor, has_neg | has_any


def _ensemble_init(garr, llr, syndrome, scan_rank, vn_state0, cn_state0, cn_degree0,
                   dead0, NB: int, msg_dtype: str = "float32"):
    """Tile per-shot state over the NB branch columns (each shot's columns
    consecutive). ``syndrome`` [BK, m]; ``scan_rank``, ``vn_state0`` [BK,
    n]; ``cn_state0``, ``cn_degree0`` [BK, m]; ``dead0`` [BK]. Returns
    (carry, synd [m_pad, BN] int8, scan rank [n, BN])."""
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
        # a broadcast view: bp_span reads it through its strides
        "mv": bp_init_messages_sm(garr, llr, BN, msg_dtype),
        "history": torch.zeros((n, 4, BN), dtype=torch.float32, device=dev),
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
                   msg_dtype: str):
    """One ensemble decimation step (the JAX ``_ensemble_step``): masked BP
    burst, select_vn, decimate, peel, side-branch message reinit. Updates
    ``carry`` in place of its entries. ``reinit_any``: whether any branch
    reinitializes its messages at depth ``d`` (a host bool)."""
    c = carry
    active = ~c["halted"] & (d < tt["budget_row"])

    # masked BP burst; tail history: only the burst's last 4 iterations
    # write the ring, which the select reads for rows still active
    mv, history, error, bp_done, iters, synd_hat = bp_run(
        garr, c["mv"], llr, synd, c["history"], c["error"], ~active, c["iters"],
        num_iter=num_iter, alpha=alpha, clip=clip, msg_dtype=msg_dtype,
        return_synd=True, io_layout="slot_major", history_mode="tail",
        hist_update="slice", state_layout="transposed", vn_state=c["vn"],
        cn_state=c["cn"], masked=True,
    )
    newly_conv = bp_done & active
    conv_error = torch.where(newly_conv[None, :], error, c["conv_error"])
    converged = c["converged"] | newly_conv
    halted = c["halted"] | newly_conv
    active = active & ~newly_conv

    vn, cn, deg, dead, guess_vn, favor, has_cand = _select_and_decimate_t(
        garr, _hist_stats_sm(history), synd, c["vn"], c["cn"], c["deg"], c["dead"],
        active, tt["AT"][d], tt["AsumT"][d], d < 4, low_error_mode=low_error_mode,
        synd_hat_t=synd_hat, scan_rank_t=scan_rank,
    )
    # no candidate: the branch ends (the reference's guess_vn == -1 break)
    halted = halted | (active & ~has_cand)

    # the decision: the favored value, flipped where this branch flips
    value = favor ^ tt["flipT"][d].to(torch.int8)
    do_set = active & ~halted & ~dead
    n, BN = vn.shape
    rows = torch.arange(n, device=vn.device)[:, None]
    onehot = (rows == guess_vn[None, :]) & do_set[None, :]
    vn, cn, deg, dead = vn_set_values_t(garr, vn, cn, deg, dead, onehot,
                                        value[None, :].expand(n, BN))
    vn, cn, deg, dead = peel_t(garr, vn, cn, deg, dead)
    halted = halted | dead

    # side branches restart their messages from the priors at their flip
    if reinit_any:
        re = tt["reinitT"][d] & do_set
        mv = torch.where(re[None, None, :], bp_init_messages_sm(garr, llr, BN, msg_dtype), mv)

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


def gdg_ensemble_hostloop(
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
):
    """Host-stepped branch ensemble over ``BK`` shots (``syndrome`` [BK,
    m]): up to ``D_max`` ``_ensemble_step`` calls, stopping after the
    first step at whose end every column has finished (halted, or its
    step budget spent), then ``_ensemble_reduce``. ``tables``: the output
    of ``build_branch_tables``.

    The same results as the JAX ``gdg_ensemble`` (which runs all D_max
    steps; a finished column changes no output) and
    ``gdg_ensemble_hostloop``."""
    BK = syndrome.shape[0]
    NB, D_max = tables["num_branches"], tables["D_max"]
    carry, synd, rank_b = _ensemble_init(garr, llr, syndrome, scan_rank, vn_state0,
                                         cn_state0, cn_degree0, dead0, NB, msg_dtype)
    tt = tile_branch_tables(tables, BK, syndrome.device)
    reinit_any = tables["reinit"].any(axis=0)
    for d in range(D_max):
        carry = _ensemble_step(
            garr, llr, synd, rank_b, tt, bool(reinit_any[d]), d, carry,
            num_iter=num_iter, alpha=alpha, clip=clip, low_error_mode=low_error_mode,
            msg_dtype=msg_dtype,
        )
        if bool((carry["halted"] | (d + 1 >= tt["budget_row"])).all()):
            break
    return _ensemble_reduce(carry, llr, BK, NB)


class GDG:
    """Batched GDG decoder mirroring ``bpgdg_decoder``
    (bp_guessing_decoder.pyx:160-338), multi-thread form.

    The constructor is the JAX package's, less ``cn_engine`` (the kernels
    are chosen by shape), ``ensemble_early_exit`` (the host-stepped form
    always stops when every column has finished; the results are the
    same), ``ensemble_spans`` and ``row_bucket`` (spans form only), plus
    ``device`` (None means "cuda"; raises without a card).
    ``ensemble_mode`` "fused" and "host_loop" both run
    ``gdg_ensemble_hostloop``; "spans", ``multi_thread=False`` and
    ``hist_dtype="bfloat16"`` raise ``NotImplementedError``.

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
        device=None,
    ):
        if ensemble_mode not in ("fused", "host_loop", "spans"):
            raise ValueError("ensemble_mode must be 'fused', 'host_loop' or 'spans'")
        if ensemble_mode == "spans":
            raise NotImplementedError("ensemble_mode='spans' is not ported")
        if not multi_thread:
            raise NotImplementedError("multi_thread=False (gdg_serial) is not ported")
        if hist_dtype != "float32":
            raise NotImplementedError("only the float32 history ring is ported")
        msg_torch_dtype(msg_dtype)  # validates
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
        self.new_n = min(self.n, 2 * self.m) if new_n is None else min(new_n, self.n)
        self.ensemble_bucket = int(ensemble_bucket)
        self.ensemble_mode = ensemble_mode

        self.graph = compile_graph(pcm)
        self.garr = graph_tensors(self.graph, self.device)
        self.llr = np.log((1 - channel_probs) / channel_probs).astype(np.float32)
        self._llr_dev = torch.as_tensor(self.llr, device=self.device)
        self.tables = build_branch_tables(max_step, max_tree_depth, max_side_depth,
                                          max_tree_branch_step, max_side_branch_step)
        self.NB = self.tables["num_branches"]
        self.D_max = self.tables["D_max"]

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
            drop = rank_pos >= self.new_n
            state = vn_set_values(self.garr, *state, drop,
                                  torch.zeros((b, n), dtype=torch.int8, device=synds.device))
            state = peel(self.garr, *state)
        return (*state, rank_pos)

    def core(self, synds):
        """Decode a [B, m] syndrome tensor on the decoder's device: pre-BP
        on the whole batch, then a host walk over buckets of the
        non-converged shots (sorted by syndrome weight, so that a bucket's
        columns finish together), each bucket shortened and run through the
        ensemble. One host read of how many shots are left, then one per
        ensemble step.

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
        for b in range(-(-n_todo // bucket)):
            idx = order[b * bucket:(b + 1) * bucket]
            s = synds[idx]
            done_c = converged[idx]
            vn0, cn0, cd0, dead0, rank_pos = self._shorten_state(s, llr_sum[idx])
            out = gdg_ensemble_hostloop(
                self.garr, self._llr_dev, s, rank_pos, vn0, cn0, cd0, dead0, self.tables,
                num_iter=self.num_iter_per_step, alpha=self.gdg_factor, clip=self.clip,
                low_error_mode=self.low_error_mode, msg_dtype=self.msg_dtype,
            )
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
