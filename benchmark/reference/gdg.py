"""The reference of the ``gdg`` configurations: guided decimation with
guessing per window, as a branch ensemble of plain torch operations.

A frozen copy of the plain path of ``slidingwindowdecoder_torch/decoders/
gdg.py`` at commit 6c64bcc in its default "fused" form (``GDG.core``,
``_shorten_state``, ``build_branch_tables``, ``_ensemble_init``,
``_ensemble_step``, ``_select_and_decimate_t``, ``_hist_stats``,
``_ensemble_reduce``, ``path_metric``), over the plain BP and
decide-and-peel of this folder: a whole-batch pre-BP, then the shots it
left unconverged, sorted by syndrome weight, in buckets; each bucket
shortened (the most reliable columns decided 0 and peeled) and run as
one ensemble of main, tree, tree-side and side branches for every one of
``D_max`` steps (masked BP burst, the C/D/A aggressive decimation and the
guess, each decided and peeled, side-branch message restart), then the
per-shot least-metric converged branch, else the main branch.

Peels sweep while any live column of the bucket forces, and a column that
died keeps being swept; the result of a shot none of whose branches
converged can depend on its bucket's other shots. So this reference, as
the program, decodes a whole batch and its buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bp
from .decimation import decide_and_peel, init_state, unsatisfied_counts_t
from .tanner import graph_tables

MAX_PM = 1e4
CLIP = 50.0


def divisor_bucket(B: int, want: int) -> int:
    want = max(1, min(want, B))
    return next(d for d in range(want, 0, -1) if B % d == 0)


def branch_tables(max_step, td, sd, tree_step, side_step):
    branches = [(frozenset(), max_step, -1)]
    for tid in range(1, 2**td):
        bits = {d for d in range(td) if (tid >> (td - 1 - d)) & 1}
        branches.append((frozenset(bits), tree_step + td + 1, -1))
    for tid in range(1, 2**td):
        bits = {d for d in range(td) if (tid >> (td - 1 - d)) & 1}
        branches.append((frozenset(bits | {td}), td + 1 + tree_step, td))
    for j in range(sd - td):
        fd = td + j
        branches.append((frozenset({fd}), fd + 1 + side_step, fd))
    NB = len(branches)
    D_max = max(b[1] for b in branches)
    flip = np.zeros((NB, D_max), dtype=bool)
    reinit = np.zeros((NB, D_max), dtype=bool)
    budget = np.zeros(NB, dtype=np.int32)
    A = np.zeros((NB, D_max), dtype=np.float32)
    A_sum = np.zeros((NB, D_max), dtype=np.float32)
    for b, (bits, bud, rd) in enumerate(branches):
        budget[b] = bud
        first = min(bits) if bits else D_max + 1
        for d in range(D_max):
            flip[b, d] = d in bits
            side = d > first
            A[b, d] = 0.0 if side else -3.0
            A_sum[b, d] = -10.0 if side else (-16.0 if d == 0 else -12.0)
        if rd >= 0:
            reinit[b, rd] = True
    return {"flip": flip, "reinit": reinit, "budget": budget, "A": A, "A_sum": A_sum,
            "NB": NB, "D_max": D_max}


class Decoder:
    def __init__(self, mat, prior, knobs: dict, device, msg_dtype: str | None = None):
        self.g = graph_tables(mat, device)
        self.m, self.n = mat.shape
        probs = np.asarray(prior, dtype=np.float64)
        self.llr = torch.as_tensor(np.log((1 - probs) / probs).astype(np.float32),
                                   device=device)
        self.pre_iter = int(knobs["max_iter"])
        self.step_iter = int(knobs.get("max_iter_per_step", 6))
        self.alpha = float(knobs.get("ms_scaling_factor", 1.0))
        self.gdg_factor = float(knobs.get("gdg_factor", 1.0))
        self.bucket = int(knobs["ensemble_bucket"])
        self.q = bp.rounding(msg_dtype or knobs.get("msg_dtype", "float32"))
        self.q_hist = bp.rounding(knobs.get("hist_dtype", "float32"))
        self.tables = branch_tables(int(knobs.get("max_step", 25)),
                                    int(knobs.get("max_tree_depth", 3)),
                                    int(knobs.get("max_side_depth", 10)),
                                    int(knobs.get("max_tree_branch_step", 10)),
                                    int(knobs.get("max_side_branch_step", 10)))
        self.new_n = min(self.n, 2 * self.m)

    def decode(self, synds):
        g, B, n, m = self.g, synds.shape[0], self.n, self.m
        dev = synds.device
        synd_t = bp.syndrome_slot_major(g, synds)
        _, hist, err_t, done, _, _ = bp.bp_loop(
            g, bp.init_messages(g, self.llr, B, self.q), self.llr, synd_t, synd_t, None,
            torch.zeros((n, 4, B), dtype=torch.float32, device=dev),
            torch.zeros((n, B), dtype=torch.int8, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            num_iter=self.pre_iter, hist_from=0, alpha=self.alpha, clip=CLIP, masked=False,
            q=self.q, q_hist=self.q_hist)
        error = err_t.T.to(torch.uint8).contiguous()
        llr_sum = bp.history_sum(hist)
        bucket = divisor_bucket(B, self.bucket)
        key = done.to(torch.int32) * (m + 2) + synds.sum(dim=1, dtype=torch.int32)
        order = torch.argsort(key, stable=True)
        n_todo = int((~done).sum())
        for b in range(-(-n_todo // bucket)):
            idx = order[b * bucket:(b + 1) * bucket]
            s = synds[idx]
            state, rank_pos = self._shorten(s, llr_sum[idx])
            out = self._ensemble(s, rank_pos, *state)
            error[idx] = torch.where(done[idx][:, None], error[idx], out)
        return error

    def _shorten(self, s, llr_sum):
        b, n = s.shape[0], self.n
        state = init_state(self.g, s)
        order = torch.argsort(llr_sum, dim=1, stable=True)
        rank_pos = torch.empty((b, n), dtype=torch.int32, device=s.device)
        rank_pos.scatter_(1, order, torch.arange(n, dtype=torch.int32,
                                                 device=s.device).expand(b, n))
        if self.new_n < n:
            state = decide_and_peel(self.g, state, False, set_mask=rank_pos >= self.new_n)
        return state, rank_pos

    def _ensemble(self, syndrome, scan_rank, vn0, cn0, deg0, dead0):
        g, tb = self.g, self.tables
        NB, D_max = tb["NB"], tb["D_max"]
        BK, m = syndrome.shape
        n, m_pad = self.n, g["m_pad"]
        dev = syndrome.device
        BN = BK * NB

        def tile(x_t):
            return x_t.repeat_interleave(NB, dim=-1)

        def pad_cn(x, fill, dtype):
            out = torch.full((m_pad, BK), fill, dtype=dtype, device=dev)
            out[:m] = x.T.to(dtype)
            return out

        def tile_cols(a):
            return torch.as_tensor(np.tile(np.asarray(a).T, (1, BK)), device=dev)

        flipT, reinitT = tile_cols(tb["flip"]), tile_cols(tb["reinit"])
        AT, AsumT = tile_cols(tb["A"]), tile_cols(tb["A_sum"])
        budget = torch.as_tensor(np.tile(tb["budget"], BK), device=dev)
        reinit_any = tb["reinit"].any(axis=0)
        init_mv = bp.init_messages(g, self.llr, BN, self.q)
        dead = dead0.repeat_interleave(NB)
        c = {"mv": init_mv.clone(),
             "history": torch.zeros((n, 4, BN), dtype=torch.float32, device=dev),
             "error": torch.zeros((n, BN), dtype=torch.int8, device=dev),
             "vn": tile(vn0.T.to(torch.int8)), "cn": tile(pad_cn(cn0, -1, torch.int8)),
             "deg": tile(pad_cn(deg0, 0, torch.int32)), "dead": dead,
             "halted": dead.clone(),
             "converged": torch.zeros((BN,), dtype=torch.bool, device=dev),
             "conv_error": torch.zeros((n, BN), dtype=torch.int8, device=dev),
             "iters": torch.zeros((BN,), dtype=torch.int32, device=dev)}
        synd = tile(pad_cn(syndrome, 0, torch.int8))
        rank_b = tile(scan_rank.T.to(torch.int32))
        synd32 = synd.to(torch.int32)
        for d in range(D_max):
            active = ~c["halted"] & (d < budget)
            mv, history, error, bp_done, iters, synd_hat = bp.bp_loop(
                g, c["mv"], self.llr, c["cn"].to(torch.int32).clamp_min(0), synd32, c["vn"],
                c["history"], c["error"], ~active, c["iters"], num_iter=self.step_iter,
                hist_from=max(self.step_iter - 4, 0), alpha=self.gdg_factor, clip=CLIP,
                masked=True, q=self.q, q_hist=self.q_hist, keep_done=True)
            newly = bp_done & active
            conv_error = torch.where(newly[None, :], error, c["conv_error"])
            converged = c["converged"] | newly
            halted = c["halted"] | newly
            active = active & ~newly
            vn, cn, deg, dead, guess, favor, has_cand = self._select(
                history, synd, c["vn"], c["cn"], c["deg"], c["dead"], active, AT[d],
                AsumT[d], d < 4, synd_hat, rank_b)
            halted = halted | (active & ~has_cand)
            value = favor ^ flipT[d].to(torch.int8)
            do_set = active & ~halted & ~dead
            vn, cn, deg, dead = decide_and_peel(g, (vn, cn, deg, dead), True, index=guess,
                                                value=value, do_set=do_set)
            halted = halted | dead
            if reinit_any[d]:
                mv = torch.where((reinitT[d] & do_set)[None, None, :], init_mv, mv)
            error = torch.where(vn != -1, vn, error)
            c.update(mv=mv, history=history, error=error, vn=vn, cn=cn, deg=deg, dead=dead,
                     halted=halted, converged=converged, conv_error=conv_error, iters=iters)
        conv_b = c["converged"].view(BK, NB)
        pm = ((c["conv_error"] == 1).to(torch.float64).T @ self.llr.to(torch.float64))
        key = torch.where(conv_b, pm.view(BK, NB), MAX_PM)
        kmin = key.amin(dim=1)
        lanes = torch.arange(NB, device=dev)
        best = torch.where(key == kmin[:, None], lanes, NB).amin(dim=1)
        best_err = c["conv_error"].view(n, BK, NB).gather(
            2, best[None, :, None].expand(n, BK, 1))[:, :, 0]
        main_err = c["error"].view(n, BK, NB)[:, :, 0]
        return torch.where(conv_b.any(dim=1)[None, :], best_err, main_err).T.to(torch.uint8)

    def _select(self, history, synd_t, vn_t, cn_t, deg_t, dead, active, A_row, A_sum_row,
                c_allowed, synd_hat_t, scan_rank_t):
        g = self.g
        h = history.float()
        s = [h[:, k] for k in range(4)]
        hist_min, hist_max = h.amin(dim=1), h.amax(dim=1)
        hist_sum, all_neg = s[0] + s[1] + s[2] + s[3], (h <= 0.0).all(dim=1)
        eligible = (vn_t == -1) & (g["vn_degree"][:, None] > 2) & active[None, :]
        num_flip = unsatisfied_counts_t(g, synd_hat_t, synd_t, cn_t)
        mC = eligible & (hist_min >= 30.0) & c_allowed
        mD = eligible & ~mC & (num_flip >= 3) & (hist_min >= 3.0)
        mA = (eligible & ~mC & ~mD & (hist_max <= A_row[None, :])
              & (hist_sum < A_sum_row[None, :]))
        agg = mC | mD | mA
        cand = eligible & ~agg
        key_any = torch.where(cand, hist_sum, MAX_PM)
        key_neg = torch.where(cand & all_neg, hist_sum, MAX_PM)
        has_neg = (key_neg < MAX_PM).any(dim=0)
        has_any = (key_any < MAX_PM).any(dim=0)
        kmin_neg = key_neg.amin(dim=0, keepdim=True)
        kmin_any = key_any.amin(dim=0, keepdim=True)
        vn_neg = torch.where(key_neg <= kmin_neg, scan_rank_t, 1 << 30).argmin(dim=0)
        vn_any = torch.where(key_any <= kmin_any, scan_rank_t, 1 << 30).argmin(dim=0)
        guess = torch.where(has_neg, vn_neg, vn_any)
        favor = torch.where(has_neg, True, kmin_any[0] <= 0.0).to(torch.int8)
        vn_t, cn_t, deg_t, dead = decide_and_peel(g, (vn_t, cn_t, deg_t, dead), True,
                                                  set_mask=agg, values=mA)
        return vn_t, cn_t, deg_t, dead, guess, favor, has_neg | has_any
