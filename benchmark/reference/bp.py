"""Plain normalized min-sum BP for the reference, in torch operations.

A frozen copy of the plain loop of ``slidingwindowdecoder_torch/ops/bp.py``
(``_cn_update_sm``, ``bp_loop``, ``_bp_iterations``, ``history_sum``) at
commit 6c64bcc, with one change: messages are held in float32 and every
value the program stores in its message dtype goes through ``q``, the
rounding to that dtype (round to nearest even, as a bfloat16 tensor op
rounds its float32 result). For float32 ``q`` is the identity and for
bfloat16 the results are those of bfloat16 tensors; the control rounds to
float8 e4m3 (saturating at +-448) through the same code.

Layouts are the port's: check-side edge arrays slot-major [dc, m_pad, B]
(shot index last), the history ring [n, 4, B], VN arrays [n, B].
"""

from __future__ import annotations

import torch

BIG = 1e30
PIN = 1e33
PIN_THRESH = 1e32
EXIT_CHECK_EVERY = 4


def rounding(dtype: str):
    """``q``: float32 -> float32 rounded to the storage ``dtype``."""
    if dtype == "float32":
        return lambda x: x
    if dtype == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if dtype == "float8_e4m3":
        return lambda x: x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown storage dtype {dtype!r}")


def scalar(q, x: float, device):
    return q(torch.tensor(x, dtype=torch.float32, device=device))


def init_messages(g, prior, B: int, q):
    """VN-to-CN messages at entry: each valid slot its variable's prior,
    invalid slots and pad rows 0, [dc, m_pad, B]."""
    base = prior[g["cn_vn_clip"]].reshape(g["dc"], g["m_pad"])
    base = q(torch.where(g["cn_valid_sm"], base, 0.0))
    return base[:, :, None].expand(g["dc"], g["m_pad"], B).contiguous()


def cn_update(mv, valid, parity, *, alpha, clip, pinned, q):
    """Min-sum check update: the first argmin's slot gets min2, every other
    min1; the sign is the check's parity seed times the other slots' signs
    (zero counted negative); messages clipped to +-clip (pins exempt)."""
    valid = valid[:, :, None]
    dev = mv.device
    big = scalar(q, BIG, dev)
    mvc = q(torch.clamp(mv, -clip, clip))
    if pinned:
        mvc = torch.where(mv >= scalar(q, PIN_THRESH, dev), mv, mvc)
    absx = torch.minimum(torch.where(valid, mvc.abs(), big), big)
    neg = valid & (mvc <= 0)
    dc = mv.shape[0]
    min1 = absx[0]
    arg1 = torch.zeros(absx.shape[1:], dtype=torch.int64, device=dev)
    nneg = neg[0].to(torch.int32)
    for s in range(1, dc):
        arg1 = torch.where(absx[s] < min1, s, arg1)
        min1 = torch.minimum(min1, absx[s])
        nneg = nneg + neg[s]
    is_arg = torch.arange(dc, device=dev)[:, None, None] == arg1[None]
    min2 = big.expand(absx.shape[1:])
    for s in range(dc):
        min2 = torch.minimum(min2, torch.where(is_arg[s], big, absx[s]))
    sign_flip = (((parity + nneg) % 2)[None] ^ neg.to(torch.int32)) == 1
    mag = torch.where(is_arg, min2[None], min1[None])
    mc = q(scalar(q, alpha, dev) * torch.where(sign_flip, -mag, mag))
    return torch.where(valid, mc, 0.0)


def bp_loop(g, mv, prior, parity, synd_t, vn_t, hist, err_t, done, iters, *, num_iter: int,
            hist_from: int, alpha: float, clip: float, masked: bool, q, q_hist,
            keep_done: bool = True):
    """Up to ``num_iter`` iterations on the columns not done at entry (a
    done column keeps every input). ``mv`` [dc, m_pad, B] f32 images of
    the stored messages; ``prior`` [n]; ``parity`` (the sign seed) and
    ``synd_t`` [m_pad, B] int32; ``vn_t`` [n, B] int8 (-1 undecided) or
    None; ``hist`` [n, 4, B] written at slot ``i % 4`` from iteration
    ``hist_from`` on through ``q_hist``; ``err_t`` [n, B] int8. Returns
    (mv, hist, err_t, done, iters, decoded syndrome [m_pad, B] int8)."""
    dev = synd_t.device
    B = synd_t.shape[1]
    n, dc, m_pad = g["n"], g["dc"], g["m_pad"]
    sv = g["cn_valid_sm"][:, :, None]
    if masked:
        if vn_t is None:
            vn_t = torch.full((n, B), -1, dtype=torch.int8, device=dev)
        vs_edge = vn_t[g["cn_vn_clip"]].reshape(dc, m_pad, B)
        pinned = (vs_edge != -1) | ~sv
        if keep_done:
            pinned = pinned & ~done
        mv = torch.where(pinned, scalar(q, PIN, dev), mv)
    live = (~done).nonzero()[:, 0]
    kw = dict(num_iter=num_iter, hist_from=hist_from, alpha=alpha, clip=clip, masked=masked,
              q=q, q_hist=q_hist)
    sub = _iterations(g, mv[:, :, live], prior, parity[:, live], synd_t[:, live],
                      None if vn_t is None else vn_t[:, live], hist[:, :, live],
                      err_t[:, live], done[live], iters[live], **kw)
    mv = mv.clone()
    mv[:, :, live] = sub[0]
    hist[:, :, live] = sub[1]
    err_t = err_t.clone()
    err_t[:, live] = sub[2]
    done, iters = done.clone(), iters.clone()
    done[live], iters[live] = sub[3], sub[4]
    sodd = synd_t == 1
    sodd[:, live] = sub[5]
    return mv, hist, err_t, done, iters, sodd.to(torch.int8)


def _iterations(g, mv, prior, parity, synd_t, vn_t, hist, err_t, done, iters, *, num_iter,
                hist_from, alpha, clip, masked, q, q_hist):
    dev = synd_t.device
    B = synd_t.shape[1]
    n, dc, m_pad, dv = g["n"], g["dc"], g["m_pad"], g["dv"]
    valid = g["cn_valid_sm"]
    sv = valid[:, :, None]
    prior_t = prior[:, None].expand(n, B)
    syndrome_odd = synd_t == 1
    fill_row = torch.zeros((1, B), dtype=torch.float32, device=dev)
    sodd = syndrome_odd
    if masked:
        pin = scalar(q, PIN, dev)
        thresh = scalar(q, PIN_THRESH, dev)
        vn_undecided = vn_t == -1
        vn_pin = torch.where(vn_t == 1, -pin, pin)
    for i in range(num_iter):
        if i % EXIT_CHECK_EVERY == 0 and bool(done.all()):
            break
        mc = cn_update(mv, valid, parity, alpha=alpha, clip=clip, pinned=masked, q=q)
        mcv = torch.cat([mc.reshape(dc * m_pad, B), fill_row])[g["vn_from_cn_flat"]]
        mcv = mcv.reshape(n, dv, B)
        acc = mcv[:, 0]
        for j in range(1, dv):  # in f32, slot by slot
            acc = acc + mcv[:, j]
        posterior = prior_t + acc
        post_f = q(posterior)
        if masked:
            post_f = torch.where(vn_undecided, post_f, vn_pin)
        post_edge = post_f[g["cn_vn_clip"]].reshape(dc, m_pad, B)
        if masked:
            mv_new = torch.where(sv & (post_edge.abs() < thresh), q(post_edge - mc), pin)
        else:
            mv_new = q(post_edge - mc)
        err_new = (post_f <= 0).to(torch.int8)
        synd_odd = ((sv & (post_edge <= 0)).sum(dim=0) % 2) == 1
        conv = (synd_odd == syndrome_odd).all(dim=0)
        active = ~done
        mv = torch.where(active, mv_new, mv)
        if i >= hist_from:
            slot = hist[:, i % 4, :]
            write = active & vn_undecided if masked else active
            slot.copy_(torch.where(write, q_hist(posterior), slot))
        err_t = torch.where(active, err_new, err_t)
        sodd = torch.where(active, synd_odd, sodd)
        iters = iters + active.to(torch.int32)
        done = done | conv
    return mv, hist, err_t, done, iters, sodd


def history_sum(hist):
    """[n, 4, B] ring -> [B, n] f32 sum of its slots, slot by slot."""
    return (hist[:, 0] + hist[:, 1] + hist[:, 2] + hist[:, 3]).T


def syndrome_slot_major(g, synd):
    """[B, m] 0/1 -> [m_pad, B] int32, pad rows 0."""
    out = torch.zeros((g["m_pad"], synd.shape[0]), dtype=torch.int32, device=synd.device)
    out[:g["m"]] = synd.T.to(torch.int32)
    return out
