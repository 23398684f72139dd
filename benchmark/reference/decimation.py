"""Plain decide-and-peel for the reference, in torch operations.

A frozen copy of the plain pair of ``slidingwindowdecoder_torch/ops/
decimation.py`` at commit 6c64bcc (``init_decimation_state``,
``vn_set_values(_t)``, ``_sweep(_t)``, ``_peel_loop``, ``_plain_decision``,
``unsatisfied_counts_t``): deciding a variable flips the parity of its
active checks and lowers their degrees; a check left with no undecided
neighbour must be satisfied (else the branch is dead) and goes inactive;
degree-1 checks force their last neighbour, sweep after sweep, while a
live column forced one. Batch-major [B, n] / [B, m] and the GDG
ensemble's transposed [n, B] / [m_pad, B] forms (pad rows inert).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_state(g, syndrome):
    B = syndrome.shape[0]
    dev = syndrome.device
    return (torch.full((B, g["n"]), -1, dtype=torch.int8, device=dev),
            syndrome.to(torch.int8),
            g["cn_degree"].to(torch.int32)[None].expand(B, g["m"]).clone(),
            torch.zeros((B,), dtype=torch.bool, device=dev))


def set_values(g, vn, cn, deg, dead, set_mask, values):
    values = values.to(torch.int8)
    dead = dead | (set_mask & (vn != -1) & (vn != values)).any(dim=-1)
    newly = set_mask & (vn == -1)
    vn = torch.where(newly, values, vn)
    enc = newly.to(torch.int8) + (newly & (values == 1)).to(torch.int8)
    enc_e = F.pad(enc, (0, 1))[:, g["cn_vn"].long()] * g["cn_valid"].to(torch.int8)
    active = cn != -1
    delta = (enc_e != 0).sum(dim=-1, dtype=torch.int32)
    flip = (enc_e == 2).sum(dim=-1, dtype=torch.int32) % 2
    new_deg = deg - delta
    new_par = torch.where(active, cn ^ flip.to(torch.int8), cn)
    hit_zero = active & (new_deg == 0) & (delta > 0)
    dead = dead | (hit_zero & (new_par == 1)).any(dim=-1)
    return vn, new_par.masked_fill(hit_zero & (new_par == 0), -1), new_deg, dead


def _sweep(g, vn, cn, deg, dead):
    deg1 = (cn != -1) & (deg == 1)
    code = deg1.to(torch.int8) + (deg1 & (cn == 1)).to(torch.int8)
    code_e = F.pad(code, (0, 1))[:, g["vn_cn"].long()] * g["vn_valid"].to(torch.int8)
    undecided = (vn == -1)[:, :, None]
    force1 = ((code_e == 2) & undecided).any(dim=-1)
    force0 = ((code_e == 1) & undecided).any(dim=-1)
    dead = dead | (force0 & force1).any(dim=-1)
    forced = (force0 ^ force1) & (vn == -1)
    vn, cn, deg, dead = set_values(g, vn, cn, deg, dead, forced, force1.to(torch.int8))
    return vn, cn, deg, dead, (forced.any(dim=-1) & ~dead).any()


def set_values_t(g, vn, cn, deg, dead, set_mask, values):
    values = values.to(torch.int8)
    dead = dead | (set_mask & (vn != -1) & (vn != values)).any(dim=0)
    newly = set_mask & (vn == -1)
    vn = torch.where(newly, values, vn)
    enc = newly.to(torch.int16) * (1 + 64 * (values == 1).to(torch.int16))
    src = torch.cat([enc, enc.new_zeros((1, enc.shape[1]))])
    packed = src[g["cn_vn_fill"]].reshape(g["dc"], g["m_pad"], -1).sum(dim=0,
                                                                       dtype=torch.int16)
    delta = (packed & 63).to(torch.int32)
    pflip = ((packed >> 6) & 1).to(torch.int8)
    active = cn != -1
    new_deg = deg - delta
    new_par = torch.where(active, cn ^ pflip, cn)
    hit_zero = active & (new_deg == 0) & (delta > 0)
    dead = dead | (hit_zero & (new_par == 1)).any(dim=0)
    return vn, new_par.masked_fill(hit_zero & (new_par == 0), -1), new_deg, dead


def _sweep_t(g, vn, cn, deg, dead):
    deg1 = (cn != -1) & (deg == 1)
    code = deg1.to(torch.int8) + (deg1 & (cn == 1)).to(torch.int8)
    acc = None
    for cols in g["vn_cn_cols"]:  # OR over each VN's checks
        acc = code[cols] if acc is None else acc | code[cols]
    undecided = vn == -1
    force1 = (acc & 2).bool() & undecided
    force0 = (acc & 1).bool() & undecided
    dead = dead | (force0 & force1).any(dim=0)
    forced = force0 ^ force1
    vn, cn, deg, dead = set_values_t(g, vn, cn, deg, dead, forced, force1)
    return vn, cn, deg, dead, (forced.any(dim=0) & ~dead).any()


def decide_and_peel(g, state, transposed: bool, set_mask=None, values=None, index=None,
                    value=None, do_set=None):
    """The decision (a mask with values, None: all 0; or one VN ``index``
    with ``value`` where ``do_set``, per column), then degree-1 forcing to
    the fixpoint, one host read a sweep."""
    vn = state[0]
    if index is not None:
        vns = torch.arange(g["n"], device=vn.device)
        if transposed:
            set_mask = (vns[:, None] == index[None, :]) & do_set[None, :]
            values = value[None, :].expand(vn.shape)
        else:
            set_mask = (vns[None, :] == index[:, None]) & do_set[:, None]
            values = value[:, None].expand(vn.shape)
    elif values is None:
        values = torch.zeros_like(vn)
    state = (set_values_t if transposed else set_values)(g, *state, set_mask, values)
    sweep = _sweep_t if transposed else _sweep
    *state, more = sweep(g, *state)
    while bool(more):
        *state, more = sweep(g, *state)
    return tuple(state)


def unsatisfied_counts_t(g, synd_hat_t, syndrome_t, cn_t):
    """Per VN [n, B], its active checks whose decoded bit differs."""
    unsat = ((synd_hat_t.to(torch.int32) != syndrome_t.to(torch.int32))
             & (cn_t != -1)).to(torch.int8)
    acc = None
    for cols in g["vn_cn_cols"]:
        acc = unsat[cols] if acc is None else acc + unsat[cols]
    return acc.to(torch.int32)
