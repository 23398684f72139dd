"""Batched guided-decimation primitives: vn_set_values and peel, in PyTorch.

The counterpart of the batch-major forms of the JAX package's
``ops/decimation.py`` (the reference's graph-peeling state machine,
bpgd.cpp:13-80 and osd_window.pyx:306-368): deciding a variable flips the
parity of its active checks and decrements their degrees; a check whose
degree hits zero must be satisfied (else the branch is contradicted, or
dead) and is deactivated; degree-1 checks force their unique undecided
neighbor, applied to a fixpoint.

State is batched ([B, n] / [B, m]) with values:
  vn_state: -1 undecided, 0/1 decided (int8);
  cn_state: -1 inactive, 0/1 residual parity (int8);
  cn_degree: number of undecided neighbors of each active check (int32);
  dead: branch contradiction flag (bool).

All decisions of a sweep apply at once and conflicts set ``dead``; a dead
branch's state is never used. Every op is integer arithmetic, so the
results are bit-identical to the JAX package's. The JAX fixpoint loop
(``lax.while_loop``) becomes a host loop that reads one scalar, whether
another sweep is needed, per sweep.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_decimation_state(garr, syndrome):
    """Fresh state: all VNs undecided, all CNs active with syndrome parity."""
    B = syndrome.shape[0]
    n, m = garr["n"], garr["m"]
    dev = syndrome.device
    vn_state = torch.full((B, n), -1, dtype=torch.int8, device=dev)
    cn_state = syndrome.to(torch.int8)
    cn_degree = garr["cn_degree"].to(torch.int32)[None].expand(B, m).clone()
    dead = torch.zeros((B,), dtype=torch.bool, device=dev)
    return vn_state, cn_state, cn_degree, dead


def vn_set_values(garr, vn_state, cn_state, cn_degree, dead, set_mask, values):
    """Decide a set of VNs at once (``values``: [B, n] 0/1, applied where
    ``set_mask``). Returns updated (vn_state, cn_state, cn_degree, dead)."""
    values = values.to(torch.int8)

    # conflicts on already-decided VNs
    already = set_mask & (vn_state != -1)
    conflict = already & (vn_state != values)
    dead = dead | conflict.any(dim=-1)
    newly = set_mask & (vn_state == -1)
    vn_state = torch.where(newly, values, vn_state)

    # one int8 edge gather: 0 = untouched, 1 = set to 0, 2 = set to 1; the
    # pad index n reads the appended zero column
    enc = newly.to(torch.int8) + (newly & (values == 1)).to(torch.int8)
    enc_e = F.pad(enc, (0, 1))[:, garr["cn_vn"].long()] * garr["cn_valid"].to(torch.int8)

    active = cn_state != -1
    delta_deg = (enc_e != 0).sum(dim=-1, dtype=torch.int32)
    parity_flip = (enc_e == 2).sum(dim=-1, dtype=torch.int32) % 2
    new_degree = cn_degree - delta_deg
    new_parity = torch.where(active, cn_state ^ parity_flip.to(torch.int8), cn_state)

    hit_zero = active & (new_degree == 0) & (delta_deg > 0)
    contradiction = hit_zero & (new_parity == 1)
    dead = dead | contradiction.any(dim=-1)
    cn_state = torch.where(hit_zero & (new_parity == 0),
                           torch.tensor(-1, dtype=torch.int8, device=cn_state.device),
                           new_parity)
    return vn_state, cn_state, new_degree, dead


def _sweep(garr, vn_state, cn_state, cn_degree, dead):
    """One forcing sweep; returns the new state and whether any live shot
    forced a VN (one scalar, still on the device)."""
    deg1 = (cn_state != -1) & (cn_degree == 1)
    # from the VN side, one int8 gather: 0 = not forcing, 1 = degree-1
    # parity 0, 2 = degree-1 parity 1; the pad index m reads a zero column
    code = deg1.to(torch.int8) + (deg1 & (cn_state == 1)).to(torch.int8)
    code_e = F.pad(code, (0, 1))[:, garr["vn_cn"].long()] * garr["vn_valid"].to(torch.int8)
    undecided = (vn_state == -1)[:, :, None]
    force1 = ((code_e == 2) & undecided).any(dim=-1)
    force0 = ((code_e == 1) & undecided).any(dim=-1)
    dead = dead | (force0 & force1).any(dim=-1)
    forced = (force0 ^ force1) & (vn_state == -1)
    vn_state, cn_state, cn_degree, dead = vn_set_values(
        garr, vn_state, cn_state, cn_degree, dead, forced, force1.to(torch.int8),
    )
    more = (forced.any(dim=-1) & ~dead).any()
    return vn_state, cn_state, cn_degree, dead, more


def peel(garr, vn_state, cn_state, cn_degree, dead):
    """Iterate degree-1 forcing to a fixpoint.

    Each productive sweep decides at least one VN, so the loop ends. Each
    sweep ends in one device-to-host read of ``more``.
    """
    *state, more = _sweep(garr, vn_state, cn_state, cn_degree, dead)
    while bool(more):
        *state, more = _sweep(garr, *state)
    return tuple(state)
