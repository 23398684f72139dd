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
results are bit-identical to the JAX package's. The decoders decide and
then peel (the JAX package's ``vn_set_values`` followed by its fixpoint
loop ``lax.while_loop``, which XLA fuses): ``set_values_and_peel(_t)``
takes the decision as a mask with values, ``set_index_and_peel(_t)`` as
one VN index, value and do-set flag a column, and ``peel(_t)`` takes none.
On the card each is one launch of the hand-written kernel ``csrc/peel.cu``
(``ops.peel_cuda``), with no host read; their plain versions, run on CPU
tensors, are ``vn_set_values(_t)`` and a host loop that reads one scalar,
whether another sweep is needed, once per sweep. ``vn_set_values.card_calls``
counts the calls of ``vn_set_values(_t)``'s torch ops on a card's tensors,
which no decoding path makes. The ``_t`` forms take their gathers slot by
slot or in one packed pass where the JAX forms write whole per-edge arrays
twice; the integers are the same.

The transposed (batch-minor) ``_t`` forms are those of the GDG ensemble:
VN arrays [n, B], CN arrays [m_pad, B] whose pad rows are inert (state -1,
degree 0), so ``vn_cn``'s dummy index m reads a pad row of zeros.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import peel_cuda
from .bp import check_syndrome


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


def _count_card_call(x):
    if x.device.type != "cpu":
        vn_set_values.card_calls += 1


def vn_set_values(garr, vn_state, cn_state, cn_degree, dead, set_mask, values):
    """Decide a set of VNs at once (``values``: [B, n] 0/1, applied where
    ``set_mask``). Returns updated (vn_state, cn_state, cn_degree, dead)."""
    _count_card_call(vn_state)
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
    cn_state = new_parity.masked_fill(hit_zero & (new_parity == 0), -1)
    return vn_state, cn_state, new_degree, dead


vn_set_values.card_calls = 0


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


def peel(garr, vn_state, cn_state, cn_degree, dead, max_sweeps: int | None = None):
    """Iterate degree-1 forcing to a fixpoint (the JAX ``peel``).

    One sweep, then another while a live shot forced a VN in the last one,
    at most ``max_sweeps`` in all (None: to the fixpoint; each productive
    sweep decides at least one VN, so the loop ends). On CUDA tensors one
    launch of ``csrc/peel.cu`` with no decision (``ops.peel_cuda.
    peel_fixpoint``, no host read); on CPU tensors the plain loop
    ``_peel_loop``.
    """
    return _peel(garr, (vn_state, cn_state, cn_degree, dead), False, max_sweeps)


def set_values_and_peel(garr, vn_state, cn_state, cn_degree, dead, set_mask, values=None,
                        max_sweeps: int | None = None):
    """``vn_set_values`` (``values`` None: all 0) and then ``peel``, the
    pair the JAX decoders run: on CUDA tensors one launch of
    ``csrc/peel.cu``; on CPU tensors the plain pair."""
    return _peel(garr, (vn_state, cn_state, cn_degree, dead), False, max_sweeps,
                 set_mask=set_mask, values=values)


def set_index_and_peel(garr, vn_state, cn_state, cn_degree, dead, index, value, do_set,
                       max_sweeps: int | None = None):
    """``set_values_and_peel`` of one VN a row: row b sets VN ``index[b]``
    to ``value[b]`` where ``do_set[b]`` (the JAX decoders' one-hot ``(VN
    == index) & do_set`` with ``value`` broadcast; an index outside [0, n)
    sets nothing). ``index``, ``value``, ``do_set``: [B]."""
    return _peel(garr, (vn_state, cn_state, cn_degree, dead), False, max_sweeps,
                 index=index, value=value, do_set=do_set)


# ---------------------------------------------------------------------------
# Transposed (batch-minor) forms: the GDG ensemble's carry layout.
# ---------------------------------------------------------------------------

def init_decimation_state_t(garr, syndrome_t):
    """Fresh transposed state from a [m, B] (or [m_pad, B]) syndrome."""
    B = syndrome_t.shape[-1]
    n, m, m_pad = garr["n"], garr["m"], garr["m_pad"]
    dev = syndrome_t.device
    vn_t = torch.full((n, B), -1, dtype=torch.int8, device=dev)
    cn_t = torch.full((m_pad, B), -1, dtype=torch.int8, device=dev)
    cn_t[:m] = syndrome_t[:m].to(torch.int8)
    deg_t = torch.zeros((m_pad, B), dtype=torch.int32, device=dev)
    deg_t[:m] = garr["cn_degree"].to(torch.int32)[:, None]
    dead = torch.zeros((B,), dtype=torch.bool, device=dev)
    return vn_t, cn_t, deg_t, dead


def _gather_vn_to_cn(garr, x_t):
    """[n, B] VN-side array -> [dc, m_pad, B] per-CN-slot array through the
    slot-major table; the invalid slots' index n reads an appended zero
    row (the JAX ``take`` of the fill row)."""
    dc, m_pad, B = garr["dc"], garr["m_pad"], x_t.shape[-1]
    src = torch.cat([x_t, x_t.new_zeros((1, B))])
    return src[garr["cn_vn_fill"]].reshape(dc, m_pad, B)


def _gather_cn_to_vn(garr, x_t):
    """[m_pad, B] CN-side array -> the dv [n, B] slices of the per-VN-slot
    array [n, dv, B] through the ``vn_cn`` table; its dummy index m reads
    the first pad row, which the layout keeps inert (``compile_graph``
    always leaves one, m < m_pad). Slice by slice, so no [n, dv, B] array
    is written."""
    return [x_t[cols] for cols in garr["vn_cn_cols"]]


def vn_set_values_t(garr, vn_t, cn_t, deg_t, dead, set_mask_t, values_t):
    """Transposed ``vn_set_values``: ``set_mask_t``/``values_t`` are [n, B].

    The JAX form gathers one int8 code per edge (0, 1 = set to 0, 2 = set
    to 1) and sums two counts over the slots. Here one int16 code per edge,
    1 for a newly decided VN plus 64 if it is decided to 1, is gathered and
    summed once: the sum's low 6 bits are the newly decided neighbours (at
    most dc <= 63) and the rest counts those decided to 1. The same
    integers, one pass over the edges instead of two."""
    if garr["dc"] > 63:
        raise ValueError(f"check degree {garr['dc']} > 63: the packed count overflows")
    _count_card_call(vn_t)
    values_t = values_t.to(torch.int8)
    already = set_mask_t & (vn_t != -1)
    conflict = already & (vn_t != values_t)
    dead = dead | conflict.any(dim=0)
    newly = set_mask_t & (vn_t == -1)
    vn_t = torch.where(newly, values_t, vn_t)

    enc = newly.to(torch.int16) * (1 + 64 * (values_t == 1).to(torch.int16))
    packed = _gather_vn_to_cn(garr, enc).sum(dim=0, dtype=torch.int16)  # [m_pad, B]
    delta = (packed & 63).to(torch.int32)
    pflip = ((packed >> 6) & 1).to(torch.int8)

    active = cn_t != -1
    new_deg = deg_t - delta
    new_par = torch.where(active, cn_t ^ pflip, cn_t)
    hit_zero = active & (new_deg == 0) & (delta > 0)
    contradiction = hit_zero & (new_par == 1)
    dead = dead | contradiction.any(dim=0)
    cn_t = new_par.masked_fill(hit_zero & (new_par == 0), -1)
    return vn_t, cn_t, new_deg, dead


def _sweep_t(garr, vn_t, cn_t, deg_t, dead):
    """One forcing sweep of the transposed state. Returns the new state
    and whether any live row forced a VN (0-dim, on the device)."""
    deg1 = (cn_t != -1) & (deg_t == 1)
    # bit 0: a degree-1 check of parity 0 (forces 0), bit 1: of parity 1
    code = deg1.to(torch.int8) + (deg1 & (cn_t == 1)).to(torch.int8)
    acc = None
    for slot in _gather_cn_to_vn(garr, code):  # OR over each VN's checks
        acc = slot if acc is None else acc | slot
    undecided = vn_t == -1
    force1 = (acc & 2).bool() & undecided
    force0 = (acc & 1).bool() & undecided
    dead = dead | (force0 & force1).any(dim=0)
    forced = force0 ^ force1
    vn_t, cn_t, deg_t, dead = vn_set_values_t(garr, vn_t, cn_t, deg_t, dead, forced, force1)
    more = (forced.any(dim=0) & ~dead).any()
    return vn_t, cn_t, deg_t, dead, more


def peel_t(garr, vn_t, cn_t, deg_t, dead, max_sweeps: int | None = None):
    """Transposed ``peel``: degree-1 forcing to the fixpoint of the JAX
    ``peel_t``. The JAX loop runs a first sweep, then another while the
    last one forced a VN in a live row, at most ``max_sweeps`` in all; dead
    rows are swept along. On CUDA tensors one call of ``csrc/peel.cu``
    (``ops.peel_cuda.peel_fixpoint``, no host read); on CPU tensors the
    plain loop ``_peel_loop``."""
    return _peel(garr, (vn_t, cn_t, deg_t, dead), True, max_sweeps)


def set_values_and_peel_t(garr, vn_t, cn_t, deg_t, dead, set_mask, values=None,
                          max_sweeps: int | None = None):
    """Transposed ``set_values_and_peel``: ``vn_set_values_t`` (``set_mask``
    and ``values`` [n, B]; None: all 0) and then ``peel_t``."""
    return _peel(garr, (vn_t, cn_t, deg_t, dead), True, max_sweeps,
                 set_mask=set_mask, values=values)


def set_index_and_peel_t(garr, vn_t, cn_t, deg_t, dead, index, value, do_set,
                         max_sweeps: int | None = None):
    """Transposed ``set_index_and_peel``: column b sets VN ``index[b]`` to
    ``value[b]`` where ``do_set[b]``, then ``peel_t``."""
    return _peel(garr, (vn_t, cn_t, deg_t, dead), True, max_sweeps,
                 index=index, value=value, do_set=do_set)


def _peel(garr, state, transposed: bool, max_sweeps, **decision):
    """The decision (a mask with values, an index with value and do-set,
    or none) and the peel: the kernel on a card's tensors (it raises on any
    device but the CPU and a card), the plain pair on CPU tensors."""
    if state[0].device.type != "cpu":
        return peel_cuda.peel_fixpoint(garr, *state, transposed=transposed,
                                       max_sweeps=max_sweeps, **decision)
    peel_cuda.peel_fixpoint.plain_calls += 1
    if decision:
        state = _plain_decision(garr, state, transposed, **decision)
    return _peel_loop(garr, *state, max_sweeps, transposed=transposed)


def _plain_decision(garr, state, transposed: bool, set_mask=None, values=None, index=None,
                    value=None, do_set=None):
    """The plain version of the kernel's decision: ``vn_set_values(_t)`` of
    the mask (values None: 0), or of the one-hot of ``index``."""
    vn = state[0]
    if index is not None:
        vns = torch.arange(garr["n"], device=vn.device)
        if transposed:
            set_mask = (vns[:, None] == index[None, :]) & do_set[None, :]
            values = value[None, :].expand(vn.shape)
        else:
            set_mask = (vns[None, :] == index[:, None]) & do_set[:, None]
            values = value[:, None].expand(vn.shape)
    elif values is None:
        values = torch.zeros_like(vn)
    return (vn_set_values_t if transposed else vn_set_values)(garr, *state, set_mask, values)


def _peel_loop(garr, vn, cn, deg, dead, max_sweeps=None, *, transposed: bool = False):
    """The plain version of ``csrc/peel.cu``: one ``_sweep`` (``_sweep_t``
    if ``transposed``) of torch ops a sweep, each ending in one
    device-to-host read of ``more``, at most ``max_sweeps`` sweeps."""
    sweep = _sweep_t if transposed else _sweep
    *state, more = sweep(garr, vn, cn, deg, dead)
    sweeps = 1
    while bool(more) and (max_sweeps is None or sweeps < max_sweeps):
        *state, more = sweep(garr, *state)
        sweeps += 1
    return tuple(state)


def unsatisfied_counts_t(garr, synd_hat_t, syndrome_t, cn_t):
    """Transposed ``num_flip``: ``synd_hat_t``/``syndrome_t`` [m_pad, B]
    (pad rows equal), ``cn_t`` [m_pad, B]; returns [n, B] int32. The int8
    sum over a VN's dv checks is exact (dv <= 127)."""
    unsat = ((synd_hat_t.to(torch.int32) != syndrome_t.to(torch.int32))
             & (cn_t != -1)).to(torch.int8)
    acc = None
    for slot in _gather_cn_to_vn(garr, unsat):
        acc = slot if acc is None else acc + slot
    return acc.to(torch.int32)


def unsatisfied_counts(garr, error, syndrome, cn_state, synd_hat=None):
    """Batch-major ``num_flip`` (bpgd.cpp:296-309): per VN, the adjacent
    active checks whose decoded syndrome bit (``synd_hat`` [B, m], or that
    of ``error`` [B, n]) differs from the target. Returns [B, n] int32."""
    if synd_hat is None:
        synd_hat = check_syndrome(garr, error)
    unsat = (synd_hat.to(torch.int32) != syndrome.to(torch.int32)) & (cn_state != -1)
    unsat_e = F.pad(unsat.to(torch.int8), (0, 1))[:, garr["vn_cn"].long()]
    return (unsat_e * garr["vn_valid"].to(torch.int8)).sum(dim=-1, dtype=torch.int32)
