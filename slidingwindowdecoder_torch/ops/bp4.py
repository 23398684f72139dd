"""Batched quaternary (GF(4)) belief propagation, in PyTorch.

The counterpart of the JAX package's ``ops/bp4.py`` (itself the batched
form of the reference's ``bp4_osd`` message passing, bp4_osd.pyx:425-588):
scalar LLR messages on the edges of BOTH Tanner graphs (Hx carries the
Z-component messages, Hz the X-component), the min-sum check update per
basis, and a joint variable update that combines the X/Y/Z channel LLRs
with both graphs' sums through log1pexp / logaddexp.

Decided variables (CAMEL decimation) keep their outgoing messages at the
initial value and flip the check parities, as the reference's
``vn_set_value`` does (bp4_osd.pyx:385-420); decided variables are not
masked out of the check updates.

Layout: the messages are slot-major [dc, m_pad, B] (shot index fastest) in
float32, the layout of kernel A (``ops.bp_cuda.cn_update``, the CN stage
of BP4: on a CUDA tensor one ``csrc/cn_update.cu`` launch a basis an
iteration, on a CPU tensor its plain version ``ops.bp._cn_update_sm``);
the JAX layout is [m, dc, B]. The check stage is the JAX
``_cn_minsum_bm`` (the kernel's ``mag = (|x| == min1) ? min2 : min1``
agrees with "the first argmin gets min2", since after a tie min2 ==
min1). The variable side runs as torch ops, as it runs as XLA ops in JAX:
the per-variable sums gather the messages per variable slot and add them
slot by slot from slot 0 (``_col_sums``), and each edge's outgoing message
is computed in the check-major layout directly, where JAX computes it
variable-major and scatters it (the same arithmetic per valid edge; 0 at
invalid slots).
"""

from __future__ import annotations

import numpy as np
import torch

from .bp import EXIT_CHECK_EVERY
from .bp_cuda import cn_update


def logaddexp(a, b):
    """log(e^a + e^b) as the JAX package computes it (``lax.logaddexp``):
    the larger argument plus log1p(exp(-|a - b|)), for finite inputs."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def log1pexp(x):
    """log(1 + e^x), the JAX ``log1pexp``: ``logaddexp(0, x)``."""
    return logaddexp(torch.zeros_like(x), x)


def bp4_graph(garr):
    """BP4's tables of one graph (``graphs.tanner.graph_tensors``), added
    to ``garr`` once: the variables in descending degree (stable), so that
    the variables with a valid slot j are a prefix of that order, the
    prefix length of each slot, and the per-slot message indices in that
    order (``vn_from_cn_flat``'s rows)."""
    if "bp4_order" not in garr:
        n, dv = garr["n"], garr["dv"]
        deg = garr["vn_valid"].sum(dim=1).cpu().numpy()
        order = np.argsort(-deg, kind="stable")
        counts = [int((deg > j).sum()) for j in range(dv)]
        dev = garr["vn_valid"].device
        vfc = garr["vn_from_cn_flat"].reshape(n, dv)
        garr["bp4_order"] = torch.as_tensor(order, device=dev)
        garr["bp4_inverse"] = torch.as_tensor(np.argsort(order), device=dev)
        garr["bp4_counts"] = counts
        garr["bp4_vfc"] = vfc[garr["bp4_order"]]  # [n, dv] in degree order
    return garr


def _col_sums(garr, mc):
    """Per-variable sums of the incoming check messages, [n, B] f32.

    ``mc`` [dc, m_pad, B]. Each variable's valid slots are added in slot
    order from slot 0, one rounding per add: the JAX sum over the padded
    [n, dv, B] gather adds exact zeros at the invalid slots, which change
    no sum but the sign of a zero. A slot's add covers only the variables
    that have it (a prefix of the degree order), so a graph with one
    variable of high degree ([[362]]: 171) costs that variable's adds and
    not dv full-width ones."""
    n, dc, m_pad = garr["n"], garr["dc"], garr["m_pad"]
    B = mc.shape[-1]
    src = torch.cat([mc.reshape(dc * m_pad, B), mc.new_zeros((1, B))])
    vfc, counts = garr["bp4_vfc"], garr["bp4_counts"]
    acc = src[vfc[:, 0]]  # [n, B] in degree order
    j = 1
    while j < len(counts):  # slots of one prefix length share a gather
        c, j_end = counts[j], j
        while j_end < len(counts) and counts[j_end] == c:
            j_end += 1
        if c:
            part = src[vfc[:c, j:j_end]]  # [c, j_end - j, B]
            for t in range(j_end - j):
                acc[:c] += part[:, t]
        j = j_end
    return acc[garr["bp4_inverse"]]


def bp4_initial_values(llr_x, llr_y, llr_z):
    """The initial (and frozen) per-variable messages to Hx (the
    Z-component LLR) and to Hz (the X-component LLR), [n] each.

    The reference initializes the Hz message with llrz where llrx belongs
    (bp4_osd.pyx:437-438); for depolarizing channels llrx == llrz and the
    two agree. The JAX package, and this port, use the symmetric form."""
    mx_val = log1pexp(-llr_x) - logaddexp(-llr_y, -llr_z)
    mz_val = log1pexp(-llr_z) - logaddexp(-llr_x, -llr_y)
    return mx_val, mz_val


def _per_edge(garr, val):
    """[n] or [n, B] per-variable values at the check-major edges,
    [dc, m_pad] or [dc, m_pad, B] (invalid slots read variable n - 1)."""
    e = val[garr["cn_vn_clip"]]
    return e.reshape(garr["dc"], garr["m_pad"], *val.shape[1:])


def bp4_init_messages(gx, gz, llr_x, llr_y, llr_z, batch: int):
    """Initial messages on Hx and Hz, slot-major [dc, m_pad, B] f32 with 0
    at invalid slots (broadcast views over the batch)."""
    out = []
    for g, val in zip((gx, gz), bp4_initial_values(llr_x, llr_y, llr_z)):
        base = torch.where(g["cn_valid_sm"], _per_edge(g, val), 0.0)
        out.append(base[:, :, None].expand(g["dc"], g["m_pad"], batch))
    return tuple(out)


def _decoded_parity(garr, err_t):
    """[m_pad, B] parity of ``err_t`` [n, B] over each check's valid edges."""
    bits = _per_edge(garr, err_t).to(torch.int32) * garr["cn_valid_sm"][:, :, None]
    return bits.sum(dim=0) % 2


def _padded_t(garr, rows):
    """[B, m] 0/1 rows -> [m_pad, B] int32, pad rows 0."""
    out = torch.zeros((garr["m_pad"], rows.shape[0]), dtype=torch.int32, device=rows.device)
    out[: garr["m"]] = rows.T.to(torch.int32)
    return out


def bp4_run(gx, gz, mvx, mvz, llr_x, llr_y, llr_z, synd_x, synd_z, vn_state, cn_x, cn_z,
            done, iters, *, num_iter: int, alpha: float = 1.0, clip: float = 50.0):
    """Run up to ``num_iter`` BP4 iterations with a per-shot freeze (the
    JAX ``bp4_run``).

    ``gx``/``gz``: ``graph_tensors`` of Hx and Hz; ``mvx``/``mvz`` their
    slot-major messages [dc, m_pad, B] f32; ``llr_*`` [n] channel LLRs;
    ``synd_x`` [B, mx], ``synd_z`` [B, mz]; ``vn_state`` [B, n] int8 (-1
    undecided, else the Pauli index x + 2z); ``cn_x``/``cn_z`` [B, m] the
    check parities (the syndrome adjusted by the decisions), the CN stage's
    sign seeds; ``done`` [B] bool, ``iters`` [B] int32.

    A shot that is done keeps its state: ``iters`` counts the iterations in
    which a shot was active. The loop stops after ``num_iter`` iterations,
    or when every shot is done (read on the host every
    ``EXIT_CHECK_EVERY`` iterations; a done shot changes nothing, so the
    outputs do not depend on when). Returns (mvx, mvz, lpr_x, lpr_y,
    lpr_z, err_x, err_z, done, iters): posteriors [B, n] f32, errors
    [B, n] int8.
    """
    bp4_graph(gx)
    bp4_graph(gz)
    n = gx["n"]
    dev = synd_x.device
    B = synd_x.shape[0]
    sx_t, sz_t = _padded_t(gx, synd_x), _padded_t(gz, synd_z)
    par_x, par_z = _padded_t(gx, cn_x), _padded_t(gz, cn_z)
    vn_t = vn_state.T  # [n, B]
    undecided = vn_t == -1
    dec_x = torch.where(undecided, 0, vn_t % 2).to(torch.int8)
    dec_z = torch.where(undecided, 0, vn_t // 2).to(torch.int8)
    lx, ly, lz = llr_x[:, None], llr_y[:, None], llr_z[:, None]
    mx_val, mz_val = bp4_initial_values(llr_x, llr_y, llr_z)
    frozen_x = _per_edge(gx, mx_val)[:, :, None]
    frozen_z = _per_edge(gz, mz_val)[:, :, None]
    undec_x = _per_edge(gx, undecided)
    undec_z = _per_edge(gz, undecided)
    valid_x, valid_z = gx["cn_valid_sm"], gz["cn_valid_sm"]

    lprx = torch.zeros((n, B), dtype=torch.float32, device=dev)
    lpry, lprz = lprx.clone(), lprx.clone()
    ex = torch.zeros((n, B), dtype=torch.int8, device=dev)
    ez = ex.clone()

    def outgoing(g, mc, num, llr_a, llr_b, undec_e, frozen, valid):
        # the extrinsic message on each edge: num - logaddexp(-(a - mc), -(b - mc))
        a_e = _per_edge(g, llr_a) - mc
        b_e = _per_edge(g, llr_b) - mc
        out = _per_edge(g, num) - logaddexp(-a_e, -b_e)
        out = torch.where(undec_e, out, frozen)  # decided VNs keep frozen messages
        return torch.where(valid[:, :, None], out, 0.0)

    i = 0
    while i < num_iter:
        if i % EXIT_CHECK_EVERY == 0 and bool(done.all()):
            break
        active = ~done
        mcx = cn_update(mvx, valid_x, par_x, alpha=alpha, clip=clip)
        mcz = cn_update(mvz, valid_z, par_z, alpha=alpha, clip=clip)
        sum_hx = _col_sums(gx, mcx)
        sum_hz = _col_sums(gz, mcz)

        lprx_new = sum_hz + lx
        lprz_new = sum_hx + lz
        lpry_new = sum_hx + sum_hz + ly

        # hard decision (bp4_osd.pyx:560-573)
        all_pos = (lprx_new > 0) & (lpry_new > 0) & (lprz_new > 0)
        x_small = (lprx_new < lpry_new) & (lprx_new < lprz_new)
        z_small = lpry_new > lprz_new
        idx = torch.where(all_pos, 0, torch.where(x_small, 1, torch.where(z_small, 2, 3)))
        ex_new = torch.where(undecided, (idx % 2).to(torch.int8), dec_x)
        ez_new = torch.where(undecided, (idx // 2).to(torch.int8), dec_z)

        mvx_new = outgoing(gx, mcx, log1pexp(-lprx_new), lprz_new, lpry_new, undec_x,
                           frozen_x, valid_x)
        mvz_new = outgoing(gz, mcz, log1pexp(-lprz_new), lprx_new, lpry_new, undec_z,
                           frozen_z, valid_z)

        mvx = torch.where(active, mvx_new, mvx)
        mvz = torch.where(active, mvz_new, mvz)
        lprx = torch.where(active, lprx_new, lprx)
        lpry = torch.where(active, lpry_new, lpry)
        lprz = torch.where(active, lprz_new, lprz)
        ex = torch.where(active, ex_new, ex)
        ez = torch.where(active, ez_new, ez)

        conv = ((_decoded_parity(gx, ez) == sx_t).all(dim=0)
                & (_decoded_parity(gz, ex) == sz_t).all(dim=0))
        iters = iters + active.to(torch.int32)
        done = done | conv
        i += 1
    return mvx, mvz, lprx.T, lpry.T, lprz.T, ex.T, ez.T, done, iters
