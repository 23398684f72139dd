"""Batched normalized min-sum belief propagation, in PyTorch.

The counterpart of the JAX package's ``ops/bp.py``: the unmasked mode of
the BP+OSD path (every VN undecided, every CN active) and the masked mode
of the decimation decoders. Semantics reproduced exactly:

- two-pass CN rule == masked (min1, min2, first-argmin) reduction over the
  check-slot axis, sign seeded by the check's syndrome bit, zero counted
  as negative (``m <= 0``), message clipping to ±clip inside the CN
  update only, normalization factor applied after the sign;
- VN rule: posterior = prior + sum of incoming, outgoing = posterior − own;
- posterior LLR history ring of length 4 indexed by ``iteration % 4``
  (the iteration counter is local to each ``bp_run`` call);
- hard decision ``posterior <= 0``; convergence = full-PCM syndrome
  match; per-shot freeze after convergence, whole-batch early exit.

Layouts follow the JAX package: CN-major edge arrays are slot-major
[dc, m_pad, B] (shot index fastest), the history ring is [n, 4, B]
internally. On the card a ``bp_run`` call is one launch of the fused
kernel ``csrc/bp_span.cu`` (``ops.bp_cuda.bp_span``) wherever its shape
gate admits the graph; its plain version is ``bp_loop`` (below), torch ops
around the CN stage ``ops.bp_cuda.cn_update``, which launches
``csrc/cn_update.cu`` on a CUDA tensor and runs ``_cn_update_sm`` (the
plain version) on a CPU tensor. CPU tensors always take ``bp_loop``; on
the card it serves the graphs outside the fused kernel's gate.

Masked mode (``masked=True``): ``vn_state`` values -1/0/1 exclude decided
variables from message passing and ``cn_state`` -1 deactivates cleared
checks while 0/1 carries the residual parity used as the CN sign seed. As
in the JAX package this is pinned-LLR masking: the edges of decided VNs
and the invalid slots carry ``+PIN``, which the pinned CN update presents
as ``BIG`` to the min and counts with no sign, and decided posteriors are
pinned to ``-/+PIN`` by their decided value.
"""

from __future__ import annotations

import torch

BIG = 1e30  # stands in for the reference's 1e308 sentinel (f32-safe)
# pinned-LLR masking sentinels (the JAX package's values): pinned edges
# carry +PIN and anything at or above PIN_THRESH is a pin. A live posterior
# is bounded by dv*BIG + prior, below PIN_THRESH (``bp_run`` checks it).
# Both are rounded to the message dtype where they are used: in bfloat16
# the ordering live < PIN_THRESH <= PIN holds only after that rounding.
PIN = 1e33
PIN_THRESH = 1e32

# how many iterations run between two host checks of the all-done exit;
# rows that are done never change error/done/iters/history, so checking
# less often than every iteration changes none of those outputs
EXIT_CHECK_EVERY = 4

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def msg_torch_dtype(msg_dtype: str) -> torch.dtype:
    try:
        return _DTYPES[str(msg_dtype)]
    except KeyError:
        raise ValueError(f"unsupported msg_dtype {msg_dtype!r}") from None


def bp_init_messages(garr, prior_llr, batch: int):
    """Initial VN->CN messages (batch-major CN layout [B, m, dc], f32): the
    channel prior, 0 at degree-padding slots. ``prior_llr``: [n] or [B, n]."""
    cn_vn = garr["cn_vn"].long()
    n = garr["n"]
    prior = torch.as_tensor(prior_llr, dtype=torch.float32, device=cn_vn.device)
    if prior.ndim == 1:
        prior = prior.expand(batch, n)
    prior_pad = torch.nn.functional.pad(prior, (0, 1))
    return prior_pad[:, cn_vn]  # [B, m, dc]


def bp_init_messages_sm(garr, prior_llr, batch: int, msg_dtype="float32"):
    """Initial VN->CN messages in slot-major [dc, m_pad, B] layout, in the
    message dtype. ``prior_llr``: [n], shared across the batch. Invalid
    slots carry 0. Returns a broadcast view; callers that write into it
    materialize it first."""
    mdt = msg_torch_dtype(msg_dtype)
    dc, m_pad = garr["dc"], garr["m_pad"]
    prior = torch.as_tensor(prior_llr, dtype=torch.float32,
                            device=garr["cn_vn_clip"].device)
    base = prior[garr["cn_vn_clip"]].reshape(dc, m_pad)
    base = torch.where(garr["cn_valid_sm"], base, 0.0).to(mdt)
    return base[:, :, None].expand(dc, m_pad, batch)


def _cn_update_sm(mv, edge_valid, parity, *, alpha, clip, pinned=False):
    """Check-node update, slot-major — the plain version of the CUDA kernel
    in ``ops.bp_cuda`` and the port of the JAX ``_cn_update_sm``.

    mv: [dc, m_pad, B] messages (f32 or bf16); edge_valid: bool
    [dc, m_pad] or broadcastable to mv; parity: [m_pad, B] int32 sign
    seed. Returns mc in mv's dtype (zero at invalid slots). All arithmetic
    stays in the message dtype, as in the JAX version.

    ``pinned``: messages >= PIN_THRESH are pins (masked mode); they skip
    the clip, so they present exactly BIG to the min and carry no sign.
    """
    if edge_valid.ndim == 2:
        edge_valid = edge_valid[:, :, None]
    mdt = mv.dtype
    big = torch.tensor(BIG, dtype=mdt, device=mv.device)
    mvc = torch.clamp(mv, -clip, clip)
    if pinned:
        mvc = torch.where(mv >= torch.tensor(PIN_THRESH, dtype=mdt, device=mv.device),
                          mv, mvc)
    absx = torch.minimum(torch.where(edge_valid, mvc.abs(), big), big)
    neg = edge_valid & (mvc <= 0)
    # min1, its first slot (== fwd-pass order), min2 and the sign count,
    # slot by slot: elementwise ops, where torch's CPU reductions over the
    # leading dimension are tens of times slower (min is exact either way)
    dc = mv.shape[0]
    min1, arg1 = absx[0], torch.zeros(absx.shape[1:], dtype=torch.int64, device=mv.device)
    nneg = neg[0].to(torch.int32)
    for s in range(1, dc):
        arg1 = torch.where(absx[s] < min1, s, arg1)
        min1 = torch.minimum(min1, absx[s])
        nneg = nneg + neg[s]
    slot = torch.arange(dc, device=mv.device)[:, None, None]
    is_arg = slot == arg1[None]
    min2 = big.expand(absx.shape[1:])
    for s in range(dc):
        min2 = torch.minimum(min2, torch.where(is_arg[s], big, absx[s]))
    total_sign = (parity + nneg) % 2
    sign_flip = (total_sign[None] ^ neg.to(torch.int32)) == 1
    mag = torch.where(is_arg, min2[None], min1[None])
    mc = torch.tensor(alpha, dtype=mdt, device=mv.device) * torch.where(
        sign_flip, -mag, mag
    )
    return torch.where(edge_valid, mc, torch.zeros((), dtype=mdt, device=mv.device))


def bp_loop(
    garr,
    mv_sm,
    prior,
    parity,
    synd_t,
    vn_state,
    hist_t,
    error,
    done,
    iters,
    *,
    num_iter: int,
    hist_from: int,
    alpha: float,
    clip: float,
    masked: bool,
    freeze_messages: bool = True,
    posterior_matmul: bool = False,
    return_synd: bool = False,
):
    """Up to ``num_iter`` BP iterations as torch ops around the CN stage
    ``ops.bp_cuda.cn_update``: the plain version of the fused kernel
    ``csrc/bp_span.cu`` (``ops.bp_cuda.bp_span``), and the per-op loop that
    ``bp_run`` runs on the card for graphs outside that kernel's gate.

    ``mv_sm`` [dc, m_pad, B] in the message dtype (a broadcast view is
    fine); ``prior`` [n] or [B, n] f32; ``parity`` (the CN sign seed) and
    ``synd_t`` [m_pad, B] int32; ``vn_state`` [B, n] int8 or None (all
    undecided; masked mode only); ``hist_t`` [n, 4, B] f32, written in
    place at slot ``i % 4`` from iteration ``hist_from`` on; ``error``
    [B, n] int8, ``done`` [B] bool, ``iters`` [B] int32. Returns
    ``(mv_sm, hist_t, error, done, iters)``, and with ``return_synd`` also
    ``synd_hat`` [m_pad, B] int8: each shot's decoded syndrome at its last
    executed iteration, the target ``synd_t`` for a shot done at entry
    (pad rows 0).

    The iterations run on the shots not done at entry only (one host read
    of which they are): a shot done at entry keeps every input, its
    messages pinned at entry in masked mode, as in the kernel. Its
    messages then differ from the JAX loop's with ``freeze_messages=False``
    only, where the docstring of ``bp_run`` allows it.
    """
    mdt = mv_sm.dtype
    dev = synd_t.device
    B = synd_t.shape[1]
    n, dc, m_pad = garr["n"], garr["dc"], garr["m_pad"]
    sv = garr["cn_valid_sm"][:, :, None]
    vn_t = None
    if masked:
        vn_t = (torch.full((n, B), -1, dtype=torch.int8, device=dev)
                if vn_state is None else vn_state.T)
        # pin the edges of decided VNs and the invalid slots once, at entry
        vs_edge = vn_t[garr["cn_vn_clip"]].reshape(dc, m_pad, B)
        mv_sm = torch.where((vs_edge != -1) | ~sv, torch.tensor(PIN, dtype=mdt, device=dev),
                            mv_sm)
    live = (~done).nonzero()[:, 0]
    kw = dict(num_iter=num_iter, hist_from=hist_from, alpha=alpha, clip=clip,
              masked=masked, freeze_messages=freeze_messages,
              posterior_matmul=posterior_matmul)
    if live.numel() == B:
        mv_sm, hist_t, err_t, done, iters, sodd = _bp_iterations(
            garr, mv_sm, prior, parity, synd_t, vn_t, hist_t, error.T, done, iters, **kw)
    else:
        sub = _bp_iterations(
            garr, mv_sm[:, :, live], prior if prior.ndim == 1 else prior[live],
            parity[:, live], synd_t[:, live], None if vn_t is None else vn_t[:, live],
            hist_t[:, :, live], error[live].T, done[live], iters[live], **kw)
        mv_sm = mv_sm.clone(memory_format=torch.contiguous_format)
        mv_sm[:, :, live] = sub[0]
        hist_t[:, :, live] = sub[1]
        err_t = error.T.clone()
        err_t[:, live] = sub[2]
        done, iters = done.clone(), iters.clone()
        done[live], iters[live] = sub[3], sub[4]
        sodd = synd_t == 1
        sodd[:, live] = sub[5]
    out = (mv_sm, hist_t, err_t.T, done, iters)
    return out + (sodd.to(torch.int8),) if return_synd else out


def _bp_iterations(garr, mv_sm, prior, parity, synd_t, vn_t, hist_t, err_t, done, iters, *,
                   num_iter, hist_from, alpha, clip, masked, freeze_messages,
                   posterior_matmul):
    """``bp_loop``'s iterations on the shots given, their messages already
    pinned at entry in masked mode. ``vn_t`` and ``err_t`` are [n, B];
    ``hist_t`` is written in place. Returns (mv_sm, hist_t, err_t, done,
    iters, decoded syndrome as bool [m_pad, B])."""
    from .bp_cuda import cn_update  # imports this module: no top-level cycle

    mdt = mv_sm.dtype
    dev = synd_t.device
    B = synd_t.shape[1]
    n, dc, m_pad, dv = garr["n"], garr["dc"], garr["m_pad"], garr["dv"]
    valid = garr["cn_valid_sm"]  # [dc, m_pad]
    sv = valid[:, :, None]
    cn_vn_clip = garr["cn_vn_clip"]
    vn_from_cn = garr["vn_from_cn_flat"]
    prior_t = prior[:, None].expand(n, B) if prior.ndim == 1 else prior.T
    syndrome_odd = synd_t == 1
    fill_row = torch.zeros((1, B), dtype=mdt, device=dev)
    sodd = syndrome_odd

    if masked:
        pin = torch.tensor(PIN, dtype=mdt, device=dev)
        thresh = torch.tensor(PIN_THRESH, dtype=mdt, device=dev)
        vn_undecided = vn_t == -1
        vn_pin = torch.where(vn_t == 1, -pin, pin)  # read only where decided

    i = 0
    while i < num_iter:
        if i % EXIT_CHECK_EVERY == 0 and bool(done.all()):
            break
        mc = cn_update(mv_sm, valid, parity, alpha=alpha, clip=clip, pinned=masked)
        mc_flat = mc.reshape(dc * m_pad, B)
        if posterior_matmul:
            posterior = prior_t + (garr["vn_inc"] @ mc_flat.float())
        else:
            # gather with a zero fill row (JAX take mode="fill"), summed in
            # f32 slot by slot: the order of XLA's reduce on the CPU
            mcv = torch.cat([mc_flat, fill_row])[vn_from_cn].reshape(n, dv, B)
            acc = mcv[:, 0].float()
            for j in range(1, dv):
                acc = acc + mcv[:, j].float()
            posterior = prior_t + acc
        post_f = posterior.to(mdt)
        if masked:
            # decided posteriors carry their decided sign into the hard
            # decision, the parity check and the re-pinned messages
            post_f = torch.where(vn_undecided, post_f, vn_pin)
        post_edge = post_f[cn_vn_clip].reshape(dc, m_pad, B)
        if masked:
            mv_new = torch.where(sv & (post_edge.abs() < thresh), post_edge - mc, pin)
        else:
            mv_new = post_edge - mc
        err_new = (post_f <= 0).to(torch.int8)
        # decoded parity per check: parity of the valid edges whose
        # posterior is <= 0 (the JAX +/-1 product, as a count)
        synd_odd = ((sv & (post_edge <= 0)).sum(dim=0) % 2) == 1
        conv = (synd_odd == syndrome_odd).all(dim=0)

        active = ~done
        mv_sm = torch.where(active, mv_new, mv_sm) if freeze_messages else mv_new
        if i >= hist_from:
            slot = hist_t[:, i % 4, :]
            write = active & vn_undecided if masked else active
            slot.copy_(torch.where(write, posterior, slot))
        err_t = torch.where(active, err_new, err_t)
        sodd = torch.where(active, synd_odd, sodd)
        iters = iters + active.to(torch.int32)
        done = done | conv
        i += 1
    return mv_sm, hist_t, err_t, done, iters, sodd


def bp_run(
    garr,
    mv,
    prior_llr,
    syndrome,
    history,
    error,
    done,
    iters,
    *,
    num_iter: int,
    alpha: float = 1.0,
    clip: float = 50.0,
    msg_dtype: str = "float32",
    freeze_messages: bool = True,
    history_mode: str = "full",
    posterior_matmul: bool = False,
    io_layout: str = "batch_major",
    vn_state=None,
    cn_state=None,
    masked: bool = False,
    state_layout: str = "batch_major",
    return_synd: bool = False,
    hist_update: str = "masked",
    hist_dtype: str = "float32",
):
    """Run up to ``num_iter`` BP iterations with per-shot convergence
    freeze (the JAX ``bp_run``).

    ``syndrome`` [B, m], ``error`` [B, n] int8, ``done`` [B] bool and
    ``iters`` [B] int32 are batch-major. With ``io_layout="batch_major"``
    ``mv`` is [B, m, dc] f32 and ``history`` [B, n, 4]; with
    ``"slot_major"`` they are the internal [dc, m_pad, B] (message dtype)
    and [n, 4, B]. ``history`` is written at slot ``i % 4`` each iteration
    for the shots still active, ``i`` local to this call.

    ``freeze_messages=False`` lets converged shots' messages keep evolving
    (valid when downstream ignores them): their final messages may differ
    from a frozen run's, and no other output does. The plain loop checks
    the all-done exit on the host every ``EXIT_CHECK_EVERY`` iterations;
    the fused kernel freezes every done shot and exits per block.
    ``history_mode="tail"`` records history only over the final 4
    iterations. ``posterior_matmul=True`` takes the per-VN message sum as
    a dense product with ``garr["vn_inc"]`` (the JAX bf16 form, kept for
    comparison on the CPU only).

    ``masked=True`` is the decimation mode: ``vn_state`` [B, n] int8
    (-1 undecided, 0/1 decided; default all undecided) and ``cn_state``
    [B, m] (-1 inactive, 0/1 residual parity; default the syndrome). The
    edges of decided VNs and the invalid slots are pinned to +PIN at entry,
    the CN stage runs pinned, decided posteriors are pinned to -/+PIN, and
    the history is written only for undecided VNs. Convergence is still
    the full-PCM match against ``syndrome``. ``masked=False`` ignores both
    states.

    Where it runs: on CPU tensors, ``ops.bp_cuda.bp_span`` runs the plain
    loop ``bp_loop``. On the card, a 1-D prior on a graph that
    ``bp_span_supported`` admits goes through the fused kernel
    ``csrc/bp_span.cu`` (one launch per call); any other call runs
    ``bp_loop`` there, with the CN kernel ``csrc/cn_update.cu``.

    ``state_layout="transposed"`` is the GDG ensemble's carry: ``syndrome``
    and ``cn_state`` arrive as [m_pad, B] (pad rows 0 and -1), ``vn_state``
    and ``error`` as [n, B], and ``error`` (and ``synd_hat``) leave so.
    ``done`` and ``iters`` stay [B]. The kernel takes [B, n] states, so
    ``vn_state`` and ``error`` are transposed at the call.

    ``return_synd=True`` appends ``synd_hat`` (int8): each row's decoded
    syndrome at its last executed iteration; a row done at entry keeps the
    target syndrome. [m_pad, B] with pad rows 0 when transposed, else
    [B, m].

    ``hist_update``: the JAX ``"masked"`` form writes the ring slot for the
    active rows' undecided VNs only. Its ``"slice"`` form writes the slot
    for every row and VN, and its comment notes that no reader sees the
    extra entries (frozen rows' and decided VNs'). Here ``"slice"`` runs
    the masked write: the ring equals JAX's on (active rows x undecided
    VNs), and elsewhere keeps its entry values. ``hist_dtype`` must be
    ``"float32"``: the bfloat16 ring is not ported.

    Returns ``(mv, history, error, done, iters)`` in the input layouts,
    then ``synd_hat`` if ``return_synd``.
    """
    from .bp_cuda import bp_span, bp_span_supported  # no top-level cycle

    if hist_update not in ("masked", "slice"):
        raise ValueError(f"unknown hist_update {hist_update!r}")
    if hist_dtype != "float32":
        raise NotImplementedError(f"hist_dtype={hist_dtype!r}: only the float32 "
                                  "history ring is ported")
    if state_layout not in ("batch_major", "transposed"):
        raise ValueError(f"unknown state_layout {state_layout!r}")
    transposed = state_layout == "transposed"
    args, kw = span_inputs(
        garr, mv, prior_llr, syndrome, history, error, done, iters,
        num_iter=num_iter, alpha=alpha, clip=clip, msg_dtype=msg_dtype,
        freeze_messages=freeze_messages, history_mode=history_mode,
        posterior_matmul=posterior_matmul, io_layout=io_layout,
        vn_state=vn_state, cn_state=cn_state, masked=masked,
        transposed=transposed,
    )
    mv_sm, prior = args[1], args[2]
    fused = mv_sm.device.type == "cpu" or (
        prior.ndim == 1 and not posterior_matmul
        and bp_span_supported(garr, mv_sm.shape[2], mv_sm.dtype))
    out = (bp_span if fused else bp_loop)(*args, **kw, return_synd=return_synd)
    mv_sm, hist_t, err_out, done, iters = out[:5]
    if transposed:
        err_out = err_out.T
    if io_layout == "slot_major":
        res = (mv_sm, hist_t, err_out, done, iters)
    else:
        mv_out = mv_sm[:, :garr["m"]].permute(2, 1, 0).float()
        res = (mv_out, hist_t.permute(2, 0, 1), err_out, done, iters)
    if not return_synd:
        return res
    return res + (out[5] if transposed else out[5][:garr["m"]].T,)


def span_inputs(
    garr,
    mv,
    prior_llr,
    syndrome,
    history,
    error,
    done,
    iters,
    *,
    num_iter: int,
    alpha: float = 1.0,
    clip: float = 50.0,
    msg_dtype: str = "float32",
    freeze_messages: bool = True,
    history_mode: str = "full",
    posterior_matmul: bool = False,
    io_layout: str = "batch_major",
    vn_state=None,
    cn_state=None,
    masked: bool = False,
    transposed: bool = False,
):
    """``bp_run``'s arguments as the positional and keyword arguments of
    ``bp_loop`` and ``ops.bp_cuda.bp_span``: slot-major messages in the
    message dtype, the CN sign seed and the syndrome as [m_pad, B] int32,
    a private contiguous copy of the history ring (unless
    ``history_mode="none"``) and ``hist_from``. ``transposed``: the states
    arrive in ``bp_run``'s ``state_layout="transposed"``."""
    mdt = msg_torch_dtype(msg_dtype)
    dev = syndrome.device
    B = syndrome.shape[-1] if transposed else syndrome.shape[0]
    m, dc, m_pad = garr["m"], garr["dc"], garr["m_pad"]
    hist_from = {"full": 0, "tail": max(num_iter - 4, 0), "none": num_iter}.get(history_mode)
    if hist_from is None:
        raise ValueError(f"unknown history_mode {history_mode!r}")

    prior = torch.as_tensor(prior_llr, dtype=torch.float32, device=dev)
    if transposed:
        synd_t = syndrome.to(torch.int32)
        error = error.T
        if vn_state is not None:
            vn_state = vn_state.T
    else:
        synd_t = torch.zeros((m_pad, B), dtype=torch.int32, device=dev)
        synd_t[:m] = syndrome.T.to(torch.int32)
    vn = None
    if masked:
        dv = garr["dv"]
        if dv * BIG >= PIN_THRESH:
            raise ValueError(
                f"max VN degree {dv} too large for pinned-LLR masking: dv*BIG "
                f"({dv * BIG:.2e}) must stay below PIN_THRESH ({PIN_THRESH:.0e})"
            )
        if transposed:
            cn_t = (syndrome if cn_state is None else cn_state).to(torch.int32)
        else:
            cn_t = torch.full((m_pad, B), -1, dtype=torch.int32, device=dev)
            cn_t[:m] = (syndrome if cn_state is None else cn_state).T.to(torch.int32)
        parity = cn_t.clamp_min(0)  # inactive checks and pad rows seed 0
        if vn_state is not None:
            vn = vn_state.to(torch.int8)
    else:
        parity = synd_t  # unmasked: cn_state == syndrome, pad rows 0

    if io_layout == "slot_major":
        mv_sm = mv.to(mdt)
        hist_t = history
    elif io_layout == "batch_major":
        mv_sm = torch.zeros((dc, m_pad, B), dtype=mdt, device=dev)
        mv_sm[:, :m] = mv.permute(2, 1, 0).to(mdt)
        hist_t = history.permute(1, 2, 0)
    else:
        raise ValueError(f"unknown io_layout {io_layout!r}")
    if history_mode != "none":  # the ring is written in place
        hist_t = hist_t.clone(memory_format=torch.contiguous_format)

    args = (garr, mv_sm, prior, parity, synd_t, vn, hist_t, error, done, iters)
    kw = dict(num_iter=num_iter, hist_from=hist_from, alpha=alpha, clip=clip,
              masked=masked, freeze_messages=freeze_messages,
              posterior_matmul=posterior_matmul)
    return args, kw


def history_sum(hist):
    """[n, 4, B] posterior history ring -> [B, n] sum of its 4 slots, taken
    slot by slot: the order of the JAX (XLA) reduce on the CPU (a torch
    ``.sum(dim=1)`` rounds differently)."""
    return (hist[:, 0] + hist[:, 1] + hist[:, 2] + hist[:, 3]).T


def fresh_bp_state(garr, batch: int):
    """Zeroed (history, error, done, iters) for a new decode call
    (batch-major, as the JAX ``fresh_bp_state``), on the graph's device."""
    n = garr["n"]
    dev = garr["cn_valid_sm"].device
    return (
        torch.zeros((batch, n, 4), dtype=torch.float32, device=dev),
        torch.zeros((batch, n), dtype=torch.int8, device=dev),
        torch.zeros((batch,), dtype=torch.bool, device=dev),
        torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def decode_bp(
    garr,
    prior_llr,
    syndrome,
    *,
    num_iter: int,
    alpha: float = 1.0,
    clip: float = 50.0,
    vn_state=None,
    cn_state=None,
    msg_dtype: str = "float32",
    masked: bool | None = None,
    freeze_messages: bool = True,
    history_mode: str = "full",
):
    """Plain batched BP decode from scratch. ``masked=None`` means masked
    if either state is given (as in the JAX ``decode_bp``).

    Returns dict with error, converged, iterations, history, posterior-sum
    ordering key (llr_sum, summed slot by slot as ``history_sum``), and
    final messages. ``num_iter=0`` runs nothing on either device (no
    launch) and returns the fresh state, as the JAX loop of no iteration
    does: no shot converged, ``llr_sum`` all zero.
    """
    B = syndrome.shape[0]
    if masked is None:
        masked = vn_state is not None or cn_state is not None
    mv = bp_init_messages(garr, prior_llr, B)
    history, error, done, iters = fresh_bp_state(garr, B)
    if num_iter > 0:
        mv, history, error, done, iters = bp_run(
            garr, mv, prior_llr, syndrome, history, error, done, iters,
            num_iter=num_iter, alpha=alpha, clip=clip, msg_dtype=msg_dtype,
            freeze_messages=freeze_messages, history_mode=history_mode,
            vn_state=vn_state, cn_state=cn_state, masked=masked,
        )
    return {
        "error": error,
        "converged": done,
        "iterations": iters,
        "history": history,
        "llr_sum": history_sum(history.permute(1, 2, 0)),
        "mv": mv,
    }
