"""Plain BP guided decimation (the single-branch BPGD baseline), in PyTorch.

The counterpart of the JAX package's ``decoders/bpgd.py`` (the batched
``bpgd_decoder`` of the reference, bp_guessing_decoder.pyx:473-570):
pre-BP on the full graph; if unconverged, shorten to the ``new_n`` most
unreliable columns and loop (a masked BP burst -> decimate the single most
*reliable* variable to its posterior sign -> peel) for up to ``max_step``
steps. As in the reference (bpgd.cpp:258-286), reliability is the
posterior of history slot 3, not the history sum.

The carry is the JAX package's: slot-major messages [dc, m_pad, B] in the
message dtype and history [n, 4, B] across the bursts, the decimation
state batch-major ([B, n] / [B, m]). Each burst is one masked ``bp_run``
call with a 1-D prior, so on the card one launch of the pinned fused
kernel ``csrc/bp_span.cu``. The step loops run on the host: one read per
step of whether every row has halted, and one per peel sweep
(``ops.decimation.peel``). A halted row is frozen, so the step count a
bucket runs changes no output.

Two forms, as in the JAX package: ``mode="loop"`` walks sorted buckets of
the pre-BP survivors (``bpgd_loop`` on each), ``mode="spans"`` walks the
whole batch with a row re-compaction between the static ``decim_spans``
(``bpgd_spans``). A row that dies in a peel keeps being swept while
another live row of its batch forces, as in the JAX fixpoint; so, as there,
the two forms may differ on a row that died (its error is not the
correction of a converged row) where their batches differ.

``min_pm`` is the prior summed over the correction's support exactly in
float64 and rounded once to float32 (``decoders.gdg.path_metric``), the
same in every batch shape; the JAX package sums in float32 in XLA's order,
so the two agree to the last bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.tanner import compile_graph, graph_tensors
from ..ops.bp import bp_init_messages_sm, bp_run, decode_bp, msg_torch_dtype
from ..ops.decimation import init_decimation_state, peel, vn_set_values
from ..utils.device import resolve_device
from .base import DecodeResult, as_batch, pad_pow2
from .bposd import _divisor_bucket
from .gdg import path_metric


def _bpgd_step(garr, llr, syndrome, c, *, num_iter, alpha, clip, msg_dtype):
    """One guided-decimation step (BP burst -> decimate the most reliable
    VN -> peel) on the carry dict ``c`` (``_init_carry``'s keys), returned
    updated. ``llr`` [n] f32 (1-D: one fused launch per burst);
    ``syndrome`` [B, m]. Rows halted at entry stay frozen, so a step on a
    finished row is a no-op."""
    halted_in = c["halted"]  # rows finished before this step stay frozen
    active = ~halted_in
    mv, history, error, bp_done, iters = bp_run(
        garr, c["mv"], llr, syndrome, c["history"], c["error"], ~active, c["iters"],
        num_iter=num_iter, alpha=alpha, clip=clip, msg_dtype=msg_dtype,
        io_layout="slot_major", hist_update="slice", vn_state=c["vn"],
        cn_state=c["cn"], masked=True,
    )
    newly = bp_done & active
    converged = c["converged"] | newly
    halted = halted_in | newly
    active = active & ~newly

    # decimate the most reliable variable: the largest |posterior| of
    # history slot 3 (bpgd.cpp:269), to (posterior > 0 ? 0 : 1); the ring
    # holds slot 3 of the burst for every undecided VN of an active row,
    # the only entries read here. argmax takes the first maximum, as JAX's.
    post = history[:, 3, :].T  # [B, n]
    vn_state = c["vn"]
    score = torch.where((vn_state == -1) & active[:, None], post.abs(), -1.0)
    vn = score.argmax(dim=-1)
    has = score.amax(dim=-1) >= 0.0
    value = (post.gather(1, vn[:, None])[:, 0] <= 0.0).to(torch.int8)
    halted = halted | (active & ~has)
    do_set = active & has
    B, n = vn_state.shape
    onehot = (torch.arange(n, device=vn.device)[None, :] == vn[:, None]) & do_set[:, None]
    state = vn_set_values(garr, vn_state, c["cn"], c["deg"], c["dead"], onehot,
                          value[:, None].expand(B, n))
    vn_state, cn_state, cn_degree, dead = peel(garr, *state)
    halted = halted | dead
    # decided values show in the running error, never for rows finished at
    # step entry (a boundary bucket may hold pre-converged rows whose error
    # must survive; a newly converged row's BP error holds its decided VNs)
    error = torch.where((vn_state != -1) & ~halted_in[:, None], vn_state, error)
    return dict(mv=mv, history=history, error=error, vn=vn_state, cn=cn_state,
                deg=cn_degree, dead=dead, halted=halted, converged=converged, iters=iters)


def _run_steps(garr, llr, syndrome, c, steps: int, **kw):
    """Up to ``steps`` ``_bpgd_step`` calls, stopping once every row has
    halted (one host read a step)."""
    for _ in range(steps):
        if bool(c["halted"].all()):
            break
        c = _bpgd_step(garr, llr, syndrome, c, **kw)
    return c


def _init_carry(garr, llr, vn_state, cn_state, cn_degree, dead, msg_dtype):
    """The step loop's carry: slot-major messages and history ring (rows on
    the last axis), the running error and the decimation state (rows
    first), and the per-row halted, converged and iteration counts."""
    B, n = vn_state.shape
    dev = vn_state.device
    return dict(
        # materialized: the walk of ``bpgd_spans`` writes into it
        mv=bp_init_messages_sm(garr, llr, B, msg_dtype).contiguous(),
        history=torch.zeros((n, 4, B), dtype=torch.float32, device=dev),
        error=torch.zeros((B, n), dtype=torch.int8, device=dev),
        vn=vn_state, cn=cn_state, deg=cn_degree, dead=dead, halted=dead.clone(),
        converged=torch.zeros((B,), dtype=torch.bool, device=dev),
        iters=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


def _outputs(llr, c):
    error = c["error"]
    return {"error": error.to(torch.uint8), "converged": c["converged"],
            "min_pm": path_metric(llr, error.T).to(torch.float32), "iterations": c["iters"]}


def bpgd_loop(garr, llr, syndrome, vn_state, cn_state, cn_degree, dead, *,
              num_iter: int, max_step: int, alpha: float, clip: float,
              msg_dtype: str = "float32"):
    """The guided-decimation step loop (the JAX ``bpgd_loop``) over a
    batch: up to ``max_step`` steps, stopping early once every row has
    halted. ``llr`` [n]; ``syndrome`` [B, m]; the shortened decimation
    state batch-major. Returns dict: error [B, n] uint8, converged [B],
    min_pm [B] f32, iterations [B] int32."""
    c = _init_carry(garr, llr, vn_state, cn_state, cn_degree, dead, msg_dtype)
    c = _run_steps(garr, llr, syndrome, c, max_step, num_iter=num_iter, alpha=alpha,
                   clip=clip, msg_dtype=msg_dtype)
    return _outputs(llr, c)


def bpgd_spans(garr, llr, syndrome, vn_state, cn_state, cn_degree, dead, *,
               num_iter: int, alpha: float, clip: float, msg_dtype: str = "float32",
               spans: tuple = (), row_bucket: int = 2048, error0=None, halted0=None,
               converged0=None):
    """Span-compacted decimation loop (the JAX ``bpgd_spans``): the step
    loop is cut into ``spans``, and before each span the halted rows are
    sorted out of the walk (a stable sort, one host read of how many rows
    are left), so the pool shrinks as rows converge. Buckets are the
    largest divisor of B up to ``row_bucket``; a boundary bucket may hold
    halted rows, which the step freezes. Each bucket's steps stop early
    once all of its rows halt.

    ``error0``/``halted0``/``converged0`` seed the rows that finished
    before the loop (pre-BP convergence): they are never gathered into a
    bucket and keep their state."""
    B = syndrome.shape[0]
    # the walk writes into the carry: no tensor of the caller's is shared
    c = _init_carry(garr, llr, vn_state.clone(), cn_state.clone(), cn_degree.clone(),
                    dead.clone(), msg_dtype)
    if error0 is not None:
        c["error"] = error0.to(torch.int8, copy=True)
    if halted0 is not None:
        c["halted"] = halted0 | dead
    if converged0 is not None:
        c["converged"] = converged0.clone()
    kw = dict(num_iter=num_iter, alpha=alpha, clip=clip, msg_dtype=msg_dtype)
    bucket = _divisor_bucket(B, row_bucket)
    for sp in spans:
        if bucket == B:  # one bucket holds every row: nothing to compact
            c = _run_steps(garr, llr, syndrome, c, sp, **kw)
            continue
        order = torch.argsort(c["halted"].to(torch.int8), stable=True)
        n_todo = int((~c["halted"]).sum())
        for b in range(-(-n_todo // bucket)):
            idx = order[b * bucket:(b + 1) * bucket]
            # messages and history are slot-major: rows on the last axis
            sub = {k: (v[..., idx] if k in ("mv", "history") else v[idx])
                   for k, v in c.items()}
            sub = _run_steps(garr, llr, syndrome[idx], sub, sp, **kw)
            for k, v in sub.items():
                if k in ("mv", "history"):
                    c[k][..., idx] = v
                else:
                    c[k][idx] = v
    return _outputs(llr, c)


def default_bpgd_spans(max_step: int) -> tuple:
    """Geometric span schedule: frequent early compactions while the pool
    is draining fast, long tail spans once only stragglers remain."""
    spans, s, total = [], 8, 0
    while total < max_step:
        sp = min(s, max_step - total)
        spans.append(sp)
        total += sp
        s = min(s * 2, 128)
    return tuple(spans)


class BPGD:
    """Batched single-branch guided-decimation decoder.

    The constructor is the JAX package's, less ``cn_engine`` (the kernels
    are chosen by shape), plus ``device`` (None means "cuda"; raises
    without a card). ``mode`` "loop" or "spans" (the default) give the
    same results, up to rows that died in a peel (module docstring).
    """

    def __init__(
        self,
        pcm,
        channel_probs,
        *,
        max_iter: int = 50,
        max_iter_per_step: int = 6,
        max_step: int = 25,
        ms_scaling_factor: float = 1.0,
        gd_factor: float = 1.0,
        new_n: int | None = None,
        clip: float = 50.0,
        bucket: int = 256,
        msg_dtype: str = "float32",
        mode: str = "spans",
        decim_spans=None,
        row_bucket: int = 2048,
        device=None,
    ):
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
        self.gd_factor = float(gd_factor)
        self.clip = float(clip)
        self.num_iter_per_step = int(max_iter_per_step)
        self.max_step = int(max_step)
        self.new_n = min(self.n, 2 * self.m) if new_n is None else min(new_n, self.n)
        self.bucket = int(bucket)
        self.msg_dtype = str(msg_dtype)
        if mode not in ("loop", "spans"):
            raise ValueError("mode must be 'loop' or 'spans'")
        self.mode = mode
        self.decim_spans = (default_bpgd_spans(self.max_step) if decim_spans is None
                            else tuple(int(s) for s in decim_spans))
        if sum(self.decim_spans) != self.max_step:
            raise ValueError(f"decim_spans must sum to max_step={self.max_step}")
        self.row_bucket = int(row_bucket)
        self.graph = compile_graph(pcm)
        self.garr = graph_tensors(self.graph, self.device)
        self.llr = np.log((1 - channel_probs) / channel_probs).astype(np.float32)
        self._llr_dev = torch.as_tensor(self.llr, device=self.device)

    def _shorten_state(self, synds, llr_sum):
        """Decide the most reliable n - new_n columns (by the pre-BP
        history sum, a stable ascending sort) to 0, then peel."""
        b, n = synds.shape[0], self.n
        state = init_decimation_state(self.garr, synds)
        if self.new_n < n:
            order = torch.argsort(llr_sum, dim=1, stable=True)
            rank_pos = torch.empty((b, n), dtype=torch.int32, device=synds.device)
            rank_pos.scatter_(1, order, torch.arange(n, dtype=torch.int32,
                                                     device=synds.device).expand(b, n))
            state = vn_set_values(self.garr, *state, rank_pos >= self.new_n,
                                  torch.zeros((b, n), dtype=torch.int8, device=synds.device))
            state = peel(self.garr, *state)
        return state

    def core(self, synds):
        """Decode a [B, m] syndrome tensor on the decoder's device: pre-BP
        on the whole batch, then the guided decimation on the survivors,
        in the form ``mode`` names.

        Returns dict: error [B, n] uint8, converged [B] bool, iterations
        [B] int32 (pre-BP plus the bursts'), min_pm [B] f32."""
        B = synds.shape[0]
        synds = synds.to(torch.uint8)
        pre = decode_bp(self.garr, self._llr_dev, synds, num_iter=self.max_iter,
                        alpha=self.alpha, clip=self.clip)
        done = pre["converged"]
        error = pre["error"].to(torch.uint8)
        iters = pre["iterations"]
        min_pm = path_metric(self._llr_dev, error.T).to(torch.float32)
        llr_sum = pre["llr_sum"]
        kw = dict(num_iter=self.num_iter_per_step, alpha=self.gd_factor, clip=self.clip,
                  msg_dtype=self.msg_dtype)

        if self.mode == "spans":
            # the span-compacted walk over the whole batch: pre-converged
            # rows enter halted and keep their pre-BP error
            vn0, cn0, cd0, dead0 = self._shorten_state(synds, llr_sum)
            err0 = torch.where(done[:, None], error.to(torch.int8),
                               torch.where(vn0 != -1, vn0, 0).to(torch.int8))
            out = bpgd_spans(self.garr, self._llr_dev, synds, vn0, cn0, cd0, dead0,
                             spans=self.decim_spans, row_bucket=self.row_bucket,
                             error0=err0, halted0=done, converged0=done, **kw)
            return {
                "error": out["error"],
                "converged": out["converged"],
                "iterations": iters + torch.where(done, 0, out["iterations"]),
                "min_pm": torch.where(done, min_pm, out["min_pm"]),
            }

        bucket = _divisor_bucket(B, self.bucket)
        synd_weight = synds.sum(dim=1, dtype=torch.int32)
        key = done.to(torch.int32) * (self.m + 2) + synd_weight
        order = torch.argsort(key, stable=True)
        n_todo = int((~done).sum())
        for b in range(-(-n_todo // bucket)):
            idx = order[b * bucket:(b + 1) * bucket]
            s = synds[idx]
            out = bpgd_loop(self.garr, self._llr_dev, s,
                            *self._shorten_state(s, llr_sum[idx]),
                            max_step=self.max_step, **kw)
            # boundary buckets may straddle converged shots: keep theirs
            done_c = done[idx]
            error[idx] = torch.where(done_c[:, None], error[idx], out["error"])
            min_pm[idx] = torch.where(done_c, min_pm[idx], out["min_pm"])
            iters[idx] = iters[idx] + torch.where(done_c, 0, out["iterations"])
            done[idx] = done_c | out["converged"]
        return {"error": error, "converged": done, "iterations": iters, "min_pm": min_pm}

    def decode_batch(self, syndromes) -> DecodeResult:
        """Host batch API: pad as the JAX package does (to a multiple of
        ``row_bucket`` in spans mode, of ``bucket`` in loop mode; zero
        syndromes), decode, trim."""
        syndromes, _ = as_batch(syndromes, self.m)
        B = syndromes.shape[0]
        pad_to = self.row_bucket if self.mode == "spans" else self.bucket
        Bp = max(B, pad_pow2(min(B, pad_to), floor=8))
        Bp = -(-Bp // min(pad_to, Bp)) * min(pad_to, Bp)
        synds = np.zeros((Bp, self.m), dtype=np.uint8)
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
