"""Batched BP + ordered-statistics decoder, in PyTorch.

The counterpart of the JAX package's ``decoders/bposd.py`` (itself the
batched form of the reference's ``BpOsdDecoder``): normalized min-sum BP
to ``max_iter``, then OSD post-processing (OSD-CS, OSD-E or OSD-0) on the
shots BP failed to converge.

Throughput structure, as in the JAX package:

- *Two-phase BP with compaction*: phase A runs a short budget on the full
  batch; survivors are sorted to the front (stable argsort on the
  convergence mask, syndrome weight as a difficulty tiebreak) and walked
  in fixed-size buckets for the rest of the budget, re-sorted before each
  phase-B span. Each bucket exits as soon as all of its shots converge.
- *OSD only on the non-converged shots*, by the same sorted-bucket walk.

The bucket walks are host loops: one ``.item()`` per span (and one per
OSD walk) reads how many shots are left. Per-shot results do not depend on
bucket composition: BP and OSD are shot-independent.

BP messages stay slot-major [dc, m_pad, B] in the message dtype and the
history ring [n, 4, B] between calls (the JAX batch-major carry converts
to f32 and back at every call; bf16 -> f32 -> bf16 is exact, so the
results are the same).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.tanner import compile_graph, graph_tensors
from ..ops.bp import (
    bp_init_messages_sm,
    bp_run,
    column_major,
    history_sum,
    is_column_major,
    take_columns,
)
from ..ops.gf2_solve import (
    analyze_patterns,
    gf2_rank_packed,
    osd_candidate_patterns,
    osd_decode,
    pack_rows_host,
)
from ..utils.device import resolve_device
from .base import DecodeResult, decode_padded


def _divisor_bucket(B: int, want: int) -> int:
    """Largest bucket size <= want that divides B (so the sorted-bucket
    walk never overlaps a processed shot).

    A true largest-divisor search, not gcd: gcd(5632, 2048) = 512 but the
    largest divisor of 5632 that is <= 2048 is 1408."""
    want = max(1, min(want, B))
    return next(d for d in range(want, 0, -1) if B % d == 0)


def osd_tables(pcm, k: int, osd_order: int, method: str, device):
    """The static OSD inputs of one PCM with k free columns: packed rows
    (int32, on ``device``), the candidate patterns over the k columns and
    their ``analyze_patterns`` structure, its pair indices (OSD-CS) or
    patterns (OSD-E) on ``device``."""
    H_words = torch.as_tensor(pack_rows_host(pcm).view(np.int32), device=device)
    patterns = (
        osd_candidate_patterns(max(k, 1), osd_order, method)[:, :k]
        if k > 0
        else np.zeros((0, 0), np.uint8)
    )
    meta = analyze_patterns(patterns, k)
    for key in ("pair_i", "pair_j"):
        if key in meta:  # OSD-CS only
            meta[key] = torch.as_tensor(meta[key], dtype=torch.int32, device=device)
    if "patterns" in meta:  # OSD-E only
        meta["patterns"] = torch.as_tensor(meta["patterns"], device=device)
    return H_words, patterns, meta


class BPOSD:
    """Batched BP+OSD decoder for one parity-check matrix.

    Args:
      pcm: [m, n] binary parity-check matrix (dense numpy).
      channel_probs: [n] prior error probabilities.
      max_iter: total BP iterations.
      ms_scaling_factor: min-sum normalization alpha.
      osd_method: "osd_cs", "osd_e", "osd_0", or "off" to disable OSD.
      osd_order: OSD-CS / OSD-E search depth.
      reliability: "last" orders columns by the final BP posterior;
        "history_sum" uses the 4-iteration posterior sum.
      phase_a_iters: BP iterations run on the full batch before compaction.
      phase_b_spans: phase-B span lengths ("auto", None, or a tuple).
      bp_bucket / osd_bucket: compacted bucket sizes for phase B and OSD.
      msg_dtype: "float32" or "bfloat16" BP messages.
      device: torch device; None means "cuda" (raises without a card).
    """

    def __init__(
        self,
        pcm,
        channel_probs,
        *,
        max_iter: int = 100,
        ms_scaling_factor: float = 1.0,
        osd_method: str = "osd_cs",
        osd_order: int = 10,
        reliability: str = "last",
        clip: float = 50.0,
        bp_bucket: int = 512,
        osd_bucket: int = 512,
        phase_a_iters: int | None = 24,
        phase_b_spans="auto",
        msg_dtype: str = "float32",
        device=None,
    ):
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
        self.clip = float(clip)
        if reliability not in ("last", "history_sum"):
            raise ValueError("reliability must be 'last' or 'history_sum'")
        self.reliability = reliability
        self.msg_dtype = str(msg_dtype)
        if phase_a_iters is None or phase_a_iters >= self.max_iter:
            self.phase_iters = (self.max_iter, 0)
        else:
            self.phase_iters = (int(phase_a_iters), self.max_iter - int(phase_a_iters))
        # phase B runs in spans with a re-compaction between them; spans are
        # multiples of 4 so the history ring slots line up and the
        # trajectory is bit-identical to one long run
        it_b = self.phase_iters[1]
        if phase_b_spans is None or it_b == 0:
            self.phase_b_spans = (it_b,) if it_b else ()
        elif phase_b_spans == "auto":
            self.phase_b_spans = (48, it_b - 48) if it_b > 96 else (it_b,)
        else:
            spans = tuple(int(s) for s in phase_b_spans)
            if sum(spans) != it_b or any(s <= 0 for s in spans):
                raise ValueError(
                    f"phase_b_spans must be positive and sum to {it_b}"
                )
            if any(s % 4 for s in spans[:-1]):
                raise ValueError(
                    "non-final phase_b_spans must be multiples of 4 "
                    "(history ring alignment)"
                )
            self.phase_b_spans = spans

        method = str(osd_method).lower()
        if method in ("osd_0", "osd0", "0"):
            method, osd_order = "osd_0", 0
        elif method in ("osd_e", "osde", "e", "exhaustive", "1"):
            method = "osd_e"
        elif method in ("osd_cs", "osdcs", "cs", "combination_sweep", "2"):
            method = "osd_cs"
        elif method in ("-1", "off", "none"):
            method = None
        else:
            raise ValueError(f"unknown osd_method {osd_method!r}")
        self.osd_method = method
        self.osd_order = int(osd_order)
        self.bp_bucket = int(bp_bucket)
        self.osd_bucket = int(osd_bucket)

        self.graph = compile_graph(pcm)
        self.garr = graph_tensors(self.graph, self.device)
        self.llr = np.log((1 - channel_probs) / channel_probs).astype(np.float32)
        self._llr_dev = torch.as_tensor(self.llr, device=self.device)

        if method is not None:
            self.rank = gf2_rank_packed(pcm)
            self.k = self.n - self.rank
            if self.osd_order > self.k:
                raise ValueError(
                    f"osd_order must be <= n - rank = {self.k}, got {osd_order}"
                )
            self.H_words, self.patterns, self._osd_meta = osd_tables(
                pcm, self.k, self.osd_order, method, self.device
            )
        self._pcm = pcm

    # -- device stages -------------------------------------------------------

    def _run_bp(self, mv, synds, history, error, done, iters, num_iter, *,
                history_mode):
        # BPOSD never decimates, so the unmasked path applies. Converged
        # shots' messages are never consumed downstream (history drives OSD;
        # errors are frozen by the active mask), so the freeze is skipped.
        # Every caller passes fresh state or a bucket's gathered copy and
        # rebinds it, so BP updates it in place.
        return bp_run(
            self.garr, mv, self._llr_dev, synds, history, error, done, iters,
            num_iter=num_iter, alpha=self.alpha, clip=self.clip,
            msg_dtype=self.msg_dtype, freeze_messages=False,
            history_mode=history_mode, io_layout="slot_major", inplace=True,
        )

    def _reliability(self, history, total_iters: int):
        """[n, 4, B] history -> [B, n] OSD ordering key."""
        if self.reliability == "history_sum":
            return history_sum(history)
        return history[:, (total_iters - 1) % 4, :].T

    def _core_bp(self, synds):
        """Phases A+B (no OSD). Returns (synds, error, done, iters, min_pm,
        rel) — ``rel`` is the OSD reliability key, or None when OSD is off."""
        B = synds.shape[0]
        n, m, dev = self.n, self.m, self.device
        it_a, it_b = self.phase_iters
        osd_on = self.osd_method is not None
        synds = synds.to(torch.uint8)

        mv = bp_init_messages_sm(self.garr, self._llr_dev, B, self.msg_dtype)
        history = torch.zeros((n, 4, B), dtype=torch.float32, device=dev)
        error = torch.zeros((B, n), dtype=torch.int8, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)

        # phase A history is dead whenever phase B exists (every shot that
        # reaches OSD is re-run there)
        live_a = it_b == 0 and osd_on
        mv, history, error, done, iters = self._run_bp(
            mv, synds, history, error, done, iters, it_a,
            history_mode="tail" if live_a else "none",
        )

        if it_b > 0:
            # written in place below: no broadcast view (phase A may have
            # run no iteration), each column's messages contiguous
            if not is_column_major(mv):
                mv = column_major(mv)
            bucket = _divisor_bucket(B, self.bp_bucket)
            synd_weight = synds.sum(dim=1, dtype=torch.int32)
            for si, sp in enumerate(self.phase_b_spans):
                last_span = si == len(self.phase_b_spans) - 1
                hmode = "tail" if (osd_on and last_span) else "none"
                key = done.to(torch.int32) * (m + 2) + synd_weight
                order = torch.argsort(key, stable=True)
                n_todo = int((~done).sum())
                for b in range(-(-n_todo // bucket)):
                    idx = order[b * bucket:(b + 1) * bucket]
                    mv_c, hist_c, err_c, done_c, it_c = self._run_bp(
                        take_columns(mv, idx), synds[idx], history[:, :, idx],
                        error[idx], done[idx], iters[idx], sp,
                        history_mode=hmode,
                    )
                    mv[:, :, idx] = mv_c
                    history[:, :, idx] = hist_c
                    error[idx] = err_c
                    done[idx] = done_c
                    iters[idx] = it_c

        error = error.to(torch.uint8)
        min_pm = torch.where(error == 1, self._llr_dev[None, :], 0.0).sum(dim=-1)
        if osd_on:
            last_iters = it_b if it_b > 0 else it_a
            rel = self._reliability(history, last_iters)
        else:
            rel = None
        return synds, error, done, iters, min_pm, rel

    def core(self, synds):
        """Decode a [B, m] syndrome tensor on the decoder's device.

        Returns dict of tensors: error [B, n] uint8, converged [B] bool,
        iterations [B] int32, min_pm [B] f32, osd_applied [B] bool.
        """
        B = synds.shape[0]
        osd_on = self.osd_method is not None
        synds, error, done, iters, min_pm, rel = self._core_bp(synds)
        osd_applied = torch.zeros((B,), dtype=torch.bool, device=self.device)

        if osd_on:
            obucket = _divisor_bucket(B, self.osd_bucket)
            order2 = torch.argsort(done.to(torch.int32), stable=True)
            n_osd = int((~done).sum())
            for b in range(-(-n_osd // obucket)):
                idx = order2[b * obucket:(b + 1) * obucket]
                osd = osd_decode(
                    self.H_words, synds[idx], rel[idx].contiguous(), self._llr_dev,
                    m=self.m, n=self.n, rank=self.rank, k=self.k,
                    meta=self._osd_meta,
                )
                # boundary buckets may straddle converged shots: keep theirs
                done_c = done[idx]
                error[idx] = torch.where(
                    done_c[:, None], error[idx], osd["solution"].to(torch.uint8)
                )
                min_pm[idx] = torch.where(done_c, min_pm[idx], osd["min_pm"])
            osd_applied = ~done

        return {
            "error": error,
            "converged": done,
            "iterations": iters,
            "min_pm": min_pm,
            "osd_applied": osd_applied,
        }

    # -- host API ------------------------------------------------------------

    def decode_batch(self, syndromes) -> DecodeResult:
        return decode_padded(self, syndromes, max(self.bp_bucket, self.osd_bucket))

    def decode(self, syndrome) -> np.ndarray:
        """Single-shot convenience mirroring the reference ``decode`` API."""
        return self.decode_batch(np.asarray(syndrome)[None, :]).error[0]
