"""Shortened-PCM BP+OSD decoder (the reference's own ``osd_window``), in PyTorch.

The counterpart of the JAX package's ``decoders/osd_window.py`` (the
batched form of osd_window.pyx:158-284): (1) a short masked pre-BP pass on
the full window PCM; (2) for unconverged shots, *shorten* by deciding all
but the ``new_n`` least reliable columns (by 4-iteration posterior sum) to
zero and peeling; (3) a long post-BP pass on the masked graph with fresh
messages; (4) if still unconverged, OSD over the full PCM with decided
columns pinned to the extremes of the reliability order (±1000,
osd_window.pyx:205-213).

The two bucket walks (shorten + post-BP over the pre-BP survivors, OSD
over the post-BP survivors) are host loops, as in ``decoders.bposd``: one
read of how many shots are left before each walk. Per-shot results do not
depend on bucket composition.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.tanner import compile_graph, graph_tensors
from ..ops.bp import bp_init_messages_sm, bp_run, history_sum
from ..ops.decimation import init_decimation_state, set_values_and_peel
from ..ops.gf2_solve import gf2_rank_packed, osd_decode
from ..utils.device import resolve_device
from .base import DecodeResult, decode_padded
from .bposd import _divisor_bucket, osd_tables

PIN = 1000.0  # reliability pin for decided columns (osd_window.pyx:205-213)


def shorten(garr, synd, hist, new_n: int):
    """(2) Shorten a compacted bucket of ``b`` shots: decide all but the
    ``new_n`` least reliable columns (by the pre-BP history sum ``hist``
    [n, 4, b]) to zero, then peel. ``synd``: [b, m] syndromes. Returns
    (vn_state, cn_state, dead), the inputs of the masked post-BP."""
    b, n, dev = synd.shape[0], garr["n"], synd.device
    order = torch.argsort(history_sum(hist), dim=1, stable=True)
    drop = torch.zeros((b, n), dtype=torch.bool, device=dev)
    drop.scatter_(1, order[:, new_n:], True)
    state = init_decimation_state(garr, synd)
    vn, cn, _, dead = set_values_and_peel(garr, *state, drop)
    return vn, cn, dead


class OSDWindow:
    """Batched shortened BP+OSD decoder for one (window) PCM.

    The constructor is the JAX package's, less ``gj_engine`` (the
    elimination always runs through ``ops.gf2_cuda``), plus ``device``
    (None means "cuda"; raises without a card). ``osd_method`` is
    "osd_0", "osd_e" or "osd_cs". BP runs in float32.
    """

    def __init__(
        self,
        pcm,
        channel_probs,
        *,
        pre_max_iter: int = 8,
        post_max_iter: int = 100,
        ms_scaling_factor: float = 1.0,
        new_n: int | None = None,
        osd_method: str = "osd_0",
        osd_order: int = 0,
        clip: float = 50.0,
        bucket: int = 512,
        osd_bucket: int = 256,
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
        self.pre_max_iter = int(pre_max_iter)
        self.post_max_iter = int(post_max_iter)
        self.alpha = float(ms_scaling_factor)
        self.clip = float(clip)
        self.new_n = min(self.n, 2 * self.m) if new_n is None else min(new_n, self.n)
        self.bucket = int(bucket)
        self.osd_bucket = int(osd_bucket)

        method = str(osd_method).lower()
        if method in ("osd_0", "osd0", "0"):
            method, osd_order = "osd_0", 0
        elif method in ("osd_e", "osde", "e", "1"):
            method = "osd_e"
        elif method in ("osd_cs", "osdcs", "cs", "2"):
            method = "osd_cs"
        else:
            raise ValueError(f"unknown osd_method {osd_method!r}")
        self.osd_method = method
        self.osd_order = int(osd_order)

        self.graph = compile_graph(pcm)
        self.garr = graph_tensors(self.graph, self.device)
        self.llr = np.log((1 - channel_probs) / channel_probs).astype(np.float32)
        self._llr_dev = torch.as_tensor(self.llr, device=self.device)

        self.rank = gf2_rank_packed(pcm)
        self.k = self.new_n - self.rank
        if self.osd_order > self.k:
            raise ValueError(
                f"osd_order must be <= new_n - rank = {self.k} "
                f"(osd_window.pyx:89 bound), got {osd_order}"
            )
        self.H_words, self.patterns, self._osd_meta = osd_tables(
            pcm, self.k, self.osd_order, method, self.device
        )

    def _shorten_post(self, synd_c, hist_c):
        """One compacted bucket: shorten -> post-BP.

        ``hist_c``: the bucket's pre-BP history [n, 4, b]. Returns (error
        [b, n] int8, post_conv, dead, iters, rel) where ``rel`` is the OSD
        reliability order (post-BP history sum, decided columns pinned to
        -/+PIN).
        """
        b = synd_c.shape[0]
        n, garr, dev = self.n, self.garr, self.device
        vn_c, cn_c, dead_c = shorten(garr, synd_c, hist_c, self.new_n)

        # (3) post-BP on the masked graph, fresh messages and history.
        # Messages are discarded and only non-converged shots' histories
        # feed OSD, so the converged-shot freeze and the pre-tail history
        # writes are skipped (as in the JAX package). Dead shots enter done.
        # The state is fresh and rebound, so BP updates it in place; ``done``
        # is a copy of ``dead_c``, which is read after the call.
        mv_c = bp_init_messages_sm(garr, self._llr_dev, b)
        hist2 = torch.zeros((n, 4, b), dtype=torch.float32, device=dev)
        err_c = torch.where(vn_c != -1, vn_c, torch.zeros((), dtype=torch.int8, device=dev))
        it_c = torch.zeros((b,), dtype=torch.int32, device=dev)
        _, hist2, err_c, done_c, it_c = bp_run(
            garr, mv_c, self._llr_dev, synd_c, hist2, err_c, dead_c.clone(), it_c,
            num_iter=self.post_max_iter, alpha=self.alpha, clip=self.clip,
            freeze_messages=False, history_mode="tail", io_layout="slot_major",
            vn_state=vn_c, cn_state=cn_c, masked=True, inplace=True,
        )
        # dead shots keep the (partially decimated) BP decision
        post_conv = done_c & ~dead_c
        rel = torch.where(vn_c == 1, -PIN, torch.where(vn_c == 0, PIN, history_sum(hist2)))
        return err_c, post_conv, dead_c, it_c, rel

    def core(self, synds):
        """Decode a [B, m] syndrome tensor on the decoder's device.

        Returns dict: error [B, n] uint8, converged [B] bool, iterations [B]
        int32, min_pm [B] f32, osd_applied [B] bool, and ``counts`` (host
        ints): the shots that entered post-BP, OSD, and ended dead.
        """
        B = synds.shape[0]
        n, m, garr, dev = self.n, self.m, self.garr, self.device
        synds = synds.to(torch.uint8)

        # (1) pre-BP on the full graph, masked with nothing decided. Its
        # messages are discarded, so converged shots need no freeze; the
        # state is fresh, so BP updates it in place.
        mv = bp_init_messages_sm(garr, self._llr_dev, B)
        history = torch.zeros((n, 4, B), dtype=torch.float32, device=dev)
        error = torch.zeros((B, n), dtype=torch.int8, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        _, history, error, done, iters = bp_run(
            garr, mv, self._llr_dev, synds, history, error, done, iters,
            num_iter=self.pre_max_iter, alpha=self.alpha, clip=self.clip,
            freeze_messages=False, io_layout="slot_major", masked=True, inplace=True,
        )

        # --- walk 1: shorten + post-BP over pre-BP survivors ---------------
        bucket = _divisor_bucket(B, self.bucket)
        synd_weight = synds.sum(dim=1, dtype=torch.int32)
        key = done.to(torch.int32) * (m + 2) + synd_weight
        order = torch.argsort(key, stable=True)
        n_todo = int((~done).sum())
        rel = torch.zeros((B, n), dtype=torch.float32, device=dev)
        dead = torch.zeros((B,), dtype=torch.bool, device=dev)
        for b in range(-(-n_todo // bucket)):
            idx = order[b * bucket:(b + 1) * bucket]
            done_c = done[idx]
            err_c, post_conv, dead_c, it_c, rel_c = self._shorten_post(
                synds[idx], history[:, :, idx]
            )
            # boundary buckets may straddle converged shots: keep theirs
            error[idx] = torch.where(done_c[:, None], error[idx], err_c)
            done[idx] = done_c | post_conv
            iters[idx] = iters[idx] + torch.where(done_c, 0, it_c)
            dead[idx] = dead_c & ~done_c
            rel[idx] = rel_c

        # --- walk 2: OSD over post-BP survivors only -----------------------
        # (dead shots keep the partial BP decision, as the reference's
        # contradiction abort does, osd_window.pyx:321-343)
        need_osd = ~done & ~dead
        obucket = _divisor_bucket(B, self.osd_bucket)
        order2 = torch.argsort((~need_osd).to(torch.int32), stable=True)
        n_osd, n_dead = torch.stack([need_osd.sum(), dead.sum()]).tolist()
        for b in range(-(-n_osd // obucket)):
            idx = order2[b * obucket:(b + 1) * obucket]
            osd = osd_decode(
                self.H_words, synds[idx], rel[idx], self._llr_dev,
                m=m, n=n, rank=self.rank, k=self.k, meta=self._osd_meta,
            )
            error[idx] = torch.where(need_osd[idx][:, None],
                                     osd["solution"].to(torch.int8), error[idx])

        error = error.to(torch.uint8)
        min_pm = torch.where(error == 1, self._llr_dev[None, :], 0.0).sum(dim=-1)
        return {
            "error": error,
            "converged": done,
            "iterations": iters,
            "min_pm": min_pm,
            "osd_applied": need_osd,
            "counts": {"post_bp": n_todo, "osd": n_osd, "dead": n_dead},
        }

    # -- host API ------------------------------------------------------------

    def decode_batch(self, syndromes) -> DecodeResult:
        return decode_padded(self, syndromes, max(self.bucket, self.osd_bucket))

    def decode(self, syndrome) -> np.ndarray:
        """Single-shot convenience mirroring the reference ``decode`` API."""
        return self.decode_batch(np.asarray(syndrome)[None, :]).error[0]
