"""Quaternary BP + per-basis OSD decoder (and CAMEL decimation), in PyTorch.

The counterpart of the JAX package's ``decoders/bp4.py`` (the batched form
of the reference ``bp4_osd`` class, bp4_osd.pyx:6-685): GF(4) BP over the
joint (Hx, Hz) pair (``ops.bp4``), and, for the shots it leaves
unconverged, a *separate* binary OSD per basis on the marginalized
component posteriors (``ops.gf2_solve.osd_decode``, kernel B on the card):

  basis x: solve  Hx e_z = synd_x,  columns ranked by
           log1pexp(-lpr_x) - logaddexp(-lpr_y, -lpr_z)   (:478-480)
  basis z: solve  Hz e_x = synd_z,  ranked symmetrically.

``camel_decode`` is the CAMEL trick (:223-248): decimate the last variable
to each of I/X/Z/Y, run BP4 on each branch, keep the converged branch of
least path metric.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.tanner import compile_graph, graph_tensors
from ..ops.bp4 import bp4_graph, bp4_init_messages, bp4_run, log1pexp, logaddexp
from ..ops.gf2_solve import gf2_rank_packed, osd_decode
from ..utils.device import resolve_device
from .base import DecodeResult
from .bposd import _divisor_bucket, osd_tables

# the path metric CAMEL gives a branch that did not converge (the JAX value)
UNCONVERGED_PM = 1e4


class BP4OSD:
    """Batched quaternary BP with per-basis OSD post-processing.

    The constructor is the JAX package's, plus ``device`` (None means
    "cuda"; raises without a card). ``osd_method``: "osd_0", "osd_cs",
    "osd_e" or "off" (the JAX aliases).
    """

    def __init__(
        self,
        Hx,
        Hz,
        *,
        channel_probs_x,
        channel_probs_y,
        channel_probs_z,
        max_iter: int = 32,
        ms_scaling_factor: float = 1.0,
        osd_method: str = "osd_0",
        osd_order: int = 0,
        clip: float = 50.0,
        osd_bucket: int = 512,
        device=None,
    ):
        self.device = resolve_device(device)
        Hx = np.asarray(Hx)
        Hz = np.asarray(Hz)
        if Hx.shape[1] != Hz.shape[1]:
            raise ValueError("Hx, Hz block length mismatch")
        self.mx, self.n = Hx.shape
        self.mz = Hz.shape[0]
        px = np.asarray(channel_probs_x, dtype=np.float64)
        py = np.asarray(channel_probs_y, dtype=np.float64)
        pz = np.asarray(channel_probs_z, dtype=np.float64)
        if not (px.shape == py.shape == pz.shape == (self.n,)):
            raise ValueError(f"channel prob vectors must have shape ({self.n},)")
        rest = 1.0 - px - py - pz
        if np.any(rest <= 0) or np.any(px <= 0) or np.any(py <= 0) or np.any(pz <= 0):
            raise ValueError("channel probabilities must be in (0,1) and sum < 1")
        self.llr_x = np.log(rest / px).astype(np.float32)
        self.llr_y = np.log(rest / py).astype(np.float32)
        self.llr_z = np.log(rest / pz).astype(np.float32)
        # collapsed binary priors per basis: Hx solves the Z-component
        # (flip prob pz + py), Hz the X-component (px + py)
        self.prior_llr_hx = np.log((1 - pz - py) / (pz + py)).astype(np.float32)
        self.prior_llr_hz = np.log((1 - px - py) / (px + py)).astype(np.float32)

        self.max_iter = int(max_iter)
        self.alpha = float(ms_scaling_factor)
        self.clip = float(clip)
        self.osd_bucket = int(osd_bucket)

        self.gx = compile_graph(Hx)
        self.gz = compile_graph(Hz)
        self.gx_t = bp4_graph(graph_tensors(self.gx, self.device))
        self.gz_t = bp4_graph(graph_tensors(self.gz, self.device))

        method = str(osd_method).lower()
        if method in ("osd_0", "osd0", "0"):
            method, osd_order = "osd_0", 0
        elif method in ("osd_e", "osde", "e", "1"):
            method = "osd_e"
        elif method in ("osd_cs", "osdcs", "cs", "2"):
            method = "osd_cs"
        elif method in ("off", "none", "-1"):
            method = None
        else:
            raise ValueError(f"unknown osd_method {osd_method!r}")
        self.osd_method = method
        self.osd_order = int(osd_order)
        if method is not None:
            self.rank_x = gf2_rank_packed(Hx)
            self.rank_z = gf2_rank_packed(Hz)
            self.kx = self.n - self.rank_x
            self.kz = self.n - self.rank_z
            if self.osd_order > min(self.kx, self.kz):
                raise ValueError(f"osd_order must be <= {min(self.kx, self.kz)}")
            self.Hx_words, self.pats_x, self._meta_x = osd_tables(
                Hx, self.kx, self.osd_order, method, self.device)
            self.Hz_words, self.pats_z, self._meta_z = osd_tables(
                Hz, self.kz, self.osd_order, method, self.device)
            self._prior_hx = torch.as_tensor(self.prior_llr_hx, device=self.device)
            self._prior_hz = torch.as_tensor(self.prior_llr_hz, device=self.device)

        self._llr_dev = tuple(
            torch.as_tensor(v, device=self.device) for v in (self.llr_x, self.llr_y, self.llr_z)
        )
        self._llr64 = torch.as_tensor(
            np.stack([self.llr_x, self.llr_y, self.llr_z]), dtype=torch.float64,
            device=self.device)

    # ------------------------------------------------------------------

    def _run_bp4(self, synds_x, synds_z, vn_state, cn_x, cn_z):
        B = synds_x.shape[0]
        lx, ly, lz = self._llr_dev
        mvx, mvz = bp4_init_messages(self.gx_t, self.gz_t, lx, ly, lz, B)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        iters = torch.zeros((B,), dtype=torch.int32, device=self.device)
        return bp4_run(
            self.gx_t, self.gz_t, mvx, mvz, lx, ly, lz, synds_x, synds_z, vn_state,
            cn_x, cn_z, done, iters, num_iter=self.max_iter, alpha=self.alpha,
            clip=self.clip,
        )

    def core(self, synds_x, synds_z):
        """Decode [B, mx] and [B, mz] syndrome tensors on the decoder's
        device. Unconverged shots are compacted to the front and the
        per-basis OSD runs over ``_divisor_bucket`` buckets of them (as in
        ``BPOSD.core``). Returns a dict: error [B, 2, n] uint8 (x, z),
        converged [B] bool, iterations [B] int32, min_pm [B] f32."""
        B = synds_x.shape[0]
        sx = synds_x.to(torch.uint8)
        sz = synds_z.to(torch.uint8)
        vn_state = torch.full((B, self.n), -1, dtype=torch.int8, device=self.device)
        (_, _, lprx, lpry, lprz, ex, ez, done, iters) = self._run_bp4(sx, sz, vn_state, sx, sz)
        err_x = ex.to(torch.uint8)
        err_z = ez.to(torch.uint8)

        if self.osd_method is not None:
            bucket = _divisor_bucket(B, self.osd_bucket)
            order = torch.argsort(done.to(torch.int32), stable=True)
            n_todo = int((~done).sum())
            for b in range(-(-n_todo // bucket)):
                idx = order[b * bucket:(b + 1) * bucket]
                lprx_c, lpry_c, lprz_c = lprx[idx], lpry[idx], lprz[idx]
                # basis x: Hx e_z = synd_x
                rel_x = log1pexp(-lprx_c) - logaddexp(-lpry_c, -lprz_c)
                out_x = osd_decode(
                    self.Hx_words, sx[idx], rel_x, self._prior_hx, m=self.mx, n=self.n,
                    rank=self.rank_x, k=self.kx, meta=self._meta_x,
                )
                # basis z: Hz e_x = synd_z
                rel_z = log1pexp(-lprz_c) - logaddexp(-lpry_c, -lprx_c)
                out_z = osd_decode(
                    self.Hz_words, sz[idx], rel_z, self._prior_hz, m=self.mz, n=self.n,
                    rank=self.rank_z, k=self.kz, meta=self._meta_z,
                )
                # boundary buckets may straddle converged shots: keep theirs
                done_c = done[idx][:, None]
                err_x[idx] = torch.where(done_c, err_x[idx], out_z["solution"].to(torch.uint8))
                err_z[idx] = torch.where(done_c, err_z[idx], out_x["solution"].to(torch.uint8))

        return {
            "error": torch.stack([err_x, err_z], dim=1),  # [B, 2, n]
            "converged": done,
            "iterations": iters,
            "min_pm": self._cal_pm(err_x, err_z).float(),
        }

    def decode_batch(self, syndromes_x, syndromes_z) -> DecodeResult:
        """Decode; returns DecodeResult with error = [B, 2, n] (x, z)."""
        return self._host(self.core, syndromes_x, syndromes_z)

    def _host(self, fn, syndromes_x, syndromes_z) -> DecodeResult:
        sx = np.atleast_2d(np.asarray(syndromes_x, dtype=np.uint8))
        sz = np.atleast_2d(np.asarray(syndromes_z, dtype=np.uint8))
        out = fn(torch.as_tensor(sx, device=self.device), torch.as_tensor(sz, device=self.device))
        return DecodeResult(
            error=out["error"].cpu().numpy(),
            converged=out["converged"].cpu().numpy(),
            iterations=out["iterations"].cpu().numpy(),
            min_pm=out["min_pm"].cpu().numpy(),
        )

    def _cal_pm(self, err_x, err_z):
        """[B] path metric over the Pauli components (bp4_osd.pyx:250-259),
        in float64: llr_y over the Y positions, llr_x over X-only, llr_z
        over Z-only. The terms are f32 and the sum exact in f64 (JAX sums
        in f32), so the card and the CPU, and JAX but at exact ties, pick
        the same CAMEL branch."""
        both = (err_x == 1) & (err_z == 1)
        only_x = (err_x == 1) & ~both
        only_z = (err_z == 1) & ~both
        lx, ly, lz = self._llr64
        return (torch.where(both, ly, 0.0) + torch.where(only_x, lx, 0.0)
                + torch.where(only_z, lz, 0.0)).sum(dim=1)

    def camel_core(self, synds_x, synds_z):
        """CAMEL on [B, mx] and [B, mz] syndrome tensors: decimate the last
        VN to each Pauli (4 branch lanes per shot, [4B] in all), run BP4 on
        each, keep the converged branch of least path metric
        (bp4_osd.pyx:223-248; ``UNCONVERGED_PM`` for a branch that did not
        converge, ties to the first branch)."""
        B = synds_x.shape[0]
        n, dev = self.n, self.device
        last = n - 1
        hx_adj = torch.as_tensor(self.gx.vn_cn[last][self.gx.vn_valid[last]], device=dev).long()
        hz_adj = torch.as_tensor(self.gz.vn_cn[last][self.gz.vn_valid[last]], device=dev).long()

        reps_x = synds_x.to(torch.uint8).repeat_interleave(4, dim=0)
        reps_z = synds_z.to(torch.uint8).repeat_interleave(4, dim=0)
        values = torch.arange(4, dtype=torch.int8, device=dev).repeat(B)
        vn_state = torch.full((4 * B, n), -1, dtype=torch.int8, device=dev)
        vn_state[:, last] = values
        cn_x = reps_x.to(torch.int8)
        cn_z = reps_z.to(torch.int8)
        cn_x[:, hx_adj] ^= (values // 2)[:, None]
        cn_z[:, hz_adj] ^= (values % 2)[:, None]

        (_, _, _, _, _, ex, ez, done, iters) = self._run_bp4(reps_x, reps_z, vn_state,
                                                             cn_x, cn_z)
        conv = done.reshape(B, 4)
        ex = ex.to(torch.uint8).reshape(B, 4, n)
        ez = ez.to(torch.uint8).reshape(B, 4, n)
        pm = self._cal_pm(ex.reshape(-1, n), ez.reshape(-1, n)).reshape(B, 4)
        pm = torch.where(conv, pm, UNCONVERGED_PM)
        best = pm.argmin(dim=1)
        lane = torch.arange(B, device=dev)
        return {
            "error": torch.stack([ex[lane, best], ez[lane, best]], dim=1),
            "converged": conv.any(dim=1),
            "iterations": iters.reshape(B, 4).sum(dim=1),
            "min_pm": pm[lane, best].float(),
        }

    def camel_decode(self, syndromes_x, syndromes_z) -> DecodeResult:
        """CAMEL: decimate the last VN to each Pauli, keep the min-pm branch."""
        return self._host(self.camel_core, syndromes_x, syndromes_z)
