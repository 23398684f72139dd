"""The reference of the ``bposd`` configurations: BP+OSD-CS per window.

Plain min-sum BP to ``max_iter`` iterations on every shot (each shot
frozen at its first converged iteration), then OSD-CS of order
``osd_order`` on the shots that did not converge, keyed by the posterior
of their last iteration. The port (``slidingwindowdecoder_torch/decoders/
bposd.py`` at commit 6c64bcc) runs the same iterations in a phase A on
the whole batch and phase-B spans over sorted buckets, and OSD over
buckets; every span is a multiple of 4 iterations, so its history slot
of the last iteration is this one's, and no shot's result depends on its
bucket. This reference runs neither phases nor buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bp, osd
from .tanner import graph_tables

CLIP = 50.0


class Decoder:
    def __init__(self, mat, prior, knobs: dict, device, msg_dtype: str | None = None):
        self.g = graph_tables(mat, device)
        self.m, self.n = mat.shape
        probs = np.asarray(prior, dtype=np.float64)
        self.llr = torch.as_tensor(np.log((1 - probs) / probs).astype(np.float32),
                                   device=device)
        self.max_iter = int(knobs["max_iter"])
        self.alpha = float(knobs.get("ms_scaling_factor", 1.0))
        self.order = int(knobs.get("osd_order", 10))
        self.q = bp.rounding(msg_dtype or knobs.get("msg_dtype", "float32"))
        self.rank = osd.gf2_rank(mat)
        self.H_words = torch.as_tensor(osd.pack_rows(mat).view(np.int32), device=device)
        self.pairs = osd.cs_pairs(self.order)

    def decode(self, synd):
        """[B, m] uint8 syndromes -> [B, n] uint8 corrections."""
        g, B, n = self.g, synd.shape[0], self.n
        dev = synd.device
        synd_t = bp.syndrome_slot_major(g, synd)
        _, hist, err_t, done, _, _ = bp.bp_loop(
            g, bp.init_messages(g, self.llr, B, self.q), self.llr, synd_t, synd_t, None,
            torch.zeros((n, 4, B), dtype=torch.float32, device=dev),
            torch.zeros((n, B), dtype=torch.int8, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            num_iter=self.max_iter, hist_from=self.max_iter - 4, alpha=self.alpha,
            clip=CLIP, masked=False, q=self.q, q_hist=lambda x: x)
        error = err_t.T.to(torch.uint8).contiguous()
        todo = (~done).nonzero()[:, 0]
        if todo.numel():
            rel = hist[:, (self.max_iter - 1) % 4, :].T[todo]
            error[todo] = osd.osd_cs(self.H_words, synd[todo], rel, self.llr, *self.pairs,
                                     m=self.m, n=self.n, rank=self.rank, order=self.order)
        return error
