"""The reference's window loop and final accounting.

Follows the reference algorithm that the port's ``slidingwindowdecoder_torch/
windows/pipeline.py`` (``decode_sliding_window``, ``evaluate_logical_errors``
at commit 6c64bcc) implements: decode each window from the detectors
corrected so far, commit its first ``F`` rounds' columns (the last window
all of its columns), subtract the committed columns' syndrome from every
detector, slide on; a shot fails if its correction leaves any detector
unexplained or flips any observable.
"""

from __future__ import annotations

import importlib

import torch

from .plan import build_plan


def gf2_matmul(a, b_f32):
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.remainder(a.to(torch.float32) @ b_f32, 2.0).to(torch.uint8)


class Reference:
    """The plain reference of one configuration over one DEM: its own
    window plan and, per distinct window, a decoder of the configuration's
    ``decoder`` module (``benchmark/reference/<decoder>.py``)."""

    def __init__(self, config: dict, dem, device, msg_dtype: str | None = None):
        self.plan = build_plan(dem.chk, dem.obs, dem.priors, config["code_n"] // 2,
                               config["W"], config["F"])
        module = importlib.import_module(f"{__package__}.{config['decoder']}")
        cache = {}
        self.decoders = []
        for w in self.plan.windows:
            key = (w.mat.shape, w.mat.tobytes(), w.prior.tobytes())
            if key not in cache:
                cache[key] = module.Decoder(w.mat, w.prior, config["knobs"], device,
                                            msg_dtype=msg_dtype)
            self.decoders.append(cache[key])
        self.chk_t = torch.as_tensor(self.plan.chk.T, dtype=torch.float32, device=device)
        self.obs_t = torch.as_tensor(self.plan.obs.T, dtype=torch.float32, device=device)

    def decode(self, det, obs):
        """[S, D] detectors and [S, O] observables (uint8, on the device) ->
        (corrections [S, C] uint8 in the plan's column order, failed [S])."""
        total = torch.zeros((det.shape[0], self.chk_t.shape[0]), dtype=torch.uint8,
                            device=det.device)
        new_det = det
        for w, dec in zip(self.plan.windows, self.decoders):
            e = dec.decode(new_det[:, w.row_start:w.row_end].contiguous())
            ncommit = w.commit_col_end - w.col_start
            committed = e[:, :ncommit]
            total[:, w.col_start:w.col_start + ncommit] = committed
            new_det = new_det ^ gf2_matmul(
                committed, self.chk_t[w.col_start:w.col_start + ncommit])
        failed = ((gf2_matmul(total, self.chk_t) ^ det).any(dim=1)
                  | (gf2_matmul(total, self.obs_t) ^ obs).any(dim=1))
        return total, failed

