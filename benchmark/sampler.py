"""Detector and observable bits drawn on the device from a seed.

A frozen copy of the arithmetic of the port's
``slidingwindowdecoder_torch/circuits/sampler.py:make_dem_sampler`` at
commit 6c64bcc: one Bernoulli draw per fault against the DEM's priors from
a ``torch.Generator`` on the device, then the two GF(2) products in
float32 (exact: every count stays below 2**24, and TF32 is off).
"""

from __future__ import annotations

import torch


def gf2_matmul(a, b_f32):
    """(a @ b) % 2 as uint8, in full float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.remainder(a.to(torch.float32) @ b_f32, 2.0).to(torch.uint8)


def sample_pool(dem, p_batches: int, shots: int, seed: int, device):
    """``p_batches`` batches of ``shots`` shots each: (det [P, S, D] uint8,
    obs [P, S, O] uint8) on ``device``, the same for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    priors = torch.as_tensor(dem.priors, dtype=torch.float32, device=device)
    chk_t = torch.as_tensor(dem.chk.T, dtype=torch.float32, device=device)
    obs_t = torch.as_tensor(dem.obs.T, dtype=torch.float32, device=device)
    det = torch.empty((p_batches, shots, chk_t.shape[1]), dtype=torch.uint8, device=device)
    obs = torch.empty((p_batches, shots, obs_t.shape[1]), dtype=torch.uint8, device=device)
    for b in range(p_batches):
        u = torch.rand((shots, priors.shape[0]), generator=gen, device=device)
        faults = (u < priors).to(torch.uint8)
        del u
        det[b] = gf2_matmul(faults, chk_t)
        obs[b] = gf2_matmul(faults, obs_t)
    return det, obs
