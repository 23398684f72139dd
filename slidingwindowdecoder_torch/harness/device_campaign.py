"""Device-resident code-capacity Monte-Carlo campaigns.

The counterpart of the JAX package's ``harness/device_campaign.py``. The
host harness (``harness.code_capacity``) samples errors with numpy and
forms syndromes and the logical test as numpy matmuls; here a batch's
sampling, syndromes, decode and logical test all run on the decoder's
device, and the host reads two counters a batch (besides the decoder's own
bucket-walk reads).

Sampling: a ``torch.Generator`` on the decoder's device, seeded anew for
every batch from (seed, process_id, batch_index) and never carried across
batches: the derivation contract of the JAX package (and of
``parallel.checkpoint``), so a resumed run counts exactly what an
uninterrupted one does. The stream is torch's, not JAX's: the counts agree
with the JAX package's statistically, not shot for shot.

The mod-2 products are float32 matmuls with float32 results: every partial
sum is an integer of at most n < 2^24 terms of 0/1, so it is exact (a
bfloat16 result would be exact only up to 256).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..codes.css import CSSCode
from ..parallel.checkpoint import batch_seed, run_checkpointed


def _mod2_matmul(x_bits, wT):
    """[B, n] 0/1 (bool or integer) @ [n, k] 0/1 float32 -> [B, k] uint8,
    mod 2, exact (float32 accumulation of at most n < 2^24 ones)."""
    acc = x_bits.to(torch.float32) @ wT
    return torch.remainder(acc, 2.0).to(torch.uint8)


def make_cc_step(code: CSSCode, p: float, decoder, batch: int, *, seed: int,
                 process_id: int = 0):
    """The per-batch step of an iid-X code-capacity campaign on
    ``decoder.device``. ``decoder.core(synds) -> dict`` takes a [batch, m]
    uint8 tensor on that device (BPOSD, GDG and BPGD do). Returns
    ``step(batch_index, valid_count) -> (failed, flagged)`` as ints;
    shots past ``valid_count`` are sampled and decoded but not counted."""
    dev = decoder.device
    hxT = torch.as_tensor(code.hx.T.astype(np.float32), device=dev)
    hz_perp_T = torch.as_tensor(code.hz_perp.T.astype(np.float32), device=dev)
    n = code.N

    def step(batch_index: int, valid_count: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(batch_seed(seed, process_id, batch_index))
        err = torch.rand((batch, n), generator=gen, device=dev) < p
        synds = _mod2_matmul(err, hxT)
        out = decoder.core(synds)
        e_diff = err ^ (out["error"] == 1)
        logical = (_mod2_matmul(e_diff, hz_perp_T) == 1).any(dim=1)
        valid = torch.arange(batch, device=dev) < valid_count
        counts = torch.stack([(logical & valid).sum(), (~out["converged"] & valid).sum()])
        failed, flagged = counts.tolist()  # one host read
        return failed, flagged

    return step


def run_cc_campaign_device(
    code: CSSCode,
    p: float,
    num_shots: int,
    decoder,
    *,
    batch: int = 65536,
    seed: int = 0,
    checkpoint=None,
    checkpoint_every: int = 10,
    verbose: bool = False,
    name: str = "cc",
    warmup: bool = True,
):
    """Run a code-capacity campaign on the decoder's device, in batches of
    ``batch`` shots (the last one padded and masked).

    With ``checkpoint`` (a ``MonteCarloCheckpoint``) the run is
    interruptible and resumable under the derivation contract. Returns
    the harness-standard result dict; ``seconds`` covers the campaign
    after a warm-up step of zero valid shots (kernel builds, graph tables;
    ``warmup=False`` skips it) and ends in a synchronize.
    """
    step = make_cc_step(code, p, decoder, batch, seed=seed,
                        process_id=checkpoint.process_id if checkpoint else 0)
    if warmup:  # same shapes, no shot counted
        step(2**30, 0)

    def run_batch(idx, shots):
        failed, flagged = step(idx, shots)
        if verbose and idx % 20 == 0:
            print(f"{name} batch {idx}: +{failed} fails", flush=True)
        return {"failed": failed, "flagged": flagged, "shots": shots}

    t0 = time.perf_counter()
    if checkpoint is not None:
        out = run_checkpointed(num_shots, batch, run_batch, checkpoint,
                               checkpoint_every=checkpoint_every, root_seed=seed)
        counts = out["counts"]
    else:
        counts = {"failed": 0, "flagged": 0, "shots": 0}
        for idx in range(-(-num_shots // batch)):
            shots = min(batch, num_shots - idx * batch)
            for k, v in run_batch(idx, shots).items():
                counts[k] += v
    if decoder.device.type == "cuda":
        torch.cuda.synchronize(decoder.device)
    dt = time.perf_counter() - t0
    shots = counts["shots"]
    return {
        "num_err": counts["failed"],
        "num_flagged": counts["flagged"],
        "shots": shots,
        "ler": counts["failed"] / max(1, shots),
        "seconds": dt,
        "shots_per_sec": shots / max(dt, 1e-9),
    }
