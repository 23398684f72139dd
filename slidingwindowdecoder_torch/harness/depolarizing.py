"""Quaternary code-capacity harness (depolarizing noise, BP4+OSD).

The counterpart of the JAX package's ``harness/depolarizing.py`` (the
batched form of the reference's Misc.ipynb experiments): iid depolarizing
noise on data qubits, joint (Hx, Hz) syndromes, BP4+OSD (or CAMEL)
decoding, a per-component logical-error test. Sampling is the JAX
package's numpy code, so for a given seed the samples are the same. The
syndromes and the logical test are float32 matmuls (numpy's BLAS), exact
for these 0/1 sums of fewer than 2^24 terms.
"""

from __future__ import annotations

import time

import numpy as np

from ..codes.css import CSSCode
from ..decoders.bp4 import BP4OSD


def sample_depolarizing(N: int, p: float, shots: int, rng):
    """iid depolarizing: each qubit I/X/Y/Z with prob (1-p, p/3, p/3, p/3)."""
    r = rng.random((shots, N))
    which = (r < p) * (1 + (r * 3 / p).astype(np.int8) % 3)
    ex = ((which == 1) | (which == 2)).astype(np.uint8)
    ez = ((which == 2) | (which == 3)).astype(np.uint8)
    return ex, ez


def _gf2(a, b_t):
    """(a @ b_t) % 2 for 0/1 arrays, as uint8 (float32 products, exact)."""
    return ((a.astype(np.float32) @ b_t) % 2).astype(np.uint8)


def depolarizing_decoding(
    code: CSSCode,
    p: float,
    num_shots: int,
    *,
    max_iter: int = 100,
    ms_scaling_factor: float = 1.0,
    osd_method: str = "osd_cs",
    osd_order: int = 10,
    camel: bool = False,
    batch_size: int = 2048,
    seed: int | None = None,
    verbose: bool = True,
    device=None,
):
    """Monte-Carlo LER under depolarizing noise with BP4(+OSD | CAMEL).

    The JAX package's function, plus ``device`` (None means "cuda"; raises
    without a card). A warm-up decode of zero syndromes runs first; the
    timer then covers the sampling, decoding and logical test of every
    batch. A residual Z component is a logical error iff it overlaps
    ker(hz) = hz_perp, a residual X component iff it overlaps hx_perp
    (Misc.ipynb cell 2)."""
    rng = np.random.default_rng(seed)
    probs = np.full(code.N, p / 3)
    dec = BP4OSD(
        code.hx,
        code.hz,
        channel_probs_x=probs,
        channel_probs_y=probs,
        channel_probs_z=probs,
        max_iter=max_iter,
        ms_scaling_factor=ms_scaling_factor,
        osd_method=osd_method,
        osd_order=osd_order,
        device=device,
    )
    decode = dec.camel_decode if camel else dec.decode_batch
    hxT = code.hx.T.astype(np.float32)
    hzT = code.hz.T.astype(np.float32)
    hx_perp_T = code.hx_perp.T.astype(np.float32)
    hz_perp_T = code.hz_perp.T.astype(np.float32)

    num_err = num_flagged = shots_done = 0
    wb = min(batch_size, num_shots)
    decode(np.zeros((wb, code.hx.shape[0]), np.uint8),
           np.zeros((wb, code.hz.shape[0]), np.uint8))
    t0 = time.perf_counter()
    remaining = num_shots
    while remaining > 0:
        b = min(batch_size, remaining)
        remaining -= b
        ex, ez = sample_depolarizing(code.N, p, b, rng)
        res = decode(_gf2(ez, hxT), _gf2(ex, hzT))
        dx = res.error[:, 0] ^ ex
        dz = res.error[:, 1] ^ ez
        logical = _gf2(dz, hz_perp_T).any(axis=1) | _gf2(dx, hx_perp_T).any(axis=1)
        num_err += int(logical.sum())
        num_flagged += int((~res.converged).sum())
        shots_done += b
    seconds = time.perf_counter() - t0
    result = {
        "num_err": num_err,
        "num_flagged": num_flagged,
        "shots": shots_done,
        "ler": num_err / max(1, shots_done),
        "seconds": seconds,
        "shots_per_sec": shots_done / max(seconds, 1e-9),
    }
    if verbose:
        print(
            f"BP4{'+CAMEL' if camel else '+OSD'}: {num_err}/{shots_done} logical "
            f"(LER {result['ler']:.3e}), {num_flagged} flagged, "
            f"{result['shots_per_sec']:.1f} shots/s"
        )
    return result
