"""Phenomenological-noise harness (noisy syndrome measurements).

The counterpart of the JAX package's ``harness/phenomenological.py`` (the
batched form of the reference's ``decode_phenomenological``, Syndrome
code.ipynb cell 1): augment the PCM with identity columns for
syndrome-measurement errors, ``[hx | I]``, decode the noisy syndrome, and
count logical errors on the data part only. Sampling is the JAX package's
numpy code, so for a given seed the samples are the same; the syndromes
and the logical test are float32 matmuls (exact for these 0/1 sums).
"""

from __future__ import annotations

import time

import numpy as np

from ..codes.css import CSSCode


def decode_phenomenological(
    code: CSSCode,
    p: float,
    p_synd: float,
    num_shots: int,
    decoder_builders: dict,
    *,
    pseudo_prior: float | None = None,
    batch_size: int = 4096,
    seed: int | None = None,
    verbose: bool = True,
):
    """Monte-Carlo with iid data flips + iid syndrome readout flips.

    ``decoder_builders``: {name: builder(pcm, priors) -> decoder exposing
    decode_batch} (the builder picks the decoder's device). The augmented
    PCM is [hx | I]; priors are [p .. p, p_synd .. p_synd] (or
    ``pseudo_prior`` for the syndrome columns). A warm-up decode of zero
    syndromes runs first; each decoder's ``seconds`` covers its
    ``decode_batch`` calls and the logical test of their output.
    """
    rng = np.random.default_rng(seed)
    m = code.hx.shape[0]
    new_pcm = np.hstack([code.hx, np.eye(m, dtype=np.uint8)])
    priors = np.concatenate(
        [
            np.full(code.N, p),
            np.full(m, p_synd if pseudo_prior is None else pseudo_prior),
        ]
    )
    decoders = {
        name: build(new_pcm, priors) for name, build in decoder_builders.items()
    }
    results = {
        name: {"num_err": 0, "shots": 0, "seconds": 0.0} for name in decoders
    }
    hxT = code.hx.T.astype(np.float32)
    hz_perp_T = code.hz_perp.T.astype(np.float32)

    warm = np.zeros((min(batch_size, num_shots), m), np.uint8)
    for dec in decoders.values():
        dec.decode_batch(warm)

    remaining = num_shots
    while remaining > 0:
        b = min(batch_size, remaining)
        remaining -= b
        err = (rng.random((b, code.N)) < p).astype(np.uint8)
        synd_err = (rng.random((b, m)) < p_synd).astype(np.uint8)
        syndrome = (((err.astype(np.float32) @ hxT) % 2).astype(np.uint8)) ^ synd_err
        for name, dec in decoders.items():
            t0 = time.perf_counter()
            res = dec.decode_batch(syndrome)
            e_diff = (res.error[:, : code.N] ^ err).astype(np.float32)
            logical = ((e_diff @ hz_perp_T) % 2).any(axis=1)
            results[name]["num_err"] += int(logical.sum())
            results[name]["shots"] += b
            results[name]["seconds"] += time.perf_counter() - t0

    for name, r in results.items():
        r["ler"] = r["num_err"] / max(1, r["shots"])
        r["shots_per_sec"] = r["shots"] / max(1e-9, r["seconds"])
        if verbose:
            print(
                f"{name}: {r['num_err']}/{r['shots']} logical errors "
                f"(LER {r['ler']:.3e}), {r['shots_per_sec']:.1f} shots/s"
            )
    return results
