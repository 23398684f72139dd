"""Code-capacity Monte-Carlo harness.

The counterpart of the JAX package's ``harness/code_capacity.py`` (the
batched form of the reference's ``data_qubit_noise_decoding``,
src/simulation.py:10-99): sample iid data-qubit flips, decode from the
syndrome, count logical errors by the hz-perp test. Any object exposing
``decode_batch(syndromes) -> DecodeResult`` plugs in (the reference's
``extra_decoders`` hook). Sampling is the JAX package's numpy code, so for
a given seed the samples are the same. The syndromes and the logical test
are float32 matmuls (numpy's BLAS), exact for these 0/1 sums of fewer than
2^24 terms, where the JAX package's integer matmuls take tens of seconds a
65536-shot batch on [[882]].

``PARITY_ROWS``, ``parity_code`` and ``parity_decoder`` hold the eight
code-capacity rows of ``docs/PARITY.md`` with the reference's parameters
(the JAX package's ``tools/validate_parity.py:143-186, :362-390``).
"""

from __future__ import annotations

import time

import numpy as np

from ..codes.css import CSSCode


def data_qubit_noise_decoding(
    code: CSSCode,
    p: float,
    num_shots: int,
    decoders: dict,
    *,
    batch_size: int = 4096,
    seed: int | None = None,
    verbose: bool = True,
):
    """Monte-Carlo LER estimate under iid X noise, decoding hx syndromes.

    Each decoder's ``seconds`` covers its ``decode_batch`` calls and the
    logical test of their output (a warm-up decode of zero syndromes runs
    first, outside the timers). Returns {decoder_name: {"num_err",
    "num_flagged", "shots", "ler", "seconds", "shots_per_sec"}}.
    """
    rng = np.random.default_rng(seed)
    results = {
        name: {"num_err": 0, "num_flagged": 0, "shots": 0, "seconds": 0.0}
        for name in decoders
    }
    hxT = code.hx.T.astype(np.float32)
    hz_perp_T = code.hz_perp.T.astype(np.float32)

    warm = np.zeros((min(batch_size, num_shots), code.hx.shape[0]), np.uint8)
    for dec in decoders.values():
        dec.decode_batch(warm)

    remaining = num_shots
    while remaining > 0:
        b = min(batch_size, remaining)
        remaining -= b
        err = (rng.random((b, code.N)) < p).astype(np.uint8)
        syndrome = ((err.astype(np.float32) @ hxT) % 2).astype(np.uint8)
        for name, dec in decoders.items():
            t0 = time.perf_counter()
            res = dec.decode_batch(syndrome)
            e_diff = (res.error ^ err).astype(np.float32)
            logical = ((e_diff @ hz_perp_T) % 2).any(axis=1)
            results[name]["num_err"] += int(logical.sum())
            results[name]["num_flagged"] += int((~res.converged).sum())
            results[name]["shots"] += b
            results[name]["seconds"] += time.perf_counter() - t0

    for name, r in results.items():
        r["ler"] = r["num_err"] / max(1, r["shots"])
        r["shots_per_sec"] = r["shots"] / max(1e-9, r["seconds"])
        if verbose:
            print(
                f"{name}: {r['num_err']}/{r['shots']} logical errors "
                f"(LER {r['ler']:.3e}), {r['num_flagged']} flagged, "
                f"{r['shots_per_sec']:.1f} shots/s"
            )
    return results


# row -> (N, p, decoder, reference (failures, shots), decoder overrides)
PARITY_ROWS = {
    "cc-osd0": (288, 0.02, "osd0", (121, 10_000_000), {}),
    "cc-osdcs": (288, 0.02, "osdcs", (6, 10_000_000), {}),
    "cc-gdg": (288, 0.02, "gdg", (1, 10_000_000), {}),
    "cc882-bpgd-all": (882, 0.04, "bpgd", (34, 1_000_000), {}),
    "cc882-bpgd-partial": (882, 0.04, "bpgd", (551, 1_000_000), {"max_step": 100}),
    "cc882-osd0": (882, 0.04, "osd0", (26, 1_000_000), {}),
    "cc882-osdcs": (882, 0.04, "osdcs", (1, 1_000_000), {}),
    "cc882-gdg": (882, 0.04, "gdg", (20, 1_000_000),
                  {"max_step": 80, "max_tree_branch_step": 60, "max_iter_per_step": 8,
                   "max_side_branch_step": 60, "ensemble_bucket": 32}),
}


def parity_code(N: int) -> CSSCode:
    """The code of a parity row: the [[882,24]] QC-GHP code of
    ``Misc.ipynb`` cell 10, else the bivariate-bicycle code of length N."""
    from ..codes import bb_code_by_n, create_cyclic_permuting_matrix, create_QC_GHP_codes

    if N == 882:
        return create_QC_GHP_codes(63, create_cyclic_permuting_matrix(7, [27, 54, 0]),
                                   [0, 1, 6])
    code, _, _ = bb_code_by_n(N)
    return code


def parity_decoder(code: CSSCode, p: float, which: str, overrides=None, *, device=None):
    """The reference's decoder of a parity row: BP+OSD at min-sum 0.625
    (0.5 at N <= 144) with 100 iterations (simulation.py:44); GDG with the
    simulation.py:67-83 knobs, host-stepped (the JAX package runs these
    rows in spans mode; both forms give the same results, and on an H100
    the host-stepped form decoded cc-gdg 7-10x faster and cc882-gdg as
    fast, PERF.md); BPGD with the ``Misc.ipynb``
    cell 10 knobs (no pre-BP, 12 iterations a step at ``gd_factor`` 0.8,
    every VN). ``which``: "osd0", "osdcs", "gdg" or "bpgd"; ``overrides``
    go to the constructor."""
    from ..decoders import BPGD, BPOSD, GDG

    priors = np.full(code.N, p)
    overrides = dict(overrides or {})
    if which in ("osd0", "osdcs"):
        osd = (dict(osd_method="osd_0") if which == "osd0"
               else dict(osd_method="osd_cs", osd_order=10))
        return BPOSD(code.hx, priors, max_iter=100,
                     ms_scaling_factor=0.5 if code.N <= 144 else 0.625, device=device,
                     **{**osd, **overrides})
    if which == "gdg":
        kw = dict(max_iter=24, ms_scaling_factor=0.625, gdg_factor=0.625,
                  max_iter_per_step=6, max_step=40, max_tree_depth=4, max_side_depth=20,
                  max_tree_branch_step=30, max_side_branch_step=20, new_n=code.N,
                  low_error_mode=True, ensemble_bucket=1024, ensemble_mode="host_loop")
        return GDG(code.hx, priors, device=device, **{**kw, **overrides})
    if which == "bpgd":
        kw = dict(max_iter=0, max_iter_per_step=12, gd_factor=0.8, max_step=code.N,
                  new_n=code.N, bucket=256)
        return BPGD(code.hx, priors, device=device, **{**kw, **overrides})
    raise ValueError(f"unknown decoder {which!r}")
