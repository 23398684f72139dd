"""Circuit-level sliding-window Monte-Carlo experiments.

The counterpart of the JAX package's ``harness/circuit_level.py`` (the
reference's ``sliding_window_decoder``, osd.py:15-194): build the BB code
+ syndrome circuit, compile the DEM, extract the (W, F) window plan,
sample detector data, run the window pipeline with a batched decoder per
window (``decoders.BPOSD``, or ``decoders.OSDWindow`` when shortened), and
report flagged / logical error rates per round.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..codes import bb_code_by_n
from ..circuits import build_bb_memory_circuit, compile_dem, sample_dem_numpy
from ..utils.device import resolve_device
from ..windows.pipeline import (
    CachingDecoderFactory,
    decode_sliding_window,
    evaluate_logical_errors,
)
from ..windows.regions import build_sliding_window_plan


def build_bb_window_experiment(
    N: int,
    p: float,
    num_repeat: int,
    W: int,
    F: int,
    *,
    method: int = 1,
    z_basis: bool = True,
):
    """Code + circuit + DEM + window plan for a BB memory experiment."""
    code, A_list, B_list = bb_code_by_n(N)
    circuit = build_bb_memory_circuit(
        code, A_list, B_list, p, num_repeat, z_basis=z_basis
    )
    dem = compile_dem(circuit)
    plan = build_sliding_window_plan(
        dem.chk,
        dem.obs,
        dem.priors,
        n_half=code.N // 2,
        W=W,
        F=F,
        method=method,
        z_basis=z_basis,
        code_n=code.N,
    )
    return code, circuit, dem, plan


def window_decoder_factory(
    shorten: bool = False,
    *,
    max_iter: int = 200,
    osd_method: str = "osd_cs",
    osd_order: int = 10,
    ms_scaling_factor: float = 1.0,
    device=None,
    **decoder_kwargs,
):
    """The per-window decoder factory of ``sliding_window_decoder``.

    ``shorten=False`` builds ``BPOSD`` with ``max_iter`` BP iterations;
    ``shorten=True`` builds the shortened ``OSDWindow`` with 8 pre-BP and
    ``max_iter`` post-BP iterations (osd.py:152-161). ``decoder_kwargs``
    go to the decoder's constructor (BPOSD's buckets, schedule and message
    dtype; OSDWindow's buckets).
    """
    dev = resolve_device(device)
    if shorten:
        from ..decoders.osd_window import OSDWindow

        return CachingDecoderFactory(
            lambda spec: OSDWindow(
                spec.mat,
                spec.prior,
                pre_max_iter=8,
                post_max_iter=max_iter,
                ms_scaling_factor=ms_scaling_factor,
                osd_method=osd_method,
                osd_order=osd_order,
                device=dev,
                **decoder_kwargs,
            )
        )
    from ..decoders.bposd import BPOSD

    return CachingDecoderFactory(
        lambda spec: BPOSD(
            spec.mat,
            spec.prior,
            max_iter=max_iter,
            ms_scaling_factor=ms_scaling_factor,
            osd_method=osd_method,
            osd_order=osd_order,
            device=dev,
            **decoder_kwargs,
        )
    )


def sliding_window_decoder(
    N: int = 144,
    p: float = 0.003,
    num_repeat: int = 12,
    num_shots: int = 10000,
    max_iter: int = 200,
    W: int = 3,
    F: int = 1,
    *,
    z_basis: bool = True,
    method: int = 1,
    shorten: bool = False,
    osd_method: str = "osd_cs",
    osd_order: int = 10,
    ms_scaling_factor: float = 1.0,
    decoder_factory=None,
    seed: int | None = None,
    verbose: bool = True,
    device=None,
):
    """End-to-end LER measurement; mirrors osd.py:15 defaults and outputs.

    ``shorten=False`` decodes each window with ``BPOSD``, ``shorten=True``
    with the shortened ``OSDWindow`` (osd.py:152-161). ``device`` is the
    torch device (None means "cuda"; raises without a card). One warm-up
    decode runs before the timed one. Returns a result dict with LER,
    LER-per-round, counts, and timing.
    """
    dev = resolve_device(device)
    code, circuit, dem, plan = build_bb_window_experiment(
        N, p, num_repeat, W, F, method=method, z_basis=z_basis
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    det_raw, obs_raw, _ = sample_dem_numpy(dem, num_shots, rng)
    sample_seconds = time.perf_counter() - t0
    if verbose:
        print(f"sampled {num_shots} shots in {sample_seconds:.2f}s")

    if decoder_factory is None:
        decoder_factory = window_decoder_factory(
            shorten,
            max_iter=max_iter,
            osd_method=osd_method,
            osd_order=osd_order,
            ms_scaling_factor=ms_scaling_factor,
            device=dev,
        )

    # warm-up: build every window's decoder and, on the card, load the
    # kernels outside the timed region
    decode_sliding_window(plan, det_raw, decoder_factory, device=dev, verbose=False)
    t0 = time.perf_counter()
    out = decode_sliding_window(plan, det_raw, decoder_factory, device=dev,
                                verbose=verbose)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    decode_seconds = time.perf_counter() - t0

    ev = evaluate_logical_errors(plan, det_raw, obs_raw, out["total_e_hat"], device=dev)
    p_l = ev["num_failed"] / num_shots
    p_l_per_round = 1 - (1 - p_l) ** (1 / num_repeat)
    result = {
        "N": N,
        "p": p,
        "num_repeat": num_repeat,
        "num_shots": num_shots,
        "W": W,
        "F": F,
        "num_windows": plan.num_windows,
        "num_flagged": ev["num_flagged"],
        "num_failed": ev["num_failed"],
        "ler": p_l,
        "ler_per_round": p_l_per_round,
        "window_flagged": out["window_flagged"],
        "sample_seconds": sample_seconds,
        "decode_seconds": decode_seconds,
        "shots_per_sec": num_shots / decode_seconds,
    }
    if verbose:
        print(f"Overall Flagged Errors: {ev['num_flagged']}/{num_shots}")
        print(f"Logical Errors: {ev['num_failed']}/{num_shots}")
        print(f"logical error per round: {p_l_per_round:.3e}")
        print(
            f"decode: {decode_seconds:.2f}s ({result['shots_per_sec']:.1f} shots/s)"
        )
    return result
