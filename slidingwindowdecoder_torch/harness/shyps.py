"""SHYPS memory-experiment harness (global and sliding-window decoding).

The counterpart of the JAX package's ``harness/shyps.py`` (SHYPS.ipynb
cell 1): build the r-parameter SHYPS subsystem code and its
gauge-measurement circuit, compile the DEM, and decode either globally or
with a (W, F) sliding window (full windows, method 0: SHYPS windows carry
no virtual columns in the reference). The samples are
``sample_dem_numpy``'s, so both packages decode the same detector data.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..circuits.dem import compile_dem
from ..circuits.sampler import sample_dem_numpy
from ..circuits.shyps import build_shyps_circuit
from ..decoders.bposd import BPOSD
from ..utils.device import resolve_device
from ..windows.pipeline import (
    CachingDecoderFactory,
    _gf2_matmul,
    decode_sliding_window,
    evaluate_logical_errors,
)
from ..windows.regions import build_sliding_window_plan

# shots of the warm-up decode that runs before the timer (kernel builds and
# first launches); a shot decodes alike in any batch
WARMUP_SHOTS = 512


def decode_shyps(
    r: int = 3,
    p: float = 0.001,
    num_repeat: int = 4,
    num_shots: int = 20000,
    max_iter: int = 1000,
    osd_order: int = 0,
    *,
    window: bool = False,
    W: int = 3,
    F: int = 1,
    osd_method: str = "osd_cs",
    seed: int | None = None,
    verbose: bool = True,
    device=None,
):
    """SHYPS memory experiment: BP+OSD on the whole DEM (``window=False``)
    or window by window. The JAX package's function, plus ``device`` (None
    means "cuda"; raises without a card) and a warm-up on the first
    ``WARMUP_SHOTS`` shots where the JAX function warms up on all of them
    (its programs compile per batch shape). A shot fails if its residual
    syndrome is nonzero or an observable flips (osd.py:184-189); the global
    form counts ``resid | logical``, as JAX does. ``result["e_hat"]`` holds
    the corrections [S, C] (numpy)."""
    dev = resolve_device(device)
    circuit, code = build_shyps_circuit(r, p, num_repeat)
    dem = compile_dem(circuit)
    num_det_round = r * (2**r - 1)
    rng = np.random.default_rng(seed)
    det, obs, _ = sample_dem_numpy(dem, num_shots, rng)
    if verbose:
        print(f"SHYPS r={r}: chk {dem.chk.shape}, detectors/round {num_det_round}")
    det_dev = torch.as_tensor(det, device=dev)
    warm = det_dev[:WARMUP_SHOTS]

    if not window:
        bpd = BPOSD(dem.chk, dem.priors, max_iter=max_iter, ms_scaling_factor=1.0,
                    osd_method=osd_method, osd_order=osd_order, device=dev)
        bpd.core(warm)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        e_hat = bpd.core(det_dev)["error"]
        chk_t = torch.as_tensor(dem.chk.T, dtype=torch.float32, device=dev)
        obs_t = torch.as_tensor(dem.obs.T, dtype=torch.float32, device=dev)
        resid = (_gf2_matmul(e_hat, chk_t) ^ det_dev).any(dim=1)
        logical = (_gf2_matmul(e_hat, obs_t) ^ torch.as_tensor(obs, device=dev)).any(dim=1)
        num_failed, num_flagged = (int(x) for x in
                                   torch.stack([(resid | logical).sum(), resid.sum()]).tolist())
        seconds = time.perf_counter() - t0
    else:
        plan = build_sliding_window_plan(
            dem.chk, dem.obs, dem.priors, n_half=num_det_round, W=W, F=F, method=0
        )
        factory = CachingDecoderFactory(
            lambda spec: BPOSD(spec.mat, spec.prior, max_iter=max_iter, ms_scaling_factor=1.0,
                               osd_method=osd_method, osd_order=osd_order, device=dev)
        )
        decode_sliding_window(plan, warm, factory, device=dev, verbose=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = decode_sliding_window(plan, det_dev, factory, device=dev, verbose=verbose)
        e_hat = out["total_e_hat"]
        ev = evaluate_logical_errors(plan, det_dev, obs, e_hat, device=dev)
        seconds = time.perf_counter() - t0
        num_failed = ev["num_failed"]
        num_flagged = ev["num_flagged"]

    p_l = num_failed / num_shots
    result = {
        "r": r,
        "p": p,
        "num_shots": num_shots,
        "window": window,
        "num_flagged": num_flagged,
        "num_failed": num_failed,
        "ler": p_l,
        "ler_per_round": 1 - (1 - p_l) ** (1 / num_repeat),
        "seconds": seconds,
        "shots_per_sec": num_shots / seconds,
        "e_hat": e_hat.cpu().numpy(),
    }
    if verbose:
        print(
            f"SHYPS {'window' if window else 'global'}: {num_failed}/{num_shots} "
            f"failed, LER/r {result['ler_per_round']:.3e} ({seconds:.1f}s)"
        )
    return result
