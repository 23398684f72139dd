"""Circuit-level Monte-Carlo experiments: sliding-window and whole-block.

The counterpart of the JAX package's ``harness/circuit_level.py`` (the
reference's ``sliding_window_decoder``, osd.py:15-194): build the BB code
+ syndrome circuit, compile the DEM, extract the (W, F) window plan,
sample detector data, run the window pipeline with a batched decoder per
window (``decoders.BPOSD``, or ``decoders.OSDWindow`` when shortened; or
``decoders.GDG`` in ``sliding_window_gdg``, the reference's guessing.py),
and report flagged / logical error rates per round. ``global_decoder``
decodes the whole DEM at once instead (IBM.ipynb cells 3-5).
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
    _gf2_matmul,
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


def build_global_decoder(
    dem,
    shorten: bool = False,
    *,
    max_iter: int = 200,
    osd_method: str = "osd_cs",
    osd_order: int = 10,
    ms_scaling_factor: float = 1.0,
    device=None,
):
    """The decoder of ``global_decoder`` for the whole DEM ``dem``: BPOSD
    with the flagship window path's execution knobs (bf16 messages, a
    16-iteration phase A, 1024-shot phase-B buckets, 256-shot OSD
    buckets), or with ``shorten`` the shortened ``OSDWindow`` (pre-BP 8,
    post-BP ``max_iter``) at its defaults, as the JAX package builds them
    (``harness/circuit_level.py:199-213``)."""
    from ..decoders.bposd import BPOSD
    from ..decoders.osd_window import OSDWindow

    if shorten:
        return OSDWindow(
            dem.chk, dem.priors, pre_max_iter=8, post_max_iter=max_iter,
            ms_scaling_factor=ms_scaling_factor, osd_method=osd_method,
            osd_order=osd_order, device=device,
        )
    return BPOSD(
        dem.chk, dem.priors, max_iter=max_iter, ms_scaling_factor=ms_scaling_factor,
        osd_method=osd_method, osd_order=osd_order, msg_dtype="bfloat16",
        phase_a_iters=16, bp_bucket=1024, osd_bucket=256, device=device,
    )


def global_decoder(
    N: int = 144,
    p: float = 0.004,
    num_repeat: int = 12,
    num_shots: int = 10000,
    max_iter: int = 200,
    *,
    z_basis: bool = True,
    osd_method: str = "osd_cs",
    osd_order: int = 10,
    ms_scaling_factor: float = 1.0,
    shorten: bool = False,
    seed: int | None = None,
    verbose: bool = True,
    batch_size: int = 8192,
    device=None,
):
    """Whole-block (non-windowed) decoding of the full DEM check matrix.

    The IBM.ipynb Fig.3 reproduction path (cells 3-5): BP+OSD-CS-10 on the
    full 936x8784 matrix for [[144]]x12; ``shorten=True`` uses the
    osd_window decoder instead (cell 5). The JAX package's function, plus
    ``device`` (None means "cuda"; raises without a card). The samples are
    ``sample_dem_numpy``'s, so both packages decode the same detector
    data. Shots are decoded in ``batch_size`` chunks; each distinct chunk
    size is decoded once outside the timed region first (the kernels are
    built and loaded there). The syndrome and logical tests run on the
    device, and the counts are read once at the end.
    """
    dev = resolve_device(device)
    code, A_list, B_list = bb_code_by_n(N)
    circuit = build_bb_memory_circuit(
        code, A_list, B_list, p, num_repeat, z_basis=z_basis
    )
    dem = compile_dem(circuit)
    rng = np.random.default_rng(seed)
    det, obs, _ = sample_dem_numpy(dem, num_shots, rng)
    dec = build_global_decoder(
        dem, shorten, max_iter=max_iter, osd_method=osd_method, osd_order=osd_order,
        ms_scaling_factor=ms_scaling_factor, device=dev,
    )
    chk_t = torch.as_tensor(dem.chk.T, dtype=torch.float32, device=dev)
    obs_t = torch.as_tensor(dem.obs.T, dtype=torch.float32, device=dev)
    det_dev = torch.as_tensor(det, device=dev)
    obs_dev = torch.as_tensor(obs, device=dev)
    chunks = [(lo, min(lo + batch_size, num_shots)) for lo in range(0, num_shots, batch_size)]
    for size in sorted({hi - lo for lo, hi in chunks}):  # warm-up, one chunk a size
        lo, hi = next(c for c in chunks if c[1] - c[0] == size)
        dec.core(det_dev[lo:hi])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    flagged = torch.zeros((), dtype=torch.int64, device=dev)
    for lo, hi in chunks:
        det_c = det_dev[lo:hi]
        e_hat = dec.core(det_c)["error"]
        resid = (_gf2_matmul(e_hat, chk_t) ^ det_c).any(dim=1)
        logical = (_gf2_matmul(e_hat, obs_t) ^ obs_dev[lo:hi]).any(dim=1)
        failed += (resid | logical).sum()
        flagged += resid.sum()
    num_failed, num_flagged = (int(x) for x in torch.stack([failed, flagged]).tolist())
    seconds = time.perf_counter() - t0
    p_l = num_failed / num_shots
    result = {
        "N": N,
        "p": p,
        "num_shots": num_shots,
        "num_flagged": num_flagged,
        "num_failed": num_failed,
        "ler": p_l,
        "ler_per_round": 1 - (1 - p_l) ** (1 / num_repeat),
        "decode_seconds": seconds,
        "shots_per_sec": num_shots / seconds,
    }
    if verbose:
        print(
            f"global: {num_failed}/{num_shots} failed, "
            f"LER/r {result['ler_per_round']:.3e} "
            f"({result['shots_per_sec']:.1f} shots/s)"
        )
    return result


def gdg_window_factory(
    *,
    max_iter: int = 200,
    max_step: int = 25,
    max_iter_per_step: int = 6,
    max_tree_depth: int = 3,
    max_side_depth: int = 10,
    max_tree_branch_step: int = 10,
    max_side_branch_step: int = 10,
    low_error_mode: bool = False,
    last_win_gdg_factor: float = 1.0,
    last_win_bp_factor: float = 1.0,
    ensemble_bucket: int = 64,
    ensemble_mode: str = "fused",
    ensemble_spans=None,
    msg_dtype: str = "float32",
    hist_dtype: str = "float32",
    device=None,
):
    """The per-window decoder factory of ``sliding_window_gdg``: ``GDG``
    with these knobs, the last window with its own min-sum factors
    (guessing.py:19-237)."""
    from ..decoders.gdg import GDG

    dev = resolve_device(device)

    def build(spec):
        last = spec.is_last
        return GDG(
            spec.mat,
            spec.prior,
            max_iter=max_iter,
            max_iter_per_step=max_iter_per_step,
            max_step=max_step,
            max_tree_depth=max_tree_depth,
            max_side_depth=max_side_depth,
            max_tree_branch_step=max_tree_branch_step,
            max_side_branch_step=max_side_branch_step,
            ms_scaling_factor=last_win_bp_factor if last else 1.0,
            gdg_factor=last_win_gdg_factor if last else 1.0,
            low_error_mode=low_error_mode,
            ensemble_bucket=ensemble_bucket,
            ensemble_mode=ensemble_mode,
            ensemble_spans=ensemble_spans,
            msg_dtype=msg_dtype,
            hist_dtype=hist_dtype,
            device=dev,
        )

    return CachingDecoderFactory(build)


def sliding_window_gdg(
    N: int = 144,
    p: float = 0.005,
    num_repeat: int = 12,
    num_shots: int = 5000,
    max_iter: int = 200,
    W: int = 3,
    F: int = 1,
    *,
    z_basis: bool = True,
    method: int = 1,
    max_step: int = 25,
    max_iter_per_step: int = 6,
    max_tree_depth: int = 3,
    max_side_depth: int = 10,
    max_tree_branch_step: int = 10,
    max_side_branch_step: int = 10,
    low_error_mode: bool = False,
    last_win_osd: bool = False,
    last_win_gdg_factor: float = 1.0,
    last_win_bp_factor: float = 1.0,
    ensemble_bucket: int = 64,
    ensemble_mode: str = "fused",
    ensemble_spans=None,
    msg_dtype: str = "float32",
    hist_dtype: str = "float32",
    seed: int | None = None,
    verbose: bool = True,
    device=None,
):
    """Sliding-window decoding with GDG per window (guessing.py:19-237);
    the JAX package's driver, less ``cn_engine``, plus ``device`` (None
    means "cuda"; raises without a card).

    With ``last_win_osd``, the final window is re-decoded with BP+OSD-CS-10
    (``BPOSD``) after the GDG pass (guessing.py:149-158, 229-236) and both
    results are reported; the OSD re-decode is the committed one
    (``total_e_hat_osd``). One warm-up decode runs before the timed one.
    """
    from ..decoders.bposd import BPOSD

    dev = resolve_device(device)
    _, _, dem, plan = build_bb_window_experiment(
        N, p, num_repeat, W, F, method=method, z_basis=z_basis
    )
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    det_raw, obs_raw, _ = sample_dem_numpy(dem, num_shots, rng)
    if verbose:
        print(f"sampled {num_shots} shots in {time.perf_counter() - t0:.2f}s")

    factory = gdg_window_factory(
        max_iter=max_iter, max_step=max_step, max_iter_per_step=max_iter_per_step,
        max_tree_depth=max_tree_depth, max_side_depth=max_side_depth,
        max_tree_branch_step=max_tree_branch_step,
        max_side_branch_step=max_side_branch_step, low_error_mode=low_error_mode,
        last_win_gdg_factor=last_win_gdg_factor, last_win_bp_factor=last_win_bp_factor,
        ensemble_bucket=ensemble_bucket, ensemble_mode=ensemble_mode,
        ensemble_spans=ensemble_spans, msg_dtype=msg_dtype, hist_dtype=hist_dtype,
        device=dev,
    )
    # warm-up: build every window's decoder and load the kernels outside
    # the timed region
    decode_sliding_window(plan, det_raw, factory, device=dev, verbose=False)
    t0 = time.perf_counter()
    out = decode_sliding_window(plan, det_raw, factory, device=dev, verbose=verbose)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    decode_seconds = time.perf_counter() - t0
    ev = evaluate_logical_errors(plan, det_raw, obs_raw, out["total_e_hat"], device=dev)
    p_l = ev["num_failed"] / num_shots
    result = {
        "N": N,
        "p": p,
        "num_shots": num_shots,
        "W": W,
        "F": F,
        "num_windows": plan.num_windows,
        "num_flagged": ev["num_flagged"],
        "num_failed": ev["num_failed"],
        "ler": p_l,
        "ler_per_round": 1 - (1 - p_l) ** (1 / num_repeat),
        "decode_seconds": decode_seconds,
        "shots_per_sec": num_shots / decode_seconds,
        "total_e_hat": out["total_e_hat"],
    }
    if verbose:
        print(f"GDG: Logical Errors: {ev['num_failed']}/{num_shots}; "
              f"LER/r {result['ler_per_round']:.3e}")

    if last_win_osd:
        spec = plan.windows[-1]
        bpd = BPOSD(spec.mat, spec.prior, max_iter=200, ms_scaling_factor=1.0,
                    osd_method="osd_cs", osd_order=10, device=dev)
        total = out["total_e_hat"]
        det_dev = torch.as_tensor(det_raw, device=dev).to(torch.uint8)
        # the last window's input from the committed earlier windows
        partial = total.clone()
        partial[:, spec.col_start:] = 0
        chk_t = torch.as_tensor(plan.chk.T, dtype=torch.float32, device=dev)
        synd = (det_dev ^ _gf2_matmul(partial, chk_t))[:, spec.row_start:spec.row_end]
        redo = bpd.core(synd)
        total2 = total.clone()
        total2[:, spec.col_start:spec.col_end] = redo["error"]
        ev2 = evaluate_logical_errors(plan, det_raw, obs_raw, total2, device=dev)
        p_l2 = ev2["num_failed"] / num_shots
        result["last_win_osd"] = {
            "num_failed": ev2["num_failed"],
            "ler": p_l2,
            "ler_per_round": 1 - (1 - p_l2) ** (1 / num_repeat),
        }
        result["total_e_hat_osd"] = total2
        if verbose:
            print(f"GDG+last-window-OSD: Logical Errors: {ev2['num_failed']}/{num_shots}; "
                  f"LER/r {result['last_win_osd']['ler_per_round']:.3e}")
    return result
