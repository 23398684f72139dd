"""Batched sliding-window decode pipeline (device resident), in PyTorch.

Executes the (W, F) window loop of the reference driver (osd.py:130-194)
over a whole batch of shots at once: decode window i from the current
corrected detector data, commit the first F rounds' faults, subtract the
committed syndrome contribution from all detectors, slide forward.

All shot-sized state (detector data, accumulated corrections) lives on the
device for the entire loop; the feedback is one GF(2) matmul per window.
"""

from __future__ import annotations

import time

import torch

from ..utils.device import resolve_device


def _gf2_matmul(a, b_f32):
    """(a @ b) % 2 on the device; ``b_f32`` pre-converted [K, R] float32.

    The product runs in float32 and is exact: every partial sum is a count
    of 0/1 products below 2**24. That needs full float32 products, so TF32
    (10 mantissa bits) is switched off for CUDA matmuls here, explicitly,
    whatever the process had set.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    out = a.to(torch.float32) @ b_f32
    return torch.remainder(out, 2.0).to(torch.uint8)


def decode_sliding_window(
    plan,
    det_data,
    decoder_factory,
    *,
    device=None,
    verbose: bool = True,
    collect_window_stats: bool = True,
    sync_per_window: bool = False,
):
    """Run the full window pipeline over a batch of detector samples.

    Args:
      plan: static window plan (windows, regrouped chk/obs/priors).
      det_data: [S, num_detectors] detector bits (numpy or tensor).
      decoder_factory: ``spec -> decoder`` exposing ``core(synds)`` on the
        same device (``decoders.BPOSD``, ``decoders.OSDWindow``).
      device: torch device; None means "cuda" (raises without a card).
      sync_per_window: block on each window's result so ``window_seconds``
        measures real per-window wall time, and collect per-window
        non-converged counts.

    Returns dict with total_e_hat [S, C] (device), per-window flagged
    counts, per-window non-converged counts (sync mode), the per-window
    ``counts`` of decoders that report them (``OSDWindow``), and timing.
    """
    dev = resolve_device(device)
    det = torch.as_tensor(det_data, device=dev).to(torch.uint8)
    S = det.shape[0]
    num_col = plan.chk.shape[1]
    chk_t_f32 = torch.as_tensor(plan.chk.T, dtype=torch.float32, device=dev)  # [C, R]
    total_e_hat = torch.zeros((S, num_col), dtype=torch.uint8, device=dev)
    new_det = det
    window_flagged: list[int] = []
    window_seconds: list[float] = []
    window_nonconverged: list[int] = []
    window_counts: list[dict] = []

    for spec in plan.windows:
        t0 = time.perf_counter()
        decoder = decoder_factory(spec)
        synd = new_det[:, spec.row_start : spec.row_end]
        out = decoder.core(synd)
        e_hat = out["error"]
        if "counts" in out:
            window_counts.append(out["counts"])
        if sync_per_window:
            window_nonconverged.append(int((~out["converged"]).sum()))

        if collect_window_stats:
            mat_t = torch.as_tensor(spec.mat.T, dtype=torch.float32, device=dev)
            resid = (_gf2_matmul(e_hat, mat_t) ^ synd).any(dim=1)
            window_flagged.append(int(resid.sum()))

        if spec.is_last:
            ncommit = spec.col_end - spec.col_start
        else:
            ncommit = spec.commit_col_end - spec.col_start
        committed = e_hat[:, :ncommit]
        total_e_hat[:, spec.col_start : spec.col_start + ncommit] = committed

        # feedback: XOR only the newly committed columns' syndrome
        # contribution into the corrected detectors (incremental form of
        # osd.py:178's full re-multiplication)
        new_det = new_det ^ _gf2_matmul(
            committed, chk_t_f32[spec.col_start : spec.col_start + ncommit]
        )
        if sync_per_window and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        window_seconds.append(dt)
        if verbose:
            flagged = window_flagged[-1] if collect_window_stats else -1
            print(f"Window {spec.index}: flagged {flagged}/{S} ({dt:.2f}s)")

    return {
        "total_e_hat": total_e_hat,
        "corrected_det": new_det,
        "window_flagged": window_flagged,
        "window_seconds": window_seconds,
        "window_nonconverged": window_nonconverged,
        "window_counts": window_counts,
    }


def decode_sliding_window_sharded(
    plan,
    det_data,
    decoder_factory,
    mesh=None,
    *,
    device=None,
    verbose: bool = False,
):
    """The full (W, F) pipeline, optionally sharded over a shot mesh
    (``parallel.mesh.ShotMesh``): ``decode_sliding_window`` on this rank's
    shots.

    Without ``mesh`` it decodes every shot on ``device`` (None means
    "cuda"; raises without a card). With ``mesh`` this rank decodes its
    contiguous block of rows of ``det_data`` (the whole batch [S, D]; S
    must divide over the ranks) on the mesh's device. Decode state is
    rank-local and there is no collective (the counts are reduced in
    ``evaluate_logical_errors_sharded``).

    Returns {"total_e_hat": this rank's corrections [S / size, C] (all S
    without a mesh), "corrected_det", "window_seconds"} (the JAX keys).
    """
    if mesh is not None:
        det_data = det_data[mesh.rows(det_data.shape[0])]
        device = mesh.device
    out = decode_sliding_window(plan, det_data, decoder_factory, device=device,
                                verbose=verbose, collect_window_stats=False)
    return {k: out[k] for k in ("total_e_hat", "corrected_det", "window_seconds")}


def evaluate_logical_errors_sharded(plan, det_data, obs_data, total_e_hat, mesh):
    """Final accounting over a shot mesh: ``evaluate_logical_errors`` on
    this rank's rows of ``det_data`` / ``obs_data`` (the whole batch), then
    one ``all_reduce`` of the two counts, the only communication of the
    whole pipeline. ``total_e_hat`` is this rank's rows (as
    ``decode_sliding_window_sharded`` returns them) or the whole batch's.
    Returns {"failed": this rank's rows (numpy), "num_flagged",
    "num_failed"} (the counts over the mesh)."""
    from ..parallel.distributed import global_sums

    rows = mesh.rows(det_data.shape[0])
    if total_e_hat.shape[0] != rows.stop - rows.start:
        total_e_hat = total_e_hat[rows]
    ev = evaluate_logical_errors(plan, det_data[rows], obs_data[rows], total_e_hat,
                                 device=mesh.device)
    n_flagged, n_failed = global_sums([ev["num_flagged"], ev["num_failed"]], mesh.group)
    return {"failed": ev["failed"], "num_flagged": int(n_flagged),
            "num_failed": int(n_failed)}


def evaluate_logical_errors(plan, det_data, obs_data, total_e_hat, *, device=None):
    """Final accounting, matching osd.py:184-189: a shot fails if its global
    residual syndrome is nonzero (flagged) OR any observable is flipped."""
    dev = resolve_device(device)

    def u8(x):
        return torch.as_tensor(x, device=dev).to(torch.uint8)

    det, obs, e_hat = u8(det_data), u8(obs_data), u8(total_e_hat)
    chk_t = torch.as_tensor(plan.chk.T, dtype=torch.float32, device=dev)
    obs_t = torch.as_tensor(plan.obs.T, dtype=torch.float32, device=dev)
    flagged = (_gf2_matmul(e_hat, chk_t) ^ det).any(dim=1)
    logical = (_gf2_matmul(e_hat, obs_t) ^ obs).any(dim=1)
    failed = flagged | logical
    return {
        "flagged": flagged.cpu().numpy(),
        "logical": logical.cpu().numpy(),
        "failed": failed.cpu().numpy(),
        "num_flagged": int(flagged.sum()),
        "num_failed": int(failed.sum()),
    }


class CachingDecoderFactory:
    """Build one decoder per distinct window signature, reuse across windows.

    Window matrices recur (all interior windows share structure), so keying
    on the matrix bytes + prior bytes avoids rebuilding them.
    """

    def __init__(self, build):
        self._build = build
        self._cache: dict = {}

    def __call__(self, spec):
        key = (
            spec.mat.shape,
            hash(spec.mat.tobytes()),
            hash(spec.prior.tobytes()),
        )
        if key not in self._cache:
            self._cache[key] = self._build(spec)
        return self._cache[key]
