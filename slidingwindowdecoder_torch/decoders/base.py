"""Decoder result containers and shared helpers."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DecodeResult:
    """Batched decode output (numpy, host side).

    Mirrors the observable state of the reference decoder classes
    (converge / min_pm / bp_iteration / osd0_decoding properties,
    osd_window.pyx:487-517) but batched-first.
    """

    error: np.ndarray  # [B, n] uint8 — final decoding
    converged: np.ndarray  # [B] bool — BP (or ensemble) converged
    iterations: np.ndarray  # [B] int32 — BP iterations executed
    min_pm: np.ndarray | None = None  # [B] float32 path metric
    osd0: np.ndarray | None = None  # [B, n] OSD-0 solutions where OSD ran
    osd_applied: np.ndarray | None = None  # [B] bool

    def __len__(self) -> int:
        return self.error.shape[0]


def as_batch(syndrome: np.ndarray, m: int) -> tuple[np.ndarray, bool]:
    """Accept a single [m] syndrome or a [B, m] batch; return batch + flag."""
    syndrome = np.asarray(syndrome)
    if syndrome.ndim == 1:
        if syndrome.shape[0] != m:
            raise ValueError(
                f"syndrome length {syndrome.shape[0]} does not match m={m}"
            )
        return syndrome[None, :], True
    if syndrome.ndim != 2 or syndrome.shape[1] != m:
        raise ValueError(f"expected [B, {m}] syndromes, got {syndrome.shape}")
    return syndrome, False


def decode_padded(decoder, syndromes, pad_to: int) -> DecodeResult:
    """Host batch API of a decoder with ``core``, ``m`` and ``device``:
    pad the batch to a multiple of ``pad_to`` (awkward sizes would force
    tiny divisor buckets; zero-syndrome pad rows converge at once and
    never enter a bucket), decode, trim back to the input's rows."""
    import torch

    syndromes, _ = as_batch(syndromes, decoder.m)
    B = syndromes.shape[0]
    B_pad = -(-B // pad_to) * pad_to if B > pad_to else B
    if B_pad != B:
        syndromes = np.concatenate(
            [syndromes, np.zeros((B_pad - B, decoder.m), syndromes.dtype)]
        )
    out = decoder.core(torch.as_tensor(syndromes, dtype=torch.uint8, device=decoder.device))
    return DecodeResult(
        error=out["error"][:B].cpu().numpy(),
        converged=out["converged"][:B].cpu().numpy(),
        iterations=out["iterations"][:B].cpu().numpy(),
        min_pm=out["min_pm"][:B].cpu().numpy(),
        osd_applied=out["osd_applied"][:B].cpu().numpy(),
    )


def pad_pow2(x: int, floor: int = 32) -> int:
    """Round a batch size up to a power-of-two bucket (jit cache friendly)."""
    b = floor
    while b < x:
        b *= 2
    return b
