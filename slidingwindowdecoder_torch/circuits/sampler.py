"""Noise samplers.

Two equivalent ways to draw (detector, observable) data:

1. :class:`PauliFrameSampler` — a vectorized numpy Pauli-frame simulator of
   the full circuit (the ground-truth oracle; plays the role of stim's
   circuit sampler in the reference, osd.py:124-125).
2. :func:`sample_dem_numpy` — host sampling of the compiled DEM:
   independent Bernoulli draws per fault column, detectors = chk @ f mod 2.
   Because the DEM decomposition is exact (see dem.py), both samplers draw
   from the same distribution; the DEM sampler is the production path.
"""

from __future__ import annotations

import numpy as np

from .circuit import (
    Circuit,
    MEASUREMENTS,
)
from .dem import DemMatrices


class PauliFrameSampler:
    """Vectorized Pauli-frame Monte-Carlo over ``shots`` parallel frames.

    Valid for circuits whose noiseless detector outcomes are deterministic
    (true for all memory experiments here): the detector value then equals
    the XOR of the frame-induced measurement flips.
    """

    def __init__(self, circuit: Circuit, seed: int | None = None):
        self.circuit = circuit
        self.rng = np.random.default_rng(seed)

    def sample(self, shots: int, fault_injector=None):
        """Returns ``(det_data, obs_data)`` with shapes [shots, D], [shots, O].

        ``fault_injector(inst_index, inst, x_frame, z_frame)`` may flip frame
        bits deterministically (used by tests to verify single-fault
        signatures); when provided, random noise is disabled.
        """
        c = self.circuit
        Q = c.num_qubits
        x = np.zeros((shots, Q), dtype=bool)  # X component of the frame
        z = np.zeros((shots, Q), dtype=bool)
        meas = np.zeros((shots, c.num_measurements), dtype=bool)
        rng = self.rng
        noisy = fault_injector is None

        for idx, inst in enumerate(c.instructions):
            name, t = inst.name, inst.targets
            if name == "H":
                x[:, t], z[:, t] = z[:, t].copy(), x[:, t].copy()
            elif name == "S":
                z[:, t] ^= x[:, t]
            elif name == "CNOT":
                ctrl, tgt = t[0], t[1]
                x[:, tgt] ^= x[:, ctrl]
                z[:, ctrl] ^= z[:, tgt]
            elif name == "CZ":
                ctrl, tgt = t[0], t[1]
                z[:, tgt] ^= x[:, ctrl]
                z[:, ctrl] ^= x[:, tgt]
            elif name in ("R", "RX"):
                x[:, t] = False
                z[:, t] = False
            elif name in MEASUREMENTS:
                recs = inst.rec_offset + np.arange(t.size)
                if name in ("M", "MR"):
                    meas[:, recs] = x[:, t]
                else:  # MX / MRX: Z errors flip X-basis measurements
                    meas[:, recs] = z[:, t]
                if name in ("MR", "MRX"):
                    x[:, t] = False
                    z[:, t] = False
            elif name == "X_ERROR":
                if noisy:
                    x[:, t] ^= rng.random((shots, t.size)) < inst.prob
            elif name == "Z_ERROR":
                if noisy:
                    z[:, t] ^= rng.random((shots, t.size)) < inst.prob
            elif name == "Y_ERROR":
                if noisy:
                    flip = rng.random((shots, t.size)) < inst.prob
                    x[:, t] ^= flip
                    z[:, t] ^= flip
            elif name == "DEPOLARIZE1":
                if noisy:
                    r = rng.random((shots, t.size))
                    p = inst.prob
                    which = (r < p) * (1 + (r * 3 / p).astype(np.int8) % 3)
                    x[:, t] ^= (which == 1) | (which == 2)  # X or Y
                    z[:, t] ^= (which == 2) | (which == 3)  # Y or Z
            elif name == "DEPOLARIZE2":
                if noisy:
                    a, b = t[0], t[1]
                    r = rng.random((shots, a.size))
                    p = inst.prob
                    which = (r < p) * (1 + (r * 15 / p).astype(np.int8) % 15)
                    pa, pb = which // 4, which % 4  # 2q Pauli index pair
                    # encoding: 0=I 1=X 2=Y 3=Z; (pa,pb) != (0,0) when which>0
                    x[:, a] ^= (pa == 1) | (pa == 2)
                    z[:, a] ^= (pa == 2) | (pa == 3)
                    x[:, b] ^= (pb == 1) | (pb == 2)
                    z[:, b] ^= (pb == 2) | (pb == 3)
            if fault_injector is not None:
                fault_injector(idx, inst, x, z)

        D, O = c.num_detectors, c.num_observables
        det = np.zeros((shots, D), dtype=np.uint8)
        for d, recs in enumerate(c.detectors):
            det[:, d] = np.bitwise_xor.reduce(meas[:, recs], axis=1)
        obs = np.zeros((shots, O), dtype=np.uint8)
        for o, recs in c.observables.items():
            obs[:, o] = np.bitwise_xor.reduce(meas[:, np.asarray(recs)], axis=1)
        return det, obs


def sample_dem_numpy(dem: DemMatrices, shots: int, rng: np.random.Generator):
    """Host-side DEM sampling (reference semantics of dem.compile_sampler()).

    The GF(2) products run as float32 BLAS matmuls: every partial sum is a
    count of at most ``num_faults`` < 2**24 ones, so it is exact, and the
    parity equals that of the integer product. The draw is the same
    ``rng.random(...) < priors`` as always, so the samples are bit-identical
    to an integer-product implementation on the same generator.
    """
    faults = (rng.random((shots, dem.num_faults)) < dem.priors).astype(np.uint8)
    f32 = faults.astype(np.float32)
    det = np.mod(f32 @ dem.chk.T.astype(np.float32), 2.0)
    obs = np.mod(f32 @ dem.obs.T.astype(np.float32), 2.0)
    return det.astype(np.uint8), obs.astype(np.uint8), faults


def make_dem_sampler(dem: DemMatrices, device=None):
    """An on-device sampler ``f(generator, shots) -> (det, obs, faults)``.

    Bernoulli draws per fault against ``dem.priors`` from the caller's
    ``torch.Generator`` (on ``device``; None means "cuda", raising without
    a card), then the two GF(2) products on the device (float32, exact:
    every count is below 2**24). The shot axis leads, so the result splits
    over a shot mesh by rows. All three outputs are uint8.
    """
    import torch

    from ..utils.device import resolve_device
    from ..windows.pipeline import _gf2_matmul

    dev = resolve_device(device)
    priors = torch.as_tensor(dem.priors, dtype=torch.float32, device=dev)
    chk_t = torch.as_tensor(dem.chk.T, dtype=torch.float32, device=dev)  # [F, D]
    obs_t = torch.as_tensor(dem.obs.T, dtype=torch.float32, device=dev)  # [F, O]

    def sample(generator: torch.Generator, shots: int):
        u = torch.rand((shots, priors.shape[0]), generator=generator, device=dev)
        faults = (u < priors).to(torch.uint8)
        del u
        return _gf2_matmul(faults, chk_t), _gf2_matmul(faults, obs_t), faults

    return sample
