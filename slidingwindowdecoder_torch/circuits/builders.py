"""Syndrome-extraction circuit builders.

``build_bb_memory_circuit`` emits the IBM bivariate-bicycle memory
experiment with the 8-stage CNOT schedule and the standard 4-knob
circuit-level noise model, mirroring the reference's stim builder
(build_circuit.py:6-234) instruction for instruction but on our vectorized
IR: qubit layout [X-anc | L-data | R-data | Z-anc], per-round CNOT layers
ordered by the monomial column permutations of A1..A3 / B1..B3 and their
transposes, Z-basis (or X-basis) detectors per round, and a final
transversal data measurement with stabilizer detectors and logical
observables.

Also provides phenomenological and code-capacity "circuits" used by the
simpler harnesses.
"""

from __future__ import annotations

import numpy as np

from ..codes.css import CSSCode
from .circuit import Circuit

__all__ = ["build_bb_memory_circuit", "build_phenomenological_circuit"]


def _perm_of(monomial: np.ndarray) -> np.ndarray:
    """Row -> column map of a permutation (monomial) matrix."""
    rows, cols = np.nonzero(np.asarray(monomial))
    return cols[np.argsort(rows)].astype(np.int32)


def build_bb_memory_circuit(
    code: CSSCode,
    A_list,
    B_list,
    p: float,
    num_repeat: int,
    z_basis: bool = True,
    use_both: bool = False,
    HZH: bool = False,
) -> Circuit:
    """Noisy BB memory experiment over ``num_repeat`` rounds.

    Noise knobs all equal ``p``: depolarize2 after every CNOT, reset-flip
    after resets, measurement-flip before measurements, depolarize1 on idling
    data (reference build_circuit.py:31-34).
    """
    n = code.N
    half = n // 2
    a1, a2, a3 = A_list
    b1, b2, b3 = B_list
    A1, A2, A3 = _perm_of(a1), _perm_of(a2), _perm_of(a3)
    B1, B2, B3 = _perm_of(b1), _perm_of(b2), _perm_of(b3)
    A1_T, A2_T, A3_T = _perm_of(a1.T), _perm_of(a2.T), _perm_of(a3.T)
    B1_T, B2_T, B3_T = _perm_of(b1.T), _perm_of(b2.T), _perm_of(b3.T)

    x_anc = np.arange(half, dtype=np.int32)  # |+> ancillas (CNOT controls)
    l_data = half + np.arange(half, dtype=np.int32)
    r_data = n + np.arange(half, dtype=np.int32)
    z_anc = 3 * half + np.arange(half, dtype=np.int32)  # |0> ancillas (targets)
    data = half + np.arange(n, dtype=np.int32)

    c = Circuit(2 * n)

    def noisy_cnot(ctrl, tgt):
        c.cnot(ctrl, tgt)
        c.depolarize2(ctrl, tgt, p)

    def round_block(repeat: bool):
        # stage 1: ancilla (re)preparation noise + first Z-check CNOT layer
        if repeat:
            c.x_error(z_anc, p)  # reset flip on |0> ancillas after MR
            if HZH:
                c.x_error(x_anc, p)
                c.h(x_anc)
                c.depolarize1(x_anc, p)
            else:
                c.z_error(x_anc, p)  # reset flip on |+> ancillas after MRX
            c.depolarize1(r_data, p)  # idling R data
        else:
            c.h(x_anc)
            if HZH:
                c.depolarize1(x_anc, p)
        noisy_cnot(r_data[A1_T], z_anc)
        c.depolarize1(l_data, p)  # idling L data

        # stage 2
        noisy_cnot(x_anc, l_data[A2])
        noisy_cnot(r_data[A3_T], z_anc)
        # stage 3
        noisy_cnot(x_anc, r_data[B2])
        noisy_cnot(l_data[B1_T], z_anc)
        # stage 4
        noisy_cnot(x_anc, r_data[B1])
        noisy_cnot(l_data[B2_T], z_anc)
        # stage 5
        noisy_cnot(x_anc, r_data[B3])
        noisy_cnot(l_data[B3_T], z_anc)
        # stage 6
        noisy_cnot(x_anc, l_data[A1])
        noisy_cnot(r_data[A2_T], z_anc)
        # stage 7: last X-check CNOT layer + Z-check measurement
        noisy_cnot(x_anc, l_data[A3])
        c.x_error(z_anc, p)  # measurement flip
        c.measure(z_anc, basis="Z", reset=True)

        if z_basis:
            if repeat:
                for i in range(half):
                    c.detector([-half + i, -n - half + i])
            else:
                for i in range(half):
                    c.detector([-half + i])
        elif use_both and repeat:
            for i in range(half):
                c.detector([-half + i, -n - half + i])

        # stage 8: X-check measurement
        if HZH:
            c.h(x_anc)
            c.depolarize1(x_anc, p)
            c.x_error(x_anc, p)
            c.measure(x_anc, basis="Z", reset=True)
        else:
            c.z_error(x_anc, p)
            c.measure(x_anc, basis="X", reset=True)

        if not z_basis:
            if repeat:
                for i in range(half):
                    c.detector([-half + i, -n - half + i])
            else:
                for i in range(half):
                    c.detector([-half + i])
        elif use_both and repeat:
            for i in range(half):
                c.detector([-half + i, -n - half + i])

    # initialization: ancillas in |0>, data in the memory basis
    c.reset(x_anc, "Z")
    c.reset(z_anc, "Z")
    c.x_error(x_anc, p)
    c.x_error(z_anc, p)
    c.reset(data, "Z" if z_basis else "X")
    if z_basis:
        c.x_error(data, p)
    else:
        c.z_error(data, p)

    round_block(repeat=False)  # encoding round
    for _ in range(num_repeat - 1):
        round_block(repeat=True)

    # transversal data measurement
    c.measure(data, basis="Z" if z_basis else "X", reset=False)

    pcm = code.hz if z_basis else code.hx
    logical_pcm = code.lz if z_basis else code.lx
    M = c.num_measurements
    for i, row in enumerate(pcm):
        recs = [M - n + int(ind) for ind in np.nonzero(row)[0]]
        recs.append(M - 2 * n + i if z_basis else M - n - half + i)
        c.detector_abs(recs)
    for i, row in enumerate(logical_pcm):
        c.observable_include_abs(i, [M - n + int(ind) for ind in np.nonzero(row)[0]])

    return c


def build_phenomenological_circuit(
    pcm: np.ndarray,
    logicals: np.ndarray,
    p: float,
    p_syndrome: float,
    num_repeat: int,
) -> Circuit:
    """Phenomenological noise: iid data flips + noisy direct stabilizer reads.

    Capability parity with the reference's Syndrome code experiments
    (Syndrome code.ipynb): each round applies X errors to data then measures
    every Z stabilizer through a fresh ancilla whose readout flips with
    probability ``p_syndrome``; a final noiseless read closes the experiment.
    """
    pcm = np.asarray(pcm, dtype=np.uint8)
    logicals = np.asarray(logicals, dtype=np.uint8)
    m, n = pcm.shape
    data = np.arange(n, dtype=np.int32)
    anc = n + np.arange(m, dtype=np.int32)
    c = Circuit(n + m)
    c.reset(data, "Z")

    def stabilizer_read(noisy: bool):
        c.reset(anc, "Z")
        for i in range(m):
            # one CNOT per support qubit: a layer may not repeat a target
            for q in np.nonzero(pcm[i])[0]:
                c.cnot(np.int32(q), anc[i])
        if noisy:
            c.x_error(anc, p_syndrome)
        c.measure(anc, basis="Z", reset=False)

    for r in range(num_repeat):
        c.x_error(data, p)
        stabilizer_read(noisy=True)
        if r == 0:
            for i in range(m):
                c.detector([-m + i])
        else:
            for i in range(m):
                c.detector([-m + i, -2 * m + i])
    # final perfect read
    stabilizer_read(noisy=False)
    for i in range(m):
        c.detector([-m + i, -2 * m + i])
    M = c.num_measurements
    # logical observables via a final transversal data measurement
    c.measure(data, basis="Z", reset=False)
    for i, row in enumerate(logicals):
        c.observable_include_abs(
            i, [c.num_measurements - n + int(j) for j in np.nonzero(row)[0]]
        )
    return c
