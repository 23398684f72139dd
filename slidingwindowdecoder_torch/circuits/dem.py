"""Detector-error-model compiler.

Replaces the reference's stim dependency (``circuit.detector_error_model()``
followed by ``dem_to_check_matrices`` in build_circuit.py:251-299). Given a
:class:`~slidingwindowdecoder_torch.circuits.circuit.Circuit`, produce:

- ``chk``    : detectors × faults binary matrix,
- ``obs``    : observables × faults binary matrix,
- ``priors`` : per-fault independent flip probabilities,

where "faults" are the independent elementary error mechanisms of the
circuit, merged when they have identical (detector-set, observable-set)
signatures.

Method: a single *backward* sweep over the circuit maintaining, per qubit,
two bitsets DX[q], DZ[q] over (detectors ‖ observables): the symptoms that
an X (resp. Z) error occurring *at the current circuit position* on qubit q
would flip. Gates conjugate the sensitivity sets; resets clear them;
measurements inject the detector/observable memberships of their record.
Each noise instruction then reads off its mechanisms' signatures directly.
This is O(instructions × bitset words), fully numpy-vectorized.

Probability bookkeeping (exact, matching stim's independent-mechanism
semantics):

- ``DEPOLARIZE1(p)`` is *exactly* the composition of independent X, Y, Z
  flips each with probability q solving q(1-q) = p/3, i.e.
  q = (1 - sqrt(1 - 4p/3)) / 2.
- ``DEPOLARIZE2(p)`` is exactly 15 independent two-qubit Pauli flips each
  with probability q = (1 - (1 - 16p/15)^(1/8)) / 2 (character sum over
  (Z/2)^4: every nontrivial net Pauli has probability (1-(1-2q)^8)/16).
- Mechanisms with identical signatures merge with the XOR rule
  p = (1 - prod(1 - 2 p_i)) / 2, so sampling merged mechanisms
  independently reproduces the joint symptom distribution exactly.

(The reference's ``dem_to_check_matrices`` *sums* the already-merged stim
probabilities — build_circuit.py:268-269 — which agrees with the XOR rule to
O(p^2); we keep the exact rule.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .circuit import Circuit

_WORD = 64


@dataclass
class DemMatrices:
    """Compiled detector error model in matrix form."""

    chk: np.ndarray  # [num_detectors, num_faults] uint8
    obs: np.ndarray  # [num_observables, num_faults] uint8
    priors: np.ndarray  # [num_faults] float64
    num_detectors: int
    num_observables: int

    @property
    def num_faults(self) -> int:
        return self.chk.shape[1]

    def col_keys(self) -> list[str]:
        """Reference-style merge keys 'D.. L..' per fault column."""
        keys = []
        for j in range(self.num_faults):
            dets = np.nonzero(self.chk[:, j])[0]
            lobs = np.nonzero(self.obs[:, j])[0]
            keys.append(
                " ".join([f"D{d}" for d in dets] + [f"L{o}" for o in lobs])
            )
        return keys


def _independent_prob_depolarize1(p: float) -> float:
    return 0.5 * (1.0 - np.sqrt(max(0.0, 1.0 - 4.0 * p / 3.0)))


def _independent_prob_depolarize2(p: float) -> float:
    return 0.5 * (1.0 - (max(0.0, 1.0 - 16.0 * p / 15.0)) ** 0.125)


def _check_disjoint(name: str, targets: np.ndarray) -> None:
    flat = targets.reshape(-1)
    if len(np.unique(flat)) != flat.size:
        raise ValueError(
            f"{name} layer touches a qubit twice; split into separate instructions"
        )


def compile_dem(circuit: Circuit) -> DemMatrices:
    """Compile a circuit into merged detector-error-model matrices."""
    D = circuit.num_detectors
    O = circuit.num_observables
    width = D + O
    words = max(1, -(-width // _WORD))
    Q = circuit.num_qubits

    # membership mask per measurement record
    meas_masks = np.zeros((circuit.num_measurements, words), dtype=np.uint64)

    def set_bit(rows: np.ndarray, bit: int) -> None:
        meas_masks[rows, bit // _WORD] ^= np.uint64(1 << (bit % _WORD))

    for d, recs in enumerate(circuit.detectors):
        set_bit(np.asarray(recs), d)
    for o, recs in circuit.observables.items():
        set_bit(np.asarray(recs, dtype=np.int64), D + o)

    dx = np.zeros((Q, words), dtype=np.uint64)
    dz = np.zeros((Q, words), dtype=np.uint64)

    sig_chunks: list[np.ndarray] = []  # collected in backward order
    prob_chunks: list[np.ndarray] = []

    def emit(sigs: np.ndarray, prob: float) -> None:
        sig_chunks.append(sigs.copy())
        prob_chunks.append(np.full(sigs.shape[0], prob, dtype=np.float64))

    for inst in reversed(circuit.instructions):
        name, t = inst.name, inst.targets
        if name in ("M", "MX", "MR", "MRX"):
            recs = inst.rec_offset + np.arange(t.size)
            masks = meas_masks[recs]
            if name == "M":
                dx[t] ^= masks
            elif name == "MX":
                dz[t] ^= masks
            elif name == "MR":  # forward: measure then reset — backward: the
                dx[t] = masks  # pre-existing frame is erased by the reset
                dz[t] = 0
            else:  # MRX
                dz[t] = masks
                dx[t] = 0
        elif name in ("R", "RX"):
            dx[t] = 0
            dz[t] = 0
        elif name == "H":
            dx[t], dz[t] = dz[t].copy(), dx[t].copy()
        elif name == "S":
            dx[t] ^= dz[t]
        elif name == "CNOT":
            c, g = t[0], t[1]
            _check_disjoint(name, t)
            dx[c] ^= dx[g]
            dz[g] ^= dz[c]
        elif name == "CZ":
            c, g = t[0], t[1]
            _check_disjoint(name, t)
            dx[c] ^= dz[g]
            dx[g] ^= dz[c]
        elif name == "X_ERROR":
            emit(dx[t], inst.prob)
        elif name == "Z_ERROR":
            emit(dz[t], inst.prob)
        elif name == "Y_ERROR":
            emit(dx[t] ^ dz[t], inst.prob)
        elif name == "DEPOLARIZE1":
            q = _independent_prob_depolarize1(inst.prob)
            emit(dx[t], q)
            emit(dx[t] ^ dz[t], q)
            emit(dz[t], q)
        elif name == "DEPOLARIZE2":
            q = _independent_prob_depolarize2(inst.prob)
            a, b = t[0], t[1]
            pa = [np.zeros_like(dx[a]), dx[a], dx[a] ^ dz[a], dz[a]]  # I,X,Y,Z
            pb = [np.zeros_like(dx[b]), dx[b], dx[b] ^ dz[b], dz[b]]
            for ia in range(4):
                for ib in range(4):
                    if ia == 0 and ib == 0:
                        continue
                    emit(pa[ia] ^ pb[ib], q)
        else:  # pragma: no cover
            raise ValueError(f"DEM compiler: unhandled instruction {name}")

    if not sig_chunks:
        return DemMatrices(
            np.zeros((D, 0), np.uint8), np.zeros((O, 0), np.uint8),
            np.zeros(0), D, O,
        )

    sigs = np.concatenate(sig_chunks[::-1], axis=0)  # forward circuit order
    probs = np.concatenate(prob_chunks[::-1], axis=0)

    # drop symptomless and zero-probability mechanisms (stim emits neither)
    nonzero = sigs.any(axis=1) & (probs > 0.0)
    sigs, probs = sigs[nonzero], probs[nonzero]

    # merge identical signatures, preserving first-occurrence order
    view = np.ascontiguousarray(sigs).view(
        np.dtype((np.void, sigs.dtype.itemsize * sigs.shape[1]))
    ).reshape(-1)
    uniq, first_idx, inv = np.unique(view, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)  # unique groups by first appearance
    rank_of_group = np.empty_like(order)
    rank_of_group[order] = np.arange(order.size)
    col_of_mech = rank_of_group[inv]

    num_faults = order.size
    # XOR-combine: p = (1 - prod(1-2p_i)) / 2 per column
    log_terms = np.log1p(-2.0 * probs)
    col_log = np.zeros(num_faults)
    np.add.at(col_log, col_of_mech, log_terms)
    priors = 0.5 * (1.0 - np.exp(col_log))

    uniq_sigs = sigs[first_idx[order]]  # rows at first occurrence, in order

    # unpack bitsets into dense chk/obs
    as_bytes = uniq_sigs.view(np.uint8).reshape(num_faults, words * 8)
    bits = np.unpackbits(as_bytes, axis=1, bitorder="little")
    chk = bits[:, :D].T.astype(np.uint8)
    obs = bits[:, D : D + O].T.astype(np.uint8)

    return DemMatrices(chk=np.ascontiguousarray(chk), obs=np.ascontiguousarray(obs),
                       priors=priors, num_detectors=D, num_observables=O)


def propagate_single_fault(circuit: Circuit, inst_index: int, target_index: int,
                           pauli: str) -> np.ndarray | None:
    """Symptom signature of one elementary fault (testing oracle).

    Recompiles the DEM sensitivity at ``inst_index`` and returns the flipped
    (detectors ‖ observables) indicator vector for injecting ``pauli`` on the
    given target slot of that noise instruction. Slow (per-call sweep); for
    tests only.
    """
    dx, dz = compile_dem_sensitivities(circuit, inst_index)
    inst = circuit.instructions[inst_index]
    t = inst.targets
    if t.ndim == 2:  # two-qubit channel: pauli like "XZ", "IY", ...
        a, b = t[0][target_index], t[1][target_index]
        pa, pb = pauli[0], pauli[1]
        sig = np.zeros_like(dx[0])
        for q, p in ((a, pa), (b, pb)):
            if p == "X":
                sig ^= dx[q]
            elif p == "Z":
                sig ^= dz[q]
            elif p == "Y":
                sig ^= dx[q] ^ dz[q]
    else:
        q = t[target_index]
        sig = {"X": dx[q], "Z": dz[q], "Y": dx[q] ^ dz[q]}[pauli].copy()
    D, O = circuit.num_detectors, circuit.num_observables
    bits = np.unpackbits(sig.view(np.uint8), bitorder="little")
    return bits[: D + O]


def compile_dem_sensitivities(circuit: Circuit, stop_index: int):
    """Backward sensitivity tables at the position of ``stop_index`` (tests)."""
    D = circuit.num_detectors
    O = circuit.num_observables
    words = max(1, -(-(D + O) // _WORD))
    Q = circuit.num_qubits
    meas_masks = np.zeros((circuit.num_measurements, words), dtype=np.uint64)

    def set_bit(rows, bit):
        meas_masks[rows, bit // _WORD] ^= np.uint64(1 << (bit % _WORD))

    for d, recs in enumerate(circuit.detectors):
        set_bit(np.asarray(recs), d)
    for o, recs in circuit.observables.items():
        set_bit(np.asarray(recs, dtype=np.int64), D + o)

    dx = np.zeros((Q, words), dtype=np.uint64)
    dz = np.zeros((Q, words), dtype=np.uint64)
    for idx in range(len(circuit.instructions) - 1, stop_index - 1, -1):
        inst = circuit.instructions[idx]
        name, t = inst.name, inst.targets
        if idx == stop_index:
            break  # sensitivity *at* the noise instruction position
        if name in ("M", "MX", "MR", "MRX"):
            recs = inst.rec_offset + np.arange(t.size)
            masks = meas_masks[recs]
            if name == "M":
                dx[t] ^= masks
            elif name == "MX":
                dz[t] ^= masks
            elif name == "MR":
                dx[t] = masks
                dz[t] = 0
            else:
                dz[t] = masks
                dx[t] = 0
        elif name in ("R", "RX"):
            dx[t] = 0
            dz[t] = 0
        elif name == "H":
            dx[t], dz[t] = dz[t].copy(), dx[t].copy()
        elif name == "S":
            dx[t] ^= dz[t]
        elif name == "CNOT":
            dx[t[0]] ^= dx[t[1]]
            dz[t[1]] ^= dz[t[0]]
        elif name == "CZ":
            dx[t[0]] ^= dz[t[1]]
            dx[t[1]] ^= dz[t[0]]
    return dx, dz
