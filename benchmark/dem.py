"""The benchmark's inputs: the bivariate-bicycle memory experiment and its
detector error model (DEM), in numpy.

A frozen copy of the port's builders at commit 6c64bcc, trimmed to what a
z-basis BB memory experiment needs:
``slidingwindowdecoder_torch/codes/constructors.py``
(``create_circulant_matrix``, ``create_bivariate_bicycle_codes``),
``codes/css.py`` (the logical operators), ``utils/gf2.py``
(``row_echelon``, ``kernel``), ``circuits/circuit.py`` (the circuit IR),
``circuits/builders.py`` (``build_bb_memory_circuit``) and
``circuits/dem.py`` (``compile_dem``). The benchmark builds the DEM here and
hands the same matrices to the program and to the reference, so neither
side's builder decides what the other decodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import reduce

import numpy as np

# (l, m, A x-powers, A y-powers, B x-powers, B y-powers) by block length
# (the port's codes/__init__.py:BB_CODE_PARAMS)
BB_CODE_PARAMS = {
    72: (6, 6, [3], [1, 2], [1, 2], [3]),
    144: (12, 6, [3], [1, 2], [1, 2], [3]),
}

_WORD = 64


# ---------------------------------------------------------------------------
# the code
# ---------------------------------------------------------------------------


def _row_echelon(mat):
    """Row echelon form over GF(2) without column swaps: (rank, transform,
    pivot columns) with ``transform @ mat % 2`` the echelon form."""
    work = (np.asarray(mat) != 0).copy()
    m, n = work.shape
    transform = np.eye(m, dtype=bool)
    pivot_cols: list[int] = []
    pivot_row = 0
    for col in range(n):
        if pivot_row >= m:
            break
        col_below = work[pivot_row:, col]
        if not col_below[0]:
            hit = np.argmax(col_below)
            if not col_below[hit]:
                continue
            swap = pivot_row + hit
            work[[pivot_row, swap]] = work[[swap, pivot_row]]
            transform[[pivot_row, swap]] = transform[[swap, pivot_row]]
        sel = work[:, col].copy()
        sel[: pivot_row + 1] = False
        work[sel] ^= work[pivot_row]
        transform[sel] ^= transform[pivot_row]
        pivot_cols.append(col)
        pivot_row += 1
    return pivot_row, transform.astype(np.uint8), pivot_cols


def _kernel(mat):
    """(kernel rows, rank, pivot columns of ``mat.T``) over GF(2)."""
    transpose = (np.asarray(mat) != 0).T
    r, transform, pivot_cols = _row_echelon(transpose)
    return transform[r:transpose.shape[0]], r, pivot_cols


def _circulant(l: int, pows) -> np.ndarray:
    h = np.zeros((l, l), dtype=np.uint8)
    idx = np.arange(l)
    for p in pows:
        h[(idx + p) % l, idx] = 1
    return h


@dataclass
class BBCode:
    N: int
    hx: np.ndarray
    hz: np.ndarray
    lz: np.ndarray
    A_list: list
    B_list: list


def bb_code(N: int) -> BBCode:
    """The [[N, 12]] bivariate-bicycle code with its Z logicals and the
    monomial summands the circuit builder schedules by."""
    l, m, ax, ay, bx, by = BB_CODE_PARAMS[N]
    x = np.kron(_circulant(l, [-1]), np.eye(m, dtype=np.uint8))
    y = np.kron(np.eye(l, dtype=np.uint8), _circulant(m, [-1]))
    A_list = [np.linalg.matrix_power(x, p) % 2 for p in ax] + [
        np.linalg.matrix_power(y, p) % 2 for p in ay]
    B_list = [np.linalg.matrix_power(y, p) % 2 for p in by] + [
        np.linalg.matrix_power(x, p) % 2 for p in bx]
    A = reduce(lambda u, v: (u + v) % 2, A_list).astype(np.uint8)
    B = reduce(lambda u, v: (u + v) % 2, B_list).astype(np.uint8)
    hx = np.hstack((A, B))
    hz = np.hstack((B.T, A.T))
    hx_perp, _, pivot_hx = _kernel(hx)
    _, _, pivot_hz = _kernel(hz)
    # lz spans ker(hx) outside rowspace(hz): the kernel rows that are pivots
    # of the stack [hz basis; ker(hx)]
    stack = np.vstack([hz[pivot_hz], hx_perp.astype(np.uint8)])
    pivots = _row_echelon(stack.T)[2]
    lz = stack[[i for i in pivots if i >= len(pivot_hz)]].astype(np.uint8)
    return BBCode(N=hx.shape[1], hx=hx, hz=hz, lz=lz,
                  A_list=[a.astype(np.uint8) for a in A_list],
                  B_list=[b.astype(np.uint8) for b in B_list])


# ---------------------------------------------------------------------------
# the circuit
# ---------------------------------------------------------------------------


@dataclass
class Instruction:
    name: str
    targets: np.ndarray  # [k], or [2, k] for two-qubit instructions
    prob: float = 0.0
    rec_offset: int = -1


@dataclass
class Circuit:
    num_qubits: int
    instructions: list = field(default_factory=list)
    detectors: list = field(default_factory=list)
    observables: dict = field(default_factory=dict)
    num_measurements: int = 0

    def add(self, name, targets, prob=0.0):
        t = np.asarray(targets, dtype=np.int32)
        inst = Instruction(name, t, prob)
        if name in ("M", "MX", "MR", "MRX"):
            inst.rec_offset = self.num_measurements
            self.num_measurements += t.size
        self.instructions.append(inst)

    def pair(self, name, ctrl, tgt, prob=0.0):
        self.add(name, np.stack([np.atleast_1d(ctrl), np.atleast_1d(tgt)]), prob)

    def detector(self, rec_offsets):
        self.detectors.append(np.asarray([self.num_measurements + o for o in rec_offsets],
                                         dtype=np.int64))

    @property
    def num_detectors(self) -> int:
        return len(self.detectors)

    @property
    def num_observables(self) -> int:
        return (max(self.observables) + 1) if self.observables else 0


def _perm_of(monomial) -> np.ndarray:
    rows, cols = np.nonzero(np.asarray(monomial))
    return cols[np.argsort(rows)].astype(np.int32)


def bb_memory_circuit(code: BBCode, p: float, num_repeat: int) -> Circuit:
    """The z-basis BB memory experiment over ``num_repeat`` rounds: the
    8-stage CNOT schedule, every noise knob equal to ``p`` (two-qubit
    depolarizing after each CNOT, reset and measurement flips, single-qubit
    depolarizing on idling data)."""
    n = code.N
    half = n // 2
    a1, a2, a3 = code.A_list
    b1, b2, b3 = code.B_list
    A1, A2, A3 = _perm_of(a1), _perm_of(a2), _perm_of(a3)
    B1, B2, B3 = _perm_of(b1), _perm_of(b2), _perm_of(b3)
    A1_T, A2_T, A3_T = _perm_of(a1.T), _perm_of(a2.T), _perm_of(a3.T)
    B1_T, B2_T, B3_T = _perm_of(b1.T), _perm_of(b2.T), _perm_of(b3.T)
    x_anc = np.arange(half, dtype=np.int32)
    l_data = half + np.arange(half, dtype=np.int32)
    r_data = n + np.arange(half, dtype=np.int32)
    z_anc = 3 * half + np.arange(half, dtype=np.int32)
    data = half + np.arange(n, dtype=np.int32)
    c = Circuit(2 * n)

    def noisy_cnot(ctrl, tgt):
        c.pair("CNOT", ctrl, tgt)
        c.pair("DEPOLARIZE2", ctrl, tgt, p)

    def round_block(repeat: bool):
        if repeat:
            c.add("X_ERROR", z_anc, p)
            c.add("Z_ERROR", x_anc, p)
            c.add("DEPOLARIZE1", r_data, p)
        else:
            c.add("H", x_anc)
        noisy_cnot(r_data[A1_T], z_anc)
        c.add("DEPOLARIZE1", l_data, p)
        noisy_cnot(x_anc, l_data[A2])
        noisy_cnot(r_data[A3_T], z_anc)
        noisy_cnot(x_anc, r_data[B2])
        noisy_cnot(l_data[B1_T], z_anc)
        noisy_cnot(x_anc, r_data[B1])
        noisy_cnot(l_data[B2_T], z_anc)
        noisy_cnot(x_anc, r_data[B3])
        noisy_cnot(l_data[B3_T], z_anc)
        noisy_cnot(x_anc, l_data[A1])
        noisy_cnot(r_data[A2_T], z_anc)
        noisy_cnot(x_anc, l_data[A3])
        c.add("X_ERROR", z_anc, p)
        c.add("MR", z_anc)
        for i in range(half):
            c.detector([-half + i, -n - half + i] if repeat else [-half + i])
        c.add("Z_ERROR", x_anc, p)
        c.add("MRX", x_anc)

    c.add("R", x_anc)
    c.add("R", z_anc)
    c.add("X_ERROR", x_anc, p)
    c.add("X_ERROR", z_anc, p)
    c.add("R", data)
    c.add("X_ERROR", data, p)
    round_block(repeat=False)
    for _ in range(num_repeat - 1):
        round_block(repeat=True)
    c.add("M", data)
    M = c.num_measurements
    for i, row in enumerate(code.hz):
        recs = [M - n + int(j) for j in np.nonzero(row)[0]] + [M - 2 * n + i]
        c.detectors.append(np.asarray(recs, dtype=np.int64))
    for i, row in enumerate(code.lz):
        c.observables[i] = [M - n + int(j) for j in np.nonzero(row)[0]]
    return c


# ---------------------------------------------------------------------------
# the DEM
# ---------------------------------------------------------------------------


@dataclass
class Dem:
    chk: np.ndarray  # [detectors, faults] uint8
    obs: np.ndarray  # [observables, faults] uint8
    priors: np.ndarray  # [faults] float64


def compile_dem(circuit: Circuit) -> Dem:
    """One backward sweep of per-qubit symptom bitsets; every elementary
    mechanism read off its noise instruction, mechanisms of equal
    signature merged by the XOR rule p = (1 - prod(1 - 2 p_i)) / 2."""
    D, O = circuit.num_detectors, circuit.num_observables
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
    sig_chunks, prob_chunks = [], []

    def emit(sigs, prob):
        sig_chunks.append(sigs.copy())
        prob_chunks.append(np.full(sigs.shape[0], prob, dtype=np.float64))

    for inst in reversed(circuit.instructions):
        name, t = inst.name, inst.targets
        if name in ("M", "MR", "MRX"):
            masks = meas_masks[inst.rec_offset + np.arange(t.size)]
            if name == "M":
                dx[t] ^= masks
            elif name == "MR":
                dx[t] = masks
                dz[t] = 0
            else:
                dz[t] = masks
                dx[t] = 0
        elif name == "R":
            dx[t] = 0
            dz[t] = 0
        elif name == "H":
            dx[t], dz[t] = dz[t].copy(), dx[t].copy()
        elif name == "CNOT":
            dx[t[0]] ^= dx[t[1]]
            dz[t[1]] ^= dz[t[0]]
        elif name == "X_ERROR":
            emit(dx[t], inst.prob)
        elif name == "Z_ERROR":
            emit(dz[t], inst.prob)
        elif name == "DEPOLARIZE1":
            q = 0.5 * (1.0 - np.sqrt(max(0.0, 1.0 - 4.0 * inst.prob / 3.0)))
            emit(dx[t], q)
            emit(dx[t] ^ dz[t], q)
            emit(dz[t], q)
        elif name == "DEPOLARIZE2":
            q = 0.5 * (1.0 - (max(0.0, 1.0 - 16.0 * inst.prob / 15.0)) ** 0.125)
            a, b = t[0], t[1]
            pa = [np.zeros_like(dx[a]), dx[a], dx[a] ^ dz[a], dz[a]]
            pb = [np.zeros_like(dx[b]), dx[b], dx[b] ^ dz[b], dz[b]]
            for ia in range(4):
                for ib in range(4):
                    if ia or ib:
                        emit(pa[ia] ^ pb[ib], q)
        else:
            raise ValueError(f"unhandled instruction {name}")

    sigs = np.concatenate(sig_chunks[::-1], axis=0)
    probs = np.concatenate(prob_chunks[::-1], axis=0)
    nonzero = sigs.any(axis=1) & (probs > 0.0)
    sigs, probs = sigs[nonzero], probs[nonzero]
    view = np.ascontiguousarray(sigs).view(
        np.dtype((np.void, sigs.dtype.itemsize * sigs.shape[1]))).reshape(-1)
    _, first_idx, inv = np.unique(view, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)
    rank_of_group = np.empty_like(order)
    rank_of_group[order] = np.arange(order.size)
    col_log = np.zeros(order.size)
    np.add.at(col_log, rank_of_group[inv], np.log1p(-2.0 * probs))
    priors = 0.5 * (1.0 - np.exp(col_log))
    as_bytes = sigs[first_idx[order]].view(np.uint8).reshape(order.size, words * 8)
    bits = np.unpackbits(as_bytes, axis=1, bitorder="little")
    return Dem(chk=np.ascontiguousarray(bits[:, :D].T.astype(np.uint8)),
               obs=np.ascontiguousarray(bits[:, D:D + O].T.astype(np.uint8)),
               priors=priors)


def build_dem(code_n: int, rounds: int, p: float) -> Dem:
    """The DEM of the z-basis [[code_n]] memory experiment at noise ``p``."""
    return compile_dem(bb_memory_circuit(bb_code(code_n), p, rounds))
