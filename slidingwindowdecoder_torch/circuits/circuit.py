"""Stabilizer-circuit intermediate representation.

A minimal, vectorized Clifford+noise circuit IR covering exactly the
instruction set used by the reference's syndrome-extraction circuits
(build_circuit.py, build_SHYPS_circuit.py): reset/measure in Z or X basis,
H, CNOT, and the standard Pauli/depolarizing noise channels, plus DETECTOR /
OBSERVABLE_INCLUDE annotations over measurement records.

Unlike stim (which the reference drives through text circuits), instructions
here carry *arrays* of targets, so a whole layer ("for i in range(n//2):
CNOT ...") is one IR instruction — this keeps both the DEM compiler and the
Pauli-frame sampler fully numpy-vectorized.

Measurement records are absolute indices (0-based, in program order);
``Circuit.rec(k)`` converts stim-style negative offsets.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# instruction classes
GATES_1Q = {"H", "S"}  # S included for completeness (X -> Y)
RESETS = {"R", "RX"}
MEASUREMENTS = {"M", "MX", "MR", "MRX"}
NOISE_1Q = {"X_ERROR", "Z_ERROR", "Y_ERROR", "DEPOLARIZE1"}
NOISE_2Q = {"DEPOLARIZE2"}
GATES_2Q = {"CNOT", "CZ"}


@dataclass
class Instruction:
    name: str
    targets: np.ndarray  # [k] for 1q ops; [2, k] (ctrl;tgt) for 2q ops
    prob: float = 0.0
    # measurement instructions record the absolute indices they produced
    rec_offset: int = -1

    def num_targets(self) -> int:
        return self.targets.shape[-1]


@dataclass
class Circuit:
    """Program = ordered instruction list + detector/observable annotations."""

    num_qubits: int
    instructions: list[Instruction] = field(default_factory=list)
    detectors: list[np.ndarray] = field(default_factory=list)  # abs meas indices
    observables: dict[int, list[int]] = field(default_factory=dict)
    num_measurements: int = 0

    # -- construction helpers ------------------------------------------------

    def _targets(self, qubits) -> np.ndarray:
        t = np.atleast_1d(np.asarray(qubits, dtype=np.int32))
        if t.ndim != 1:
            raise ValueError("1-qubit instruction targets must be a flat list")
        if t.size and (t.min() < 0 or t.max() >= self.num_qubits):
            raise ValueError("qubit index out of range")
        return t

    def append(self, name: str, qubits, prob: float = 0.0) -> None:
        name = name.upper()
        if name == "TICK":
            return  # ticks are cosmetic; not needed by DEM/sampling
        if name in GATES_2Q or name in NOISE_2Q:
            t = np.asarray(qubits, dtype=np.int32)
            if t.ndim == 1:
                t = t.reshape(2, -1) if t.size == 2 else t.reshape(-1, 2).T
            if t.shape[0] != 2:
                raise ValueError(f"{name} targets must be (ctrl, tgt) pairs")
            if np.any(t[0] == t[1]):
                raise ValueError(f"{name} control equals target")
            inst = Instruction(name, t, prob)
        elif name in MEASUREMENTS:
            t = self._targets(qubits)
            inst = Instruction(name, t, prob, rec_offset=self.num_measurements)
            self.num_measurements += t.size
        elif name in GATES_1Q | RESETS | NOISE_1Q:
            t = self._targets(qubits)
            inst = Instruction(name, t, prob)
        else:
            raise ValueError(f"unknown instruction {name!r}")
        self.instructions.append(inst)

    # convenience wrappers
    def h(self, qubits):
        self.append("H", qubits)

    def cnot(self, controls, targets):
        self.append("CNOT", np.stack([np.atleast_1d(controls), np.atleast_1d(targets)]))

    def reset(self, qubits, basis: str = "Z"):
        self.append("R" if basis == "Z" else "RX", qubits)

    def measure(self, qubits, basis: str = "Z", reset: bool = False):
        name = {("Z", False): "M", ("Z", True): "MR", ("X", False): "MX", ("X", True): "MRX"}[
            (basis, reset)
        ]
        self.append(name, qubits)

    def x_error(self, qubits, p):
        self.append("X_ERROR", qubits, p)

    def z_error(self, qubits, p):
        self.append("Z_ERROR", qubits, p)

    def depolarize1(self, qubits, p):
        self.append("DEPOLARIZE1", qubits, p)

    def depolarize2(self, controls, targets, p):
        self.append(
            "DEPOLARIZE2",
            np.stack([np.atleast_1d(controls), np.atleast_1d(targets)]),
            p,
        )

    def rec(self, offset: int) -> int:
        """stim-style measurement record lookback: rec(-1) = last measurement."""
        if offset >= 0:
            raise ValueError("rec offset must be negative")
        idx = self.num_measurements + offset
        if idx < 0:
            raise ValueError("rec offset reaches before the first measurement")
        return idx

    def detector(self, rec_offsets) -> None:
        """Declare a detector as the XOR of the given measurement lookbacks."""
        self.detectors.append(
            np.asarray([self.rec(o) for o in np.atleast_1d(rec_offsets)], dtype=np.int64)
        )

    def detector_abs(self, meas_indices) -> None:
        self.detectors.append(np.asarray(meas_indices, dtype=np.int64))

    def observable_include(self, obs_id: int, rec_offsets) -> None:
        self.observables.setdefault(int(obs_id), []).extend(
            self.rec(o) for o in np.atleast_1d(rec_offsets)
        )

    def observable_include_abs(self, obs_id: int, meas_indices) -> None:
        self.observables.setdefault(int(obs_id), []).extend(
            int(i) for i in np.atleast_1d(meas_indices)
        )

    # -- properties ----------------------------------------------------------

    @property
    def num_detectors(self) -> int:
        return len(self.detectors)

    @property
    def num_observables(self) -> int:
        return (max(self.observables) + 1) if self.observables else 0

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Circuit(qubits={self.num_qubits}, instructions={len(self.instructions)}, "
            f"measurements={self.num_measurements}, detectors={self.num_detectors}, "
            f"observables={self.num_observables})"
        )
