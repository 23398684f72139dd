"""SHYPS subsystem-code construction and gauge-measurement circuits.

Re-implementation of the reference's SHYPS builder
(build_SHYPS_circuit.py:9-192): simplex-code PCMs from a primitive
polynomial, X/Z stabilizers / gauge operators / logicals as Kronecker
products, a 3-color gauge-measurement schedule via bipartite edge coloring,
and gauge outcomes aggregated into stabilizer detectors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..codes.polynomials import poly_divmod
from ..utils.gf2 import inverse
from ..utils.matching import edge_coloring_bipartite
from .circuit import Circuit

_PRIMITIVE = {3: [0, 2, 3], 4: [0, 3, 4], 5: [0, 2, 5]}


@dataclass
class SHYPSCode:
    r: int
    n_r: int
    N: int  # data qubits = n_r^2
    S_X: np.ndarray
    S_Z: np.ndarray
    gauge_X: np.ndarray
    gauge_Z: np.ndarray
    aggregate_X: np.ndarray
    aggregate_Z: np.ndarray
    L_X: np.ndarray
    L_Z: np.ndarray


def build_shyps_code(r: int) -> SHYPSCode:
    if r not in _PRIMITIVE:
        raise ValueError(f"unsupported r={r}; known: {sorted(_PRIMITIVE)}")
    n_r = 2**r - 1
    # h(x) with gcd(h, x^{n_r}-1) primitive of degree r
    exps = _PRIMITIVE[r]
    h = np.zeros(n_r, dtype=np.int64)
    for e in exps:
        h[e] = 1
    H = np.array([np.roll(h, i) for i in range(n_r)], dtype=np.uint8)
    # g(x) = (x^{n_r} - 1) / h(x)
    xn1 = np.zeros(n_r + 1, dtype=np.int64)
    xn1[0] = 1
    xn1[n_r] = 1
    g_coeff, rem = poly_divmod(list(xn1), list(h), p=2)
    assert rem == [0], "h(x) must divide x^{n_r} - 1"
    g = np.zeros(n_r, dtype=np.uint8)
    g[: len(g_coeff)] = g_coeff
    G = np.array([np.roll(g, i) for i in range(r)], dtype=np.uint8)
    assert not (G.astype(int) @ H.astype(int) % 2).any(), "GH != 0"

    I = np.eye(n_r, dtype=np.uint8)
    S_X = np.kron(H.T, G)
    gauge_X = np.kron(H.T, I)
    aggregate_X = np.kron(I, G)
    S_Z = np.kron(G, H.T)
    gauge_Z = np.kron(I, H.T)
    aggregate_Z = np.kron(G, I)
    P = inverse(G.T.astype(np.uint8))
    L_X = np.kron(P, G).astype(np.uint8)
    L_Z = np.kron(G, P).astype(np.uint8)

    def commute(a, b):
        return not (a.astype(int) @ b.astype(int).T % 2).any()

    assert commute(S_X, S_Z)
    assert commute(gauge_X, S_Z) and commute(S_X, gauge_Z)
    assert commute(gauge_X, L_Z) and commute(L_X, gauge_Z)

    return SHYPSCode(
        r=r,
        n_r=n_r,
        N=n_r**2,
        S_X=S_X.astype(np.uint8),
        S_Z=S_Z.astype(np.uint8),
        gauge_X=gauge_X.astype(np.uint8),
        gauge_Z=gauge_Z.astype(np.uint8),
        aggregate_X=aggregate_X.astype(np.uint8),
        aggregate_Z=aggregate_Z.astype(np.uint8),
        L_X=L_X,
        L_Z=L_Z,
    )


def build_shyps_circuit(
    r: int, p: float, num_repeat: int, z_basis: bool = True, use_both: bool = False
):
    """Noisy SHYPS gauge-measurement memory experiment.

    Layout: [X-gauge ancillas | data | Z-gauge ancillas], each block of size
    N = n_r^2; per round, 3 CNOT colors per basis (an edge coloring of the
    gauge/data incidence graph — each color class is a matching, so it is a
    single parallel CNOT layer).

    Returns (circuit, code).
    """
    code = build_shyps_code(r)
    N = code.N

    colors_X, ncx = edge_coloring_bipartite(code.gauge_X)
    colors_Z, ncz = edge_coloring_bipartite(code.gauge_Z)
    assert ncx == 3 and ncz == 3, "SHYPS gauge graphs must be 3-colorable"

    x_anc = np.arange(N, dtype=np.int32)
    data = N + np.arange(N, dtype=np.int32)
    z_anc = 2 * N + np.arange(N, dtype=np.int32)

    c = Circuit(3 * N)

    def cnot_color(pairs, ctrl_from_gauge: bool, anc):
        gauges = np.asarray([g for g, d in pairs], dtype=np.int32)
        datas = np.asarray([d for g, d in pairs], dtype=np.int32)
        if ctrl_from_gauge:  # X gauges: ancilla controls
            c.cnot(anc[gauges], data[datas])
            c.depolarize2(anc[gauges], data[datas], p)
        else:  # Z gauges: data controls
            c.cnot(data[datas], anc[gauges])
            c.depolarize2(data[datas], anc[gauges], p)

    def detectors_first(aggregate):
        for row in aggregate:
            c.detector([-N + int(i) for i in np.nonzero(row)[0]])

    def detectors_repeat(aggregate):
        for row in aggregate:
            recs = []
            for i in np.nonzero(row)[0]:
                recs += [-N + int(i), -3 * N + int(i)]
            c.detector(recs)

    def round_block(repeat: bool):
        if repeat:
            c.x_error(z_anc, p)
            c.z_error(x_anc, p)
            c.depolarize1(data, p)
        for color in range(3):
            cnot_color(colors_Z[color], ctrl_from_gauge=False, anc=z_anc)
        c.x_error(z_anc, p)
        c.measure(z_anc, basis="Z", reset=False)
        if z_basis:
            (detectors_repeat if repeat else detectors_first)(code.aggregate_Z)
        elif use_both and repeat:
            detectors_repeat(code.aggregate_Z)
        c.reset(x_anc, "X")
        c.z_error(x_anc, p)
        for color in range(3):
            cnot_color(colors_X[color], ctrl_from_gauge=True, anc=x_anc)
        c.z_error(x_anc, p)
        c.measure(x_anc, basis="X", reset=False)
        if not z_basis:
            (detectors_repeat if repeat else detectors_first)(code.aggregate_X)
        elif use_both and repeat:
            detectors_repeat(code.aggregate_X)
        c.reset(z_anc, "Z")
        c.x_error(z_anc, p)

    # initialization
    c.reset(x_anc, "X")
    c.z_error(x_anc, p)
    c.reset(z_anc, "Z")
    c.x_error(z_anc, p)
    c.reset(data, "Z" if z_basis else "X")
    if z_basis:
        c.x_error(data, p)
    else:
        c.z_error(data, p)

    round_block(repeat=False)
    for _ in range(num_repeat - 1):
        round_block(repeat=True)

    # final transversal data measurement with measurement noise
    if z_basis:
        c.x_error(data, p)
    else:
        c.z_error(data, p)
    c.measure(data, basis="Z" if z_basis else "X", reset=False)

    pcm = code.S_Z if z_basis else code.S_X
    aggregate = code.aggregate_Z if z_basis else code.aggregate_X
    logicals = code.L_Z if z_basis else code.L_X
    M = c.num_measurements
    back = 3 * N if z_basis else 2 * N
    for row_idx, row in enumerate(pcm):
        recs = [M - N + int(i) for i in np.nonzero(row)[0]]
        recs += [M - back + int(g) for g in np.nonzero(aggregate[row_idx])[0]]
        c.detector_abs(recs)
    for row_idx, row in enumerate(logicals):
        c.observable_include_abs(
            row_idx, [M - N + int(i) for i in np.nonzero(row)[0]]
        )
    return c, code
