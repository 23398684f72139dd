"""Quantum LDPC code family constructors.

Full capability parity with the reference's construction zoo
(codes_q.py:83-588): circulant, generalized-bicycle, hypergraph-product,
surface / rotated-surface / checkerboard-toric, QC-GHP, bivariate-bicycle,
2BGA group-algebra, CAMEL cycle-assemble, and Euclidean-geometry codes, plus
Hamming/repetition classical PCMs, girth computation, and alist IO.
All host-side numpy, fresh implementations.
"""

from __future__ import annotations

from collections import deque
from functools import reduce

import numpy as np

from ..utils.gf2 import int2bin
from .css import CSSCode
from .polynomials import generate_log_antilog_tables, get_primitive_polynomial

__all__ = [
    "create_circulant_matrix",
    "create_generalized_bicycle_codes",
    "hypergraph_product",
    "hamming_code",
    "rep_code",
    "create_surface_codes",
    "create_rotated_surface_codes",
    "create_checkerboard_toric_codes",
    "create_QC_GHP_codes",
    "create_bivariate_bicycle_codes",
    "create_2BGA",
    "create_cycle_assemble_codes",
    "create_EG_codes",
    "find_girth",
    "read_alist",
    "write_alist",
]


def create_circulant_matrix(l: int, pows) -> np.ndarray:
    """l×l circulant with generator polynomial sum(x^p for p in pows).

    Column i carries ones at rows (i+p) mod l — same convention as the
    reference (codes_q.py:83-88), so ``pows=[-1]`` is the down-shift matrix.
    """
    h = np.zeros((l, l), dtype=np.uint8)
    idx = np.arange(l)
    for p in pows:
        h[(idx + p) % l, idx] = 1
    return h


def create_generalized_bicycle_codes(l, a, b, name=None) -> CSSCode:
    A = create_circulant_matrix(l, a)
    B = create_circulant_matrix(l, b)
    hx = np.hstack((A, B))
    hz = np.hstack((B.T, A.T))
    return CSSCode(hx, hz, name=name, name_prefix="GB")


def hypergraph_product(h1, h2, name=None) -> CSSCode:
    """Hypergraph product of two classical PCMs (codes_q.py:99-124)."""
    h1 = np.asarray(h1, dtype=np.uint8)
    h2 = np.asarray(h2, dtype=np.uint8)
    m1, n1 = h1.shape
    m2, n2 = h2.shape
    hx = np.hstack(
        [np.kron(h1, np.eye(n2, dtype=np.uint8)), np.kron(np.eye(m1, dtype=np.uint8), h2.T)]
    )
    hz = np.hstack(
        [np.kron(np.eye(n1, dtype=np.uint8), h2), np.kron(h1.T, np.eye(m2, dtype=np.uint8))]
    )
    return CSSCode(hx, hz, name=name, name_prefix="HP")


def hamming_code(r: int) -> np.ndarray:
    """[2^r-1, 2^r-1-r] Hamming code PCM (r × 2^r-1)."""
    r = int(r)
    cols = [int2bin(i + 1, r) for i in range(2**r - 1)]
    return np.array(cols, dtype=np.uint8).T


def rep_code(d: int) -> np.ndarray:
    """(d-1) × d repetition-code PCM."""
    pcm = np.zeros((d - 1, d), dtype=np.uint8)
    idx = np.arange(d - 1)
    pcm[idx, idx] = 1
    pcm[idx, idx + 1] = 1
    return pcm


def create_surface_codes(n: int) -> CSSCode:
    """[n^2+(n-1)^2, 1, n] (unrotated) surface code via hypergraph product."""
    h = rep_code(n)
    return hypergraph_product(h, h, name=f"Surface_n{n**2 + (n - 1) ** 2}_k1_d{n}")


def _plaquette(n, pcm, row, i, j):
    i1, j1 = (i + 1) % n, (j + 1) % n
    pcm[row, i * n + j] = pcm[row, i1 * n + j1] = 1
    pcm[row, i1 * n + j] = pcm[row, i * n + j1] = 1


def create_rotated_surface_codes(n: int, name=None) -> CSSCode:
    """[[n^2, 1, n]] rotated surface code (n odd), checkerboard layout."""
    assert n % 2 == 1, "n must be odd"
    n2 = n * n
    m = (n2 - 1) // 2
    hx = np.zeros((m, n2), dtype=np.uint8)
    hz = np.zeros((m, n2), dtype=np.uint8)
    x_idx = z_idx = 0
    for i in range(n - 1):
        for j in range(n - 1):
            if (i + j) % 2 == 0:
                _plaquette(n, hz, z_idx, i, j)
                z_idx += 1
            else:
                _plaquette(n, hx, x_idx, i, j)
                x_idx += 1
    for j in range(n - 1):  # top/bottom boundary weight-2 X checks
        if j % 2 == 0:
            hx[x_idx, j] = hx[x_idx, j + 1] = 1
        else:
            hx[x_idx, (n - 1) * n + j] = hx[x_idx, (n - 1) * n + j + 1] = 1
        x_idx += 1
    for i in range(n - 1):  # left/right boundary weight-2 Z checks
        if i % 2 == 0:
            hz[z_idx, i * n + (n - 1)] = hz[z_idx, (i + 1) * n + (n - 1)] = 1
        else:
            hz[z_idx, i * n] = hz[z_idx, (i + 1) * n] = 1
        z_idx += 1
    return CSSCode(hx, hz, name=name, name_prefix="Rotated_Surface")


def create_checkerboard_toric_codes(n: int, name=None) -> CSSCode:
    """Checkerboard toric code on an n×n torus (n even)."""
    assert n % 2 == 0, "n must be even"
    n2 = n * n
    m = n2 // 2
    hx = np.zeros((m, n2), dtype=np.uint8)
    hz = np.zeros((m, n2), dtype=np.uint8)
    x_idx = z_idx = 0
    for i in range(n):
        for j in range(n):
            if (i + j) % 2 == 0:
                _plaquette(n, hz, z_idx, i, j)
                z_idx += 1
            else:
                _plaquette(n, hx, x_idx, i, j)
                x_idx += 1
    return CSSCode(hx, hz, name=name, name_prefix="Toric")


def create_cyclic_permuting_matrix(n: int, shifts) -> np.ndarray:
    """Shift-exponent matrix of a cyclic permuting block (codes_q.py:228-233).

    Row j places shift ``shifts[i]`` at column (j - i) mod n; all other
    entries are -1 (zero block). Feeds ``create_QC_GHP_codes`` — e.g. the
    [[882, 24]] code of Misc.ipynb cell 2 is
    ``create_QC_GHP_codes(63, create_cyclic_permuting_matrix(7, [27, 54, 0]),
    [0, 1, 6])``.
    """
    A = np.full((n, n), -1, dtype=int)
    for i, s in enumerate(shifts):
        for j in range(n):
            A[j, (j - i) % n] = s
    return A


def create_QC_GHP_codes(l, a, b, name=None) -> CSSCode:
    """Quasi-cyclic generalized hypergraph product (codes_q.py:207-226).

    ``a`` is an integer matrix of circulant shifts (−1 entries = zero block);
    ``b`` a list of shifts for the shared circulant B.
    """
    a = np.asarray(a)
    m, n = a.shape
    blocks = [
        [
            create_circulant_matrix(l, [s]) if s >= 0 else np.zeros((l, l), dtype=np.uint8)
            for s in row
        ]
        for row in a
    ]
    A = np.block(blocks)
    temp_b = create_circulant_matrix(l, b)
    B = np.kron(np.eye(m, dtype=np.uint8), temp_b)
    hx = np.hstack((A, B))
    B_T = np.kron(np.eye(n, dtype=np.uint8), temp_b.T)
    hz = np.hstack((B_T, A.T))
    return CSSCode(hx, hz, name=name, name_prefix="GHP")


def create_bivariate_bicycle_codes(
    l, m, A_x_pows, A_y_pows, B_x_pows, B_y_pows, name=None
):
    """Bivariate bicycle codes (IBM [[144,12,12]] family; codes_q.py:235-246).

    Returns ``(code, A_list, B_list)`` where A_list/B_list are the monomial
    summand matrices consumed by the syndrome-circuit builder (A = sum of
    x-powers then y-powers; B = sum of y-powers then x-powers).
    """
    S_l = create_circulant_matrix(l, [-1])
    S_m = create_circulant_matrix(m, [-1])
    x = np.kron(S_l, np.eye(m, dtype=np.uint8))
    y = np.kron(np.eye(l, dtype=np.uint8), S_m)
    A_list = [np.linalg.matrix_power(x, p) % 2 for p in A_x_pows] + [
        np.linalg.matrix_power(y, p) % 2 for p in A_y_pows
    ]
    B_list = [np.linalg.matrix_power(y, p) % 2 for p in B_y_pows] + [
        np.linalg.matrix_power(x, p) % 2 for p in B_x_pows
    ]
    A = reduce(lambda u, v: (u + v) % 2, A_list).astype(np.uint8)
    B = reduce(lambda u, v: (u + v) % 2, B_list).astype(np.uint8)
    hx = np.hstack((A, B))
    hz = np.hstack((B.T, A.T))
    code = CSSCode(hx, hz, name=name, name_prefix="BB", check_css=True)
    return code, [a.astype(np.uint8) for a in A_list], [b.astype(np.uint8) for b in B_list]


# ---------------------------------------------------------------------------
# 2BGA group-algebra codes (codes_q.py:282-323)
# ---------------------------------------------------------------------------


def _ga_multiply(a_b, c_d, n, m, k):
    a, b = a_b
    c, d = c_d
    return ((a + c * pow(k, b, n)) % n, (b + d) % m)


def create_2BGA(n, m, k, a_poly, b_poly, sr: bool = False) -> CSSCode:
    """Two-block group-algebra code over the semidirect product Z_n ⋊_k Z_m."""
    l = n * m

    def idx2tuple(idx):
        return (idx // m, idx % m)

    def build(poly, left: bool):
        M = np.zeros((l, l), dtype=np.int64)
        for (a, b) in poly:
            if sr:  # convert s^a r^b -> r^{b k^a} s^a
                a, b = (b * pow(k, a, n)) % n, a
            for i in range(l):
                c, d = idx2tuple(i)
                if left:
                    a_, b_ = _ga_multiply((a, b), (c, d), n, m, k)
                else:
                    a_, b_ = _ga_multiply((c, d), (a, b), n, m, k)
                M[a_ * m + b_, i] += 1
        return (M % 2).astype(np.uint8)

    A = build(a_poly, left=True)
    B = build(b_poly, left=False)
    hx = np.hstack((A, B))
    hz = np.hstack((B.T, A.T))
    return CSSCode(hx, hz, name_prefix="2BGA", check_css=True)


def create_cycle_assemble_codes(p: int, sigma: int) -> CSSCode:
    """CAMEL cycle-assembled codes (codes_q.py:405-429)."""
    first_row = [pow(sigma, i, p) for i in range(p - 1)]
    mat = np.zeros((p - 1, p - 1), dtype=np.int64)
    mat[0, :] = first_row
    for i in range(1, p - 1):
        mat[i, :] = np.roll(mat[i - 1, :], 1)
    mat = np.hstack((np.ones((p - 1, 1), dtype=np.int64), mat))
    half = (p - 1) // 2

    def assemble(rows):
        return np.block(
            [[create_circulant_matrix(p, [-s]) for s in row] for row in rows]
        )

    A = assemble(mat[:half])
    B = assemble(mat[half:])
    hx = np.hstack((A, np.ones((half * p, 1), dtype=np.uint8)))
    hz = np.hstack((B, np.ones((half * p, 1), dtype=np.uint8)))
    return CSSCode(hx, hz, name_prefix="CAMEL", check_css=True)


def create_EG_codes(s: int) -> CSSCode:
    """Euclidean-geometry codes from lines of EG(2, 2^s) (codes_q.py:557-588)."""
    order = 2 ** (2 * s) - 1
    ext = 2 * s
    prim = get_primitive_polynomial(ext)
    log_table, antilog_table = generate_log_antilog_tables(ext, prim)
    gf_size = 2**ext

    # vector[i] = j such that alpha^j = 1 + alpha^i
    vector = [-1] * gf_size
    for i in range(1, gf_size):
        val = 1 ^ antilog_table[i % (gf_size - 1)]
        if val < gf_size and log_table[val] != -1:
            vector[i] = log_table[val]

    log_beta = 2**s + 1  # beta = alpha^(2^s+1) generates GF(2^s)
    lines = []
    for i in range(order):
        for j in range(log_beta):
            inc = np.zeros(gf_size, dtype=np.uint8)
            inc[i + 1] = 1
            for kk in range(2**s):
                idx = (kk * log_beta + j - i) % order
                if idx == 0:
                    inc[0] = 1
                else:
                    c = (i + vector[idx]) % order
                    inc[c + 1] = 1
            lines.append(inc)
    H = np.unique(np.array(lines).astype(bool), axis=0).T
    num_row, num_col = H.shape
    assert num_col == 2 ** (2 * s) + 2**s
    hx = np.hstack((H.astype(np.uint8), np.ones((num_row, 1), dtype=np.uint8)))
    return CSSCode(hx, hx.copy(), name_prefix="EG", check_css=True)


def find_girth(pcm) -> int:
    """Shortest cycle length of the Tanner graph (BFS from every vertex)."""
    pcm = np.asarray(pcm)
    m, n = pcm.shape
    adj = [
        [m + j for j in np.nonzero(pcm[i])[0]] for i in range(m)
    ] + [
        [i for i in np.nonzero(pcm[:, j])[0]] for j in range(n)
    ]
    total = m + n
    girth = np.inf
    for start in range(total):
        dist = [-1] * total
        dist[start] = 0
        parent = [-1] * total
        queue = deque([start])
        while queue:
            v = queue.popleft()
            for w in adj[v]:
                if dist[w] == -1:
                    dist[w] = dist[v] + 1
                    parent[w] = v
                    queue.append(w)
                elif w != parent[v] and dist[w] >= dist[v]:
                    girth = min(girth, dist[v] + dist[w] + 1)
        # early exit: girth can't shrink below 4 in a bipartite simple graph
        if girth == 4:
            return 4
    return int(girth) if girth != np.inf else -1


# ---------------------------------------------------------------------------
# alist IO (MacKay format; codes_q.py:249-279 and utils.py:58-197)
# ---------------------------------------------------------------------------


def read_alist(path: str) -> np.ndarray:
    """Read a PCM from an alist text file into a 0/1 uint8 matrix."""
    with open(path) as f:
        lines = [list(map(int, ln.split())) for ln in f.read().splitlines() if ln.strip()]
    n_cols, n_rows = lines[0]
    start = 4 if (len(lines[2]) == n_cols and len(lines[3]) == n_rows) else 2
    mat = np.zeros((n_rows, n_cols), dtype=np.uint8)
    for col, nonzeros in enumerate(lines[start : start + n_cols]):
        for r in nonzeros:
            if r != 0:
                mat[r - 1, col] = 1
    return mat


def write_alist(path: str, mat: np.ndarray) -> None:
    """Write a 0/1 matrix as an alist file (column-major neighbor lists)."""
    mat = np.asarray(mat)
    m, n = mat.shape
    col_nnz = [list(np.nonzero(mat[:, j])[0] + 1) for j in range(n)]
    row_nnz = [list(np.nonzero(mat[i])[0] + 1) for i in range(m)]
    max_c = max((len(c) for c in col_nnz), default=0)
    max_r = max((len(r) for r in row_nnz), default=0)
    with open(path, "w") as f:
        f.write(f"{n} {m}\n{max_c} {max_r}\n")
        f.write(" ".join(str(len(c)) for c in col_nnz) + "\n")
        f.write(" ".join(str(len(r)) for r in row_nnz) + "\n")
        for c in col_nnz:
            f.write(" ".join(map(str, c + [0] * (max_c - len(c)))) + "\n")
        for r in row_nnz:
            f.write(" ".join(map(str, r + [0] * (max_r - len(r)))) + "\n")
