"""Dense GF(2) linear algebra (host side, numpy).

Construction-time linear algebra for CSS codes: row echelon forms, ranks,
kernels, inverses. These run once per code/experiment on the host, so they
are written for clarity and numpy-vectorized row operations rather than for
raw speed; the *decode-time* GF(2) elimination lives in
``ops.gf2_solve`` as a batched, bit-packed torch path with a CUDA
kernel (``ops.gf2_cuda``).

Capability parity with the reference's ``src/utils.py`` (row_echelon:
utils.py:309, rank: :377, kernel: :391, row_basis: :432,
compute_code_distance: :446, inverse: :476, bin2int/int2bin: :10-56).
All functions here are fresh implementations against the same contracts.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bin2int",
    "int2bin",
    "row_echelon",
    "rank",
    "kernel",
    "row_basis",
    "compute_code_distance",
    "inverse",
    "gf2_matmul",
    "gf2_solve_lower",
    "make_systematic",
]


def bin2int(bits) -> int:
    """Interpret an iterable of 0/1 (MSB first) as an integer."""
    out = 0
    for b in bits:
        out = (out << 1) | int(b)
    return out


def int2bin(value: int, width: int) -> list[int]:
    """Little-endian-truncated binary expansion, MSB first, fixed ``width``.

    Mirrors the reference contract (utils.py:28-56): the *last* ``width``
    bits of ``value`` are returned.
    """
    assert value >= 0 and width >= 0
    return [(value >> (width - 1 - i)) & 1 for i in range(width)]


def _as_bool(mat: np.ndarray) -> np.ndarray:
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError(f"expected a 2-D binary matrix, got shape {mat.shape}")
    return mat.astype(bool)


def row_echelon(mat, reduced: bool = False):
    """(Reduced) row echelon form of a binary matrix over GF(2).

    Returns ``[echelon, rank, transform, pivot_cols]`` with
    ``transform @ mat % 2 == echelon``; no column swaps are performed
    (same contract as reference utils.py:309-375). Works for rank-deficient
    and over-complete matrices.
    """
    work = _as_bool(mat).copy()
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
                continue  # all-zero column below the current pivot row
            swap = pivot_row + hit
            work[[pivot_row, swap]] = work[[swap, pivot_row]]
            transform[[pivot_row, swap]] = transform[[swap, pivot_row]]
        # eliminate every other row carrying a 1 in this column
        sel = work[:, col].copy()
        if reduced:
            sel[pivot_row] = False
        else:
            sel[: pivot_row + 1] = False
        work[sel] ^= work[pivot_row]
        transform[sel] ^= transform[pivot_row]
        pivot_cols.append(col)
        pivot_row += 1

    return [work.astype(np.uint8), pivot_row, transform.astype(np.uint8), pivot_cols]


def rank(mat) -> int:
    """Rank of a binary matrix over GF(2)."""
    return row_echelon(mat)[1]


def kernel(mat):
    """Kernel (null space) of a binary matrix over GF(2).

    Returns ``(ker, rank, pivot_cols)`` where ``ker`` rows span
    ``{x : mat @ x = 0 (mod 2)}`` and ``pivot_cols`` are the pivots of
    ``mat.T`` (usable to extract a row basis of ``mat``); same triple as the
    reference (utils.py:391-430).
    """
    transpose = _as_bool(mat).T
    m = transpose.shape[0]
    _, r, transform, pivot_cols = row_echelon(transpose)
    return transform[r:m], r, pivot_cols


def row_basis(mat) -> np.ndarray:
    """A subset of rows of ``mat`` forming a basis of its row space."""
    mat = np.asarray(mat)
    return mat[row_echelon(mat.T)[3]]


def compute_code_distance(mat, is_pcm: bool = True, is_basis: bool = False):
    """Minimum weight over the given generator/basis rows.

    NOTE: like the reference (utils.py:446-474), when handed a basis this is
    the minimum *basis-row* weight, i.e. an upper bound on the true code
    distance — kept for behavioural parity.
    """
    gen = mat
    if is_pcm:
        gen, _, _ = kernel(mat)
    if len(gen) == 0:
        return np.inf
    cw = gen if is_basis else row_basis(gen)
    if len(cw) == 0:
        return np.inf
    return int(np.min(np.sum(np.asarray(cw) % 2, axis=1)))


def inverse(mat) -> np.ndarray:
    """Inverse (square) or left inverse (full column rank) over GF(2)."""
    mat = np.asarray(mat)
    m, n = mat.shape
    red, r, transform, _ = row_echelon(mat, reduced=True)
    if m == n and r == m:
        return transform
    if m > r and n == r:
        return (red.T.astype(np.uint8) @ transform.astype(np.uint8)) % 2
    raise ValueError(
        "matrix is not invertible: need square full rank or full column rank"
    )


def gf2_matmul(a, b) -> np.ndarray:
    """``a @ b`` over GF(2) (dense numpy, int64 accumulate)."""
    return (np.asarray(a, dtype=np.int64) @ np.asarray(b, dtype=np.int64)) % 2


def gf2_solve_lower(mat, rhs) -> np.ndarray | None:
    """Solve ``mat @ x = rhs (mod 2)`` if consistent, else ``None``."""
    mat = np.asarray(mat)
    rhs = np.asarray(rhs).reshape(-1, 1)
    aug = np.hstack([mat, rhs])
    ech, r, _, pivots = row_echelon(aug, reduced=True)
    n = mat.shape[1]
    if n in pivots:  # pivot in augmented column => inconsistent
        return None
    x = np.zeros(n, dtype=np.uint8)
    for i, c in enumerate(pivots):
        x[c] = ech[i, n]
    return x


def make_systematic(mat):
    """Column-permute ``mat`` into ``[I | A]`` form.

    Returns ``(sys_mat, column_order)`` with
    ``sys_mat == rref(mat)[:, column_order]`` restricted to the pivot rows;
    parity with reference utils.py:199-303 (which records column swaps).
    """
    mat = np.asarray(mat)
    red, r, _, pivots = row_echelon(mat, reduced=True)
    n = mat.shape[1]
    non_pivots = [c for c in range(n) if c not in set(pivots)]
    order = list(pivots) + non_pivots
    sys_mat = red[:r][:, order]
    assert np.array_equal(sys_mat[:, :r], np.eye(r, dtype=sys_mat.dtype))
    return sys_mat, np.asarray(order)
