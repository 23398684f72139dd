"""CSS code container.

Capability parity with the reference ``css_code`` class (codes_q.py:7-81):
given a pair of binary parity-check matrices ``hx``/``hz`` with
``hx @ hz.T = 0 (mod 2)``, derive kernels, stabilizer bases, the code
dimension K, LDPC row/column weights, and a basis of logical operators.
Everything is plain numpy run once at construction time.
"""

from __future__ import annotations

import numpy as np

from ..utils.gf2 import (
    compute_code_distance,
    inverse,
    kernel,
    row_echelon,
)


class CSSCode:
    """A CSS stabilizer code defined by X/Z parity-check matrices.

    Attributes mirror the reference container: ``hx, hz, lx, lz, N, K, D``
    (distance proxy), ``L``/``Q`` max column/row weight, ``hx_perp`` /
    ``hz_perp`` (kernels), ``hx_basis``/``hz_basis`` (independent stabilizer
    rows).
    """

    def __init__(
        self,
        hx: np.ndarray,
        hz: np.ndarray,
        code_distance: float = np.nan,
        name: str | None = None,
        name_prefix: str = "",
        check_css: bool = False,
        compute_distance: bool = False,
    ):
        hx = np.asarray(hx, dtype=np.uint8) % 2
        hz = np.asarray(hz, dtype=np.uint8) % 2
        if hx.ndim != 2 or hz.ndim != 2:
            raise ValueError("hx and hz must be 2-D binary matrices")
        if hx.shape[1] != hz.shape[1]:
            raise ValueError("hx and hz must have the same number of columns")
        if hx.shape[1] == 0:
            raise ValueError("number of qubits must be nonzero")
        if check_css and np.any((hx.astype(np.int64) @ hz.T.astype(np.int64)) % 2):
            raise ValueError("CSS constraint hx @ hz.T = 0 violated")

        self.hx = hx
        self.hz = hz
        self.N = hx.shape[1]

        self.hx_perp, self.rank_hx, self.pivot_hx = kernel(hx)
        self.hz_perp, self.rank_hz, self.pivot_hz = kernel(hz)
        self.hx_perp = self.hx_perp.astype(np.uint8)
        self.hz_perp = self.hz_perp.astype(np.uint8)
        self.hx_basis = self.hx[self.pivot_hx]
        self.hz_basis = self.hz[self.pivot_hz]
        self.K = self.N - self.rank_hx - self.rank_hz

        # LDPC parameters: max column weight L, max row weight Q
        self.L = int(
            max(self.hx.sum(axis=0).max(), self.hz.sum(axis=0).max())
        )
        self.Q = int(
            max(self.hx.sum(axis=1).max(), self.hz.sum(axis=1).max())
        )

        self.lx, self.lz = self._compute_logicals()

        self.D = code_distance
        if compute_distance and np.isnan(code_distance):
            dx = compute_code_distance(self.hx_perp, is_pcm=False, is_basis=True)
            dz = compute_code_distance(self.hz_perp, is_pcm=False, is_basis=True)
            self.D = min(dx, dz)  # stabilizer-distance proxy, not true distance

        self.name = name if name is not None else f"{name_prefix}_n{self.N}_k{self.K}"

    def _compute_logicals(self):
        """Logical operator bases.

        lz ∈ ker(hx) \\ rowspace(hz); found by row-reducing the stack
        [im(hz^T); ker(hx)] and keeping kernel rows that are pivots
        (reference codes_q.py:62-77).
        """

        def log_ops(ker_rows: np.ndarray, im_rows: np.ndarray) -> np.ndarray:
            stack = np.vstack([im_rows, ker_rows])
            pivots = row_echelon(stack.T)[3]
            cut = im_rows.shape[0]
            keep = [i for i in pivots if i >= cut]
            return stack[keep]

        lx = log_ops(self.hz_perp, self.hx_basis)
        lz = log_ops(self.hx_perp, self.hz_basis)
        return lx.astype(np.uint8), lz.astype(np.uint8)

    def canonical_logicals(self) -> None:
        """Re-basis lx so that ``lx @ lz.T = I`` (reference codes_q.py:79-81)."""
        pairing = (self.lx.astype(np.int64) @ self.lz.T.astype(np.int64)) % 2
        self.lx = (inverse(pairing).astype(np.int64) @ self.lx.astype(np.int64)) % 2
        self.lx = self.lx.astype(np.uint8)

    def __repr__(self) -> str:  # pragma: no cover
        return f"CSSCode(name={self.name!r}, N={self.N}, K={self.K}, D={self.D})"
