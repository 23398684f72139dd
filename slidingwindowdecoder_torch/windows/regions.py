"""Spatially-coupled column regrouping and window extraction.

Re-implements the reference's sliding-window preprocessing
(osd.py:44-121, identical in the notebooks):

1. *Column regrouping*: every DEM fault column is assigned to the
   (round-aligned) detector-row region it touches — either one half-block
   (n_half rows) or two consecutive half-blocks — and columns are permuted
   into block-staircase order (regions enumerated bottom-up by the
   interleaving (0,h), (0,2h), (h,2h), (h,3h), ... as in osd.py:45-52).
2. *Anchors*: the staircase corner (row, col) of each round boundary
   (osd.py:70-77).
3. *(W, F) window extraction*: window i covers W rounds of detector rows;
   its decode matrix is the chk sub-block up to the cut ``c`` plus, for
   non-final windows with method != 0, an identity block of "virtual
   noisy-syndrome" columns on the last n_half rows whose prior is the
   summed prior of the merged tail columns (osd.py:79-113).

All host-side numpy; outputs are static per-experiment specs that the
batched pipeline consumes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SlidingWindowPlan:
    chk: np.ndarray  # [R, C] regrouped check matrix (uint8)
    obs: np.ndarray  # [O, C] regrouped observables matrix
    priors: np.ndarray  # [C]
    column_perm: np.ndarray  # regrouped col j = original DEM col column_perm[j]
    anchors: list[tuple[int, int]]
    W: int
    F: int
    n_half: int
    windows: list["WindowSpec"]

    @property
    def num_windows(self) -> int:
        return len(self.windows)


@dataclass
class WindowSpec:
    index: int
    row_start: int
    row_end: int
    col_start: int
    col_end: int  # end of real decode columns (the cut c, or b for last)
    commit_col_end: int  # real columns committed from this window
    is_last: bool
    mat: np.ndarray  # [rows, cols (+ n_half virtual)] decode matrix
    prior: np.ndarray  # matching per-column priors
    num_virtual: int  # virtual noisy-syndrome columns appended

    @property
    def shape(self):
        return self.mat.shape


def regroup_columns(chk, obs, priors, n_half: int):
    """Permute DEM columns into the block-staircase region order."""
    chk = np.asarray(chk)
    obs = np.asarray(obs)
    priors = np.asarray(priors)
    num_row, num_col = chk.shape

    region_index: dict[tuple[int, int], int] = {}
    i = 0
    while i < num_row:
        region_index.setdefault((i, i + n_half), len(region_index))
        if i + 2 * n_half > num_row:
            break
        region_index.setdefault((i, i + 2 * n_half), len(region_index))
        i += n_half

    region_cols: list[list[int]] = [[] for _ in range(len(region_index))]
    row_of_col_min = np.full(num_col, num_row, dtype=np.int64)
    row_of_col_max = np.full(num_col, -1, dtype=np.int64)
    rows, cols = np.nonzero(chk)
    np.minimum.at(row_of_col_min, cols, rows)
    np.maximum.at(row_of_col_max, cols, rows)
    for j in range(num_col):
        lo = (row_of_col_min[j] // n_half) * n_half
        hi = (row_of_col_max[j] // n_half + 1) * n_half
        key = (int(lo), int(hi))
        if key not in region_index:
            raise ValueError(
                f"DEM column {j} spans rows {key}, more than two half-rounds; "
                "not a sliding-window-compatible detector structure"
            )
        region_cols[region_index[key]].append(j)

    perm = np.concatenate([np.asarray(c, dtype=np.int64) for c in region_cols if True])
    return chk[:, perm], obs[:, perm], priors[perm], perm


def find_anchors(chk, n_half: int) -> list[tuple[int, int]]:
    """Staircase corners: (row, col) where each round's column block begins."""
    num_row, num_col = chk.shape
    anchors = []
    j = 0
    rows, cols = np.nonzero(chk)
    col_min = np.full(num_col, num_row, dtype=np.int64)
    np.minimum.at(col_min, cols, rows)
    for i in range(num_col):
        if col_min[i] >= j:
            anchors.append((j, i))
            j += n_half
    anchors.append((num_row, num_col))
    return anchors


def build_sliding_window_plan(
    chk,
    obs,
    priors,
    n_half: int,
    W: int,
    F: int,
    *,
    method: int = 1,
    z_basis: bool = True,
    noisy_prior: np.ndarray | None = None,
    code_n: int | None = None,
) -> SlidingWindowPlan:
    """Full preprocessing: regroup, anchor, extract window specs.

    ``method`` semantics follow osd.py:79-113: 0 = no virtual columns (each
    window sees all its columns), 1 = cut shifted by 3*n_half (z basis) or
    n (x basis) before merging the tail into virtual noisy-syndrome
    columns, 2 = unshifted cut.
    """
    chk_g, obs_g, priors_g, perm = regroup_columns(chk, obs, priors, n_half)
    anchors = find_anchors(chk_g, n_half)
    num_row, num_col = chk_g.shape
    n = code_n if code_n is not None else 2 * n_half

    def shifted_cut(c: tuple[int, int]) -> tuple[int, int]:
        if method == 1:
            return (c[0], c[1] + (3 * n_half if z_basis else n))
        return c

    if noisy_prior is None and method != 0:
        b = anchors[W]
        c = shifted_cut(anchors[W - 1])
        noisy_prior = np.asarray(
            (chk_g[c[0] : b[0], c[1] : b[1]] * priors_g[c[1] : b[1]]).sum(axis=1)
        )

    num_win = int(np.ceil((len(anchors) - W + F - 1) / F))
    windows: list[WindowSpec] = []
    top_left = 0
    for i in range(num_win):
        a = anchors[top_left]
        bottom_right = min(top_left + W, len(anchors) - 1)
        b = anchors[bottom_right]
        is_last = i == num_win - 1
        commit = anchors[min(top_left + F, len(anchors) - 1)]

        if not is_last and method != 0:
            c = shifted_cut(anchors[top_left + W - 1])
            mat = chk_g[a[0] : b[0], a[1] : c[1]]
            rows_in_win = b[0] - a[0]
            virt = np.zeros((rows_in_win, n_half), dtype=chk_g.dtype)
            virt[-n_half:, :] = np.eye(n_half, dtype=chk_g.dtype)
            mat = np.hstack([mat, virt])
            prior = np.concatenate([priors_g[a[1] : c[1]], np.asarray(noisy_prior)])
            col_end = c[1]
            num_virtual = n_half
        else:
            mat = chk_g[a[0] : b[0], a[1] : b[1]]
            prior = priors_g[a[1] : b[1]]
            col_end = b[1]
            num_virtual = 0

        commit_col_end = b[1] if is_last else commit[1]
        if commit_col_end > col_end:
            raise ValueError(
                f"window {i}: commit region (cols up to {commit_col_end}) "
                f"extends past the decode cut ({col_end}); with method="
                f"{method} the commit width F={F} must satisfy F < W "
                "(use method=0 to decode full windows, or reduce F)"
            )
        windows.append(
            WindowSpec(
                index=i,
                row_start=a[0],
                row_end=b[0],
                col_start=a[1],
                col_end=col_end,
                commit_col_end=commit_col_end,
                is_last=is_last,
                mat=np.ascontiguousarray(mat),
                prior=prior,
                num_virtual=num_virtual,
            )
        )
        top_left += F

    return SlidingWindowPlan(
        chk=chk_g,
        obs=obs_g,
        priors=priors_g,
        column_perm=perm,
        anchors=anchors,
        W=W,
        F=F,
        n_half=n_half,
        windows=windows,
    )
