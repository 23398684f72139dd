"""The (W, F) window plan, worked out again for the reference.

A frozen copy of ``slidingwindowdecoder_torch/windows/regions.py`` at
commit 6c64bcc (``regroup_columns``, ``find_anchors``,
``build_sliding_window_plan``), trimmed to the z basis: the DEM's columns
regrouped into block-staircase order, the round anchors, and per window
its rows, its decode matrix (with ``n_half`` virtual noisy-syndrome
columns on non-final windows, method 1) and the columns it commits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Window:
    row_start: int
    row_end: int
    col_start: int
    commit_col_end: int
    is_last: bool
    mat: np.ndarray
    prior: np.ndarray


@dataclass
class Plan:
    chk: np.ndarray  # [R, C] regrouped
    obs: np.ndarray  # [O, C] regrouped
    windows: list


def _regroup(chk, obs, priors, n_half: int):
    num_row, num_col = chk.shape
    region_index: dict = {}
    i = 0
    while i < num_row:
        region_index.setdefault((i, i + n_half), len(region_index))
        if i + 2 * n_half > num_row:
            break
        region_index.setdefault((i, i + 2 * n_half), len(region_index))
        i += n_half
    region_cols = [[] for _ in range(len(region_index))]
    lo_row = np.full(num_col, num_row, dtype=np.int64)
    hi_row = np.full(num_col, -1, dtype=np.int64)
    rows, cols = np.nonzero(chk)
    np.minimum.at(lo_row, cols, rows)
    np.maximum.at(hi_row, cols, rows)
    for j in range(num_col):
        key = (int((lo_row[j] // n_half) * n_half), int((hi_row[j] // n_half + 1) * n_half))
        region_cols[region_index[key]].append(j)
    perm = np.concatenate([np.asarray(c, dtype=np.int64) for c in region_cols])
    return chk[:, perm], obs[:, perm], priors[perm]


def _anchors(chk, n_half: int):
    num_row, num_col = chk.shape
    rows, cols = np.nonzero(chk)
    col_min = np.full(num_col, num_row, dtype=np.int64)
    np.minimum.at(col_min, cols, rows)
    anchors, j = [], 0
    for i in range(num_col):
        if col_min[i] >= j:
            anchors.append((j, i))
            j += n_half
    anchors.append((num_row, num_col))
    return anchors


def build_plan(chk, obs, priors, n_half: int, W: int, F: int) -> Plan:
    """The window plan of method 1 in the z basis: each non-final window's
    cut shifted by 3 * n_half columns and the tail merged into virtual
    columns whose prior is the summed prior of the merged tail."""
    chk_g, obs_g, priors_g = _regroup(np.asarray(chk), np.asarray(obs), np.asarray(priors),
                                      n_half)
    anchors = _anchors(chk_g, n_half)

    def cut(a):
        return (a[0], a[1] + 3 * n_half)

    b, c = anchors[W], cut(anchors[W - 1])
    noisy_prior = (chk_g[c[0]:b[0], c[1]:b[1]] * priors_g[c[1]:b[1]]).sum(axis=1)
    num_win = int(np.ceil((len(anchors) - W + F - 1) / F))
    windows, top = [], 0
    for i in range(num_win):
        a = anchors[top]
        b = anchors[min(top + W, len(anchors) - 1)]
        last = i == num_win - 1
        if not last:
            c = cut(anchors[top + W - 1])
            virt = np.zeros((b[0] - a[0], n_half), dtype=chk_g.dtype)
            virt[-n_half:] = np.eye(n_half, dtype=chk_g.dtype)
            mat = np.hstack([chk_g[a[0]:b[0], a[1]:c[1]], virt])
            prior = np.concatenate([priors_g[a[1]:c[1]], noisy_prior])
        else:
            mat = chk_g[a[0]:b[0], a[1]:b[1]]
            prior = priors_g[a[1]:b[1]]
        commit = b[1] if last else anchors[min(top + F, len(anchors) - 1)][1]
        windows.append(Window(row_start=a[0], row_end=b[0], col_start=a[1],
                              commit_col_end=commit, is_last=last,
                              mat=np.ascontiguousarray(mat), prior=prior))
        top += F
    return Plan(chk=chk_g, obs=obs_g, windows=windows)
