"""Bipartite matching and edge coloring (host side).

Used by the SHYPS gauge-measurement scheduler to 3-color the gauge/qubit
incidence graph (capability parity with reference utils.py:517-623; the
matching algorithm here is an integer-indexed iterative Hopcroft–Karp,
structured differently from the reference's dict-based recursive one).
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["hopcroft_karp", "edge_coloring_bipartite"]


def _hopcroft_karp_arrays(neighbors: list[np.ndarray], n_left: int, n_right: int):
    """Maximum matching on an integer-labeled bipartite graph.

    ``neighbors[u]`` lists the right-vertex ids adjacent to left vertex
    ``u``. Returns ``(match_l, match_r)`` int arrays (−1 = unmatched).
    Phases of BFS layering + iterative DFS augmentation; O(E sqrt(V)).
    """
    UNMATCHED = -1
    match_l = np.full(n_left, UNMATCHED, dtype=np.int64)
    match_r = np.full(n_right, UNMATCHED, dtype=np.int64)
    layer = np.empty(n_left, dtype=np.int64)

    while True:
        # BFS from every free left vertex; layer[] = alternating-path depth
        layer.fill(-1)
        frontier = deque(u for u in range(n_left) if match_l[u] == UNMATCHED)
        for u in frontier:
            layer[u] = 0
        found_free_right = False
        while frontier:
            u = frontier.popleft()
            for v in neighbors[u]:
                w = match_r[v]
                if w == UNMATCHED:
                    found_free_right = True
                elif layer[w] == -1:
                    layer[w] = layer[u] + 1
                    frontier.append(w)
        if not found_free_right:
            break

        # iterative layered DFS: augment along length-increasing paths
        edge_cursor = np.zeros(n_left, dtype=np.int64)
        for root in range(n_left):
            if match_l[root] != UNMATCHED:
                continue
            stack = [root]
            while stack:
                u = stack[-1]
                advanced = False
                while edge_cursor[u] < len(neighbors[u]):
                    v = neighbors[u][edge_cursor[u]]
                    edge_cursor[u] += 1
                    w = match_r[v]
                    if w == UNMATCHED:
                        # free right vertex: flip the whole stack's path
                        while stack:
                            uu = stack.pop()
                            vv_prev = match_l[uu]
                            match_l[uu] = v
                            match_r[v] = uu
                            v = vv_prev
                        advanced = True
                        break
                    if layer[w] == layer[u] + 1:
                        stack.append(w)
                        advanced = True
                        break
                if not advanced:
                    layer[u] = -1  # dead end: prune from this phase
                    stack.pop()
    return match_l, match_r


def hopcroft_karp(adj: dict, U, V) -> dict:
    """Maximum bipartite matching; returns {u: v} for matched pairs.

    ``adj[u]`` lists the V-side neighbors of u. Vertex labels can be any
    hashables; they are index-mapped before running the array kernel.
    """
    U = list(U)
    V = list(V)
    u_id = {u: i for i, u in enumerate(U)}
    v_id = {v: i for i, v in enumerate(V)}
    neighbors = [
        np.asarray([v_id[v] for v in adj.get(u, [])], dtype=np.int64) for u in U
    ]
    match_l, _ = _hopcroft_karp_arrays(neighbors, len(U), len(V))
    return {U[i]: V[match_l[i]] for i in range(len(U)) if match_l[i] != -1}


def edge_coloring_bipartite(adj_mat: np.ndarray):
    """Edge-color a bipartite graph by repeated maximum matchings.

    Returns ``(color_dict, num_colors)`` where ``color_dict[c]`` lists the
    (row, col) edges of color ``c``. May use more than Δ colors (greedy).
    """
    adj_mat = np.asarray(adj_mat)
    num_row, num_col = adj_mat.shape
    U = list(range(num_row))
    V = list(range(num_col))
    current = {u: list(np.nonzero(adj_mat[u])[0]) for u in U}
    color_dict: dict[int, list] = {}
    num_colors = 0
    while any(current[u] for u in U):
        matching = hopcroft_karp(current, U, V)
        color_dict[num_colors] = sorted(matching.items())
        for u, v in matching.items():
            current[u].remove(v)
        num_colors += 1
    return color_dict, num_colors
