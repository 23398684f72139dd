"""The binomial test of the statistical LER-parity checks (a copy of
``rates_compatible`` from the JAX package's ``utils/metrics.py``, the one
function of that module the port calls)."""

from __future__ import annotations

import math


def rates_compatible(err_a, shots_a, err_b, shots_b, z: float = 3.0) -> bool:
    """Are two binomial observations consistent (z-sigma two-proportion)?"""
    if shots_a == 0 or shots_b == 0:
        return True
    pa, pb = err_a / shots_a, err_b / shots_b
    pool = (err_a + err_b) / (shots_a + shots_b)
    var = pool * (1 - pool) * (1 / shots_a + 1 / shots_b)
    if var == 0:
        return pa == pb
    return abs(pa - pb) <= z * math.sqrt(var)
