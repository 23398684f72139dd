"""GF(2)[x] / GF(2^m) polynomial helpers used by code constructors.

Capability parity with the reference helpers (codes_q.py:358-556): GF(2)
polynomial gcd / divmod, GF(2^m) log/antilog tables from a primitive
polynomial. Fresh implementations.
"""

from __future__ import annotations

__all__ = [
    "poly_gcd",
    "poly_divmod",
    "multiply_polynomials",
    "generate_log_antilog_tables",
    "get_primitive_polynomial",
    "coeff2poly",
    "poly2coeff",
]


def coeff2poly(coeff) -> list[int]:
    """Exponent list -> dense coefficient list in decreasing degree order."""
    lead = max(coeff)
    poly = [0] * (lead + 1)
    for c in coeff:
        poly[lead - c] = 1
    return poly


def poly2coeff(poly) -> list[int]:
    """Dense decreasing-degree coefficients -> sorted exponent list."""
    l = len(poly) - 1
    return [l - i for i in range(l + 1) if poly[i]][::-1]


def _strip(poly: list[int]) -> list[int]:
    """Remove leading (high-degree) zeros; increasing-degree convention."""
    i = len(poly) - 1
    while i >= 0 and poly[i] == 0:
        i -= 1
    return poly[: i + 1]


def poly_divmod(a, b, p: int = 2):
    """Polynomial division over F_p; coefficients in increasing degree order."""
    a = _strip(list(a))
    b = _strip(list(b))
    if not b:
        raise ZeroDivisionError("polynomial division by zero")
    if len(a) < len(b):
        return [0], (a or [0])
    inv_lead_b = pow(int(b[-1]), p - 2, p)
    q = [0] * (len(a) - len(b) + 1)
    r = a[:]
    while len(r) >= len(b) and any(r):
        factor = (r[-1] * inv_lead_b) % p
        shift = len(r) - len(b)
        q[shift] = factor
        for i in range(len(b)):
            r[shift + i] = (r[shift + i] - factor * b[i]) % p
        r = _strip(r)
    return (_strip(q) or [0]), (r or [0])


def poly_gcd(f_exps, g_exps) -> list[int]:
    """gcd over GF(2) of two polynomials given as exponent lists."""
    # convert decreasing-degree coefficient lists to increasing-degree
    f = coeff2poly(f_exps)[::-1]
    g = coeff2poly(g_exps)[::-1]
    while any(g):
        _, r = poly_divmod(f, g, p=2)
        f, g = g, r
        if g == [0]:
            break
    # back to exponent list
    return [i for i, c in enumerate(f) if c]


def multiply_polynomials(a: int, b: int, m: int, primitive_polynomial: int) -> int:
    """Carry-less multiply of two GF(2^m) elements mod the primitive poly."""
    result = 0
    while b:
        if b & 1:
            result ^= a
        b >>= 1
        a <<= 1
        if a & (1 << m):
            a ^= primitive_polynomial
    return result


def generate_log_antilog_tables(m: int, primitive_polynomial: int):
    """Discrete log / antilog tables for GF(2^m) w.r.t. the generator alpha."""
    gf_size = 2**m
    log_table = [-1] * gf_size
    antilog_table = [0] * gf_size
    alpha = 1
    for i in range(gf_size - 1):
        antilog_table[i] = alpha
        log_table[alpha] = i
        alpha = multiply_polynomials(alpha, 2, m, primitive_polynomial)
    log_table[0] = -1
    return log_table, antilog_table


_CONWAY = {
    2: 0b111,
    3: 0b1011,
    4: 0b10011,
    6: 0b1011011,
    8: 0b100011101,
    9: 0b1000010001,
    10: 0b10001101111,
    12: 0b1000011101011,
    15: 0b1000000000110101,
}


def get_primitive_polynomial(m: int) -> int:
    """Conway polynomial for GF(2^m) (supported m only, like the reference)."""
    try:
        return _CONWAY[m]
    except KeyError:
        raise ValueError(f"unsupported extension degree m={m}") from None
