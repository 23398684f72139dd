from .css import CSSCode
from .constructors import (
    create_circulant_matrix,
    create_generalized_bicycle_codes,
    hypergraph_product,
    hamming_code,
    rep_code,
    create_surface_codes,
    create_rotated_surface_codes,
    create_checkerboard_toric_codes,
    create_cyclic_permuting_matrix,
    create_QC_GHP_codes,
    create_bivariate_bicycle_codes,
    create_2BGA,
    create_cycle_assemble_codes,
    create_EG_codes,
    find_girth,
    read_alist,
    write_alist,
)

# Named bivariate-bicycle instances used throughout the reference experiments
# (osd.py:17-33): N -> constructor arguments.
BB_CODE_PARAMS = {
    72: (6, 6, [3], [1, 2], [1, 2], [3]),
    90: (15, 3, [9], [1, 2], [2, 7], [0]),
    108: (9, 6, [3], [1, 2], [1, 2], [3]),
    144: (12, 6, [3], [1, 2], [1, 2], [3]),
    288: (12, 12, [3], [2, 7], [1, 2], [3]),
    360: (30, 6, [9], [1, 2], [25, 26], [3]),
    756: (21, 18, [3], [10, 17], [3, 19], [5]),
}


def bb_code_by_n(N: int):
    """Build the standard [[N, K]] bivariate-bicycle code by block length."""
    if N not in BB_CODE_PARAMS:
        raise ValueError(f"no registered BB code with N={N}; known: {sorted(BB_CODE_PARAMS)}")
    return create_bivariate_bicycle_codes(*BB_CODE_PARAMS[N])
