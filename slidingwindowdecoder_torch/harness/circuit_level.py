"""Circuit-level sliding-window experiment set-up.

Builds the BB code + syndrome circuit, compiles the DEM and extracts the
(W, F) window plan — the host-side set-up of the reference's
``sliding_window_decoder`` (osd.py:15-121). Decoding runs through
``windows.pipeline`` with ``decoders.BPOSD``.
"""

from __future__ import annotations

from ..codes import bb_code_by_n
from ..circuits import build_bb_memory_circuit, compile_dem
from ..windows.regions import build_sliding_window_plan


def build_bb_window_experiment(
    N: int,
    p: float,
    num_repeat: int,
    W: int,
    F: int,
    *,
    method: int = 1,
    z_basis: bool = True,
):
    """Code + circuit + DEM + window plan for a BB memory experiment."""
    code, A_list, B_list = bb_code_by_n(N)
    circuit = build_bb_memory_circuit(
        code, A_list, B_list, p, num_repeat, z_basis=z_basis
    )
    dem = compile_dem(circuit)
    plan = build_sliding_window_plan(
        dem.chk,
        dem.obs,
        dem.priors,
        n_half=code.N // 2,
        W=W,
        F=F,
        method=method,
        z_basis=z_basis,
        code_n=code.N,
    )
    return code, circuit, dem, plan
