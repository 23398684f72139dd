#!/usr/bin/env python3
"""Circuit-level parity rows of the PyTorch port, on one CUDA card.

Runs circuit-level rows of ``docs/PARITY.md`` through the port's entry
points, ``harness.circuit_level.sliding_window_decoder`` (BP+OSD-CS-10 a
window, the default knobs) and ``global_decoder`` (the whole DEM), with the
reference's parameters as the JAX package's ``tools/validate_parity.py``
sets them (copied here), and prints one JSON line per row: failures,
flagged, shots, shots/s, the launches of each kernel (the entry point's
warm-up decode included) and whether the failure rate lies within 3 sigma
of the reference's (``utils.metrics.rates_compatible``).

    python3 tools/torch_validate_circuit_level.py
    python3 tools/torch_validate_circuit_level.py --rows global-144,sw-288-w4 --shots 8192

Rows: ``sw-w4``, ``sw-w5`` ([[144]] (W,F) = (4,1), (5,1) at p=0.004),
``sw-p003-w3/w4/w5`` (p=0.003), ``sw-288-w4`` ([[288,12,18]] r=6, W=4,
p=0.005), ``global-144``, ``global-144-shortened`` and ``global-144-p003``
(the whole 936x8784 DEM), and ``sw-xbasis`` (x-basis memory, W=3). Shot
counts default to the JAX tool's (16384; 32768 for the p=0.003 windows,
65536 for ``global-144-p003``); ``--shots`` overrides every row. Seed 7
by default, the JAX tool's. The card's name and power limit are printed
first. Needs a card: without one it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ref(ler_per_round: float, rounds: int, shots: int) -> int:
    """The reference's failures over ``shots`` from its LER per round."""
    return round((1 - (1 - ler_per_round) ** rounds) * shots)


# name -> (entry point, its arguments, default shots, (reference failures,
# reference shots)); from tools/validate_parity.py of the JAX package
ROWS = {
    "sw-w4": ("sw", dict(N=144, p=0.004, num_repeat=12, W=4, F=1), 16384,
              (_ref(1.10e-3, 12, 10000), 10000)),
    "sw-w5": ("sw", dict(N=144, p=0.004, num_repeat=12, W=5, F=1), 16384,
              (_ref(9.0e-4, 12, 10000), 10000)),
    "sw-p003-w3": ("sw", dict(N=144, p=0.003, num_repeat=12, W=3, F=1), 32768,
                   (_ref(2.93e-4, 12, 100000), 100000)),
    "sw-p003-w4": ("sw", dict(N=144, p=0.003, num_repeat=12, W=4, F=1), 32768,
                   (_ref(1.33e-4, 12, 100000), 100000)),
    "sw-p003-w5": ("sw", dict(N=144, p=0.003, num_repeat=12, W=5, F=1), 32768,
                   (_ref(9.92e-5, 12, 100000), 100000)),
    "sw-288-w4": ("sw", dict(N=288, p=0.005, num_repeat=6, W=4, F=1), 16384, (70, 10000)),
    "global-144": ("global", dict(N=144, p=0.004, num_repeat=12), 16384, (76, 10000)),
    "global-144-shortened": ("global", dict(N=144, p=0.004, num_repeat=12, shorten=True),
                             16384, (90, 10000)),
    "global-144-p003": ("global", dict(N=144, p=0.003, num_repeat=12), 65536,
                        (77, 100000)),
    "sw-xbasis": ("sw", dict(N=144, p=0.004, num_repeat=12, W=3, F=1, z_basis=False),
                  16384, (254, 10000)),
}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated row names (default: all ten)")
    ap.add_argument("--shots", type=int, default=None, help="shots per row")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.harness.circuit_level import (
        global_decoder,
        sliding_window_decoder,
    )
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda
    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    counters = {"bp_span": (bp_cuda.bp_span, "launches"),
                "bp_span_pinned": (bp_cuda.bp_span, "pinned_launches"),
                "cn_update": (bp_cuda.cn_update, "launches"),
                "cn_update_pinned": (bp_cuda.cn_update, "pinned_launches"),
                "gauss_jordan_key": (gf2_cuda.gauss_jordan_key, "launches"),
                "gauss_jordan_key_cluster": (gf2_cuda.gauss_jordan_key, "cluster_launches"),
                "osd_cs_fused": (gf2_cuda.osd_cs_fused, "launches"),
                "osd_cs_fused_cluster": (gf2_cuda.osd_cs_fused, "cluster_launches")}
    plain = (bp_cuda.bp_span, bp_cuda.cn_update, gf2_cuda.gauss_jordan_key,
             gf2_cuda.osd_cs_fused)
    for name in args.rows.split(","):
        kind, kw, default_shots, ref = ROWS[name]
        shots = args.shots or default_shots
        run = global_decoder if kind == "global" else sliding_window_decoder
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        plain_before = sum(f.plain_calls for f in plain)
        t0 = time.perf_counter()
        res = run(**kw, num_shots=shots, seed=args.seed, verbose=False, device="cuda")
        wall = time.perf_counter() - t0
        launches = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
        print(json.dumps({
            "row": name, **{k: v for k, v in kw.items()}, "failures": res["num_failed"],
            "flagged": res["num_flagged"], "shots": shots, "ler": res["ler"],
            "ler_per_round": res["ler_per_round"], "ref_failures": ref[0],
            "ref_shots": ref[1], "ref_ler": ref[0] / ref[1],
            "z3_compatible": rates_compatible(res["num_failed"], shots, *ref),
            "decode_seconds": res["decode_seconds"], "shots_per_s": res["shots_per_sec"],
            "wall_with_setup_and_warmup_s": wall, "launches": launches,
            "plain_calls": sum(f.plain_calls for f in plain) - plain_before, "seed": args.seed,
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
