#!/usr/bin/env python3
"""Circuit-level parity rows of the PyTorch port, on one CUDA card.

Runs circuit-level rows of ``docs/PARITY.md`` through the port's entry
points, ``harness.circuit_level.sliding_window_decoder`` (BP+OSD-CS-10 a
window, the default knobs), ``global_decoder`` (the whole DEM) and
``sliding_window_gdg`` (GDG a window), with the reference's parameters as
the JAX package's ``tools/validate_parity.py`` sets them (copied here), and
prints one JSON line per row: failures, flagged, shots, shots/s, the
launches of each kernel (the entry point's warm-up decode included;
``bp_span_bf16_ring`` and ``bp_span_pinned_bf16_ring`` count the unmasked
and the masked fused launches that took a bf16 history ring) and whether the failure rate lies within 3 sigma of the reference's
(``utils.metrics.rates_compatible``).

    python3 tools/torch_validate_circuit_level.py
    python3 tools/torch_validate_circuit_level.py --rows global-144,sw-288-w4 --shots 8192
    python3 tools/torch_validate_circuit_level.py --rows gdg-144-w3,gdg-144-52,gdg-288-41,gdg-last-osd

Rows: ``sw-w4``, ``sw-w5`` ([[144]] (W,F) = (4,1), (5,1) at p=0.004),
``sw-p003-w3/w4/w5`` (p=0.003), ``sw-288-w4`` ([[288,12,18]] r=6, W=4,
p=0.005), ``global-144``, ``global-144-shortened`` and ``global-144-p003``
(the whole 936x8784 DEM), ``sw-xbasis`` (x-basis memory, W=3), and the
four GDG rows (SW GDG.ipynb cells f83f0070, d9a942ed, ccb3047b):
``gdg-144-w3`` ([[144]] (3,1), pre-BP 8, the reference's ensemble
defaults), ``gdg-144-52`` ([[144]] (5,2), pre-BP 8, 40 steps, tree 4 /
side 20, branch steps 20), ``gdg-288-41`` ([[288]] (4,1), r=18, pre-BP 16,
60 steps, tree 4 / side 20, branch steps 40) and ``gdg-last-osd`` (the same
on [[288]] r=6, with the last window re-decoded by BP+OSD-CS-10; its line
also gives that count and its verdict against 85/20000), all at p=0.005
with the JAX tool's GDG knobs: bf16 messages and history ring, the
span-compacted ensemble in 512-shot buckets. ``--gdg-f32`` runs the GDG
rows at f32 messages and ring instead, a different configuration, which
the line names. Each GDG line carries the JAX package's count at seed 7
(``docs/parity_results.jsonl``, its TPU runs). Shot counts default to the
JAX tool's (16384; 32768 for the p=0.003 windows, 65536 for
``global-144-p003``, 8192 for the [[144]] GDG rows, 4096 for the [[288]]
ones); ``--shots`` overrides every row. Seed 7 by default, the JAX
tool's. The card's name and power limit are printed first. Needs a card:
without one it exits 2.
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
    "gdg-144-w3": ("gdg", dict(N=144, p=0.005, num_repeat=12, W=3, F=1, max_iter=8), 8192,
                   (_ref(6.92e-3, 12, 5000), 5000)),
    "gdg-144-52": ("gdg", dict(N=144, p=0.005, num_repeat=12, W=5, F=2, max_iter=8,
                               max_step=40, max_tree_depth=4, max_side_depth=20,
                               max_tree_branch_step=20, max_side_branch_step=20), 8192,
                   (_ref(3.18e-3, 12, 5000), 5000)),
    "gdg-288-41": ("gdg", dict(N=288, p=0.005, num_repeat=18, W=4, F=1, max_iter=16,
                               max_step=60, max_tree_depth=4, max_side_depth=20,
                               max_tree_branch_step=40, max_side_branch_step=40), 4096,
                   (_ref(2.0e-3, 18, 5000), 5000)),
    "gdg-last-osd": ("gdg", dict(N=288, p=0.005, num_repeat=6, W=4, F=1, max_iter=16,
                                 max_step=60, max_tree_depth=4, max_side_depth=20,
                                 max_tree_branch_step=40, max_side_branch_step=40,
                                 last_win_osd=True), 4096,
                     (_ref(1.14e-3, 6, 20000), 20000)),
}
# the GDG rows' knobs in the JAX tool (tools/validate_parity.py:88-112),
# its last-window OSD reference (gdg-last-osd), and the JAX package's counts
# at seed 7 (docs/parity_results.jsonl: failures, and with the last-window
# OSD)
GDG_KNOBS = dict(msg_dtype="bfloat16", hist_dtype="bfloat16", ensemble_mode="spans",
                 ensemble_bucket=512)
GDG_OSD_REF = (_ref(7.10e-4, 6, 20000), 20000)
JAX_COUNTS = {"gdg-144-w3": (660, 8192), "gdg-144-52": (354, 8192),
              "gdg-288-41": (152, 4096), "gdg-last-osd": (32, 4096, 20)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated row names (default: all fourteen)")
    ap.add_argument("--shots", type=int, default=None, help="shots per row")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--gdg-f32", action="store_true",
                    help="run the GDG rows at f32 messages and ring (another configuration)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.harness.circuit_level import (
        global_decoder,
        sliding_window_decoder,
        sliding_window_gdg,
    )
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda
    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    counters = {"bp_span": (bp_cuda.bp_span, "launches"),
                "bp_span_pinned": (bp_cuda.bp_span, "pinned_launches"),
                "bp_span_bf16_ring": (bp_cuda.bp_span, "bf16_ring_launches"),
                "bp_span_pinned_bf16_ring": (bp_cuda.bp_span, "pinned_bf16_ring_launches"),
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
        run = {"global": global_decoder, "sw": sliding_window_decoder,
               "gdg": sliding_window_gdg}[kind]
        extra = {}
        if kind == "gdg":
            extra = dict(GDG_KNOBS, **(dict(msg_dtype="float32", hist_dtype="float32")
                                       if args.gdg_f32 else {}))
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        plain_before = sum(f.plain_calls for f in plain)
        t0 = time.perf_counter()
        res = run(**kw, **extra, num_shots=shots, seed=args.seed, verbose=False,
                  device="cuda")
        wall = time.perf_counter() - t0
        launches = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
        if kind == "gdg":
            jax = JAX_COUNTS[name]
            extra.update(configuration="f32 messages and ring (--gdg-f32)" if args.gdg_f32
                         else "the JAX tool's: bf16 messages and ring", jax_failures=jax[0],
                         jax_shots=jax[1], jax_note="the JAX package's TPU run, seed 7")
            if "last_win_osd" in res:
                nfo = res["last_win_osd"]["num_failed"]
                extra.update(last_win_osd_failures=nfo, last_win_osd_ref=GDG_OSD_REF,
                             last_win_osd_z3_compatible=rates_compatible(nfo, shots,
                                                                         *GDG_OSD_REF),
                             jax_last_win_osd_failures=jax[2])
        print(json.dumps({
            "row": name, **{k: v for k, v in kw.items()}, **extra,
            "failures": res["num_failed"],
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
