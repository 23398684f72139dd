#!/usr/bin/env python3
"""BP4, CAMEL, phenomenological and SHYPS parity rows of the PyTorch port,
on one CUDA card.

Runs the seven rows of ``docs/PARITY.md`` that go through the port's
depolarizing, phenomenological and SHYPS drivers, with the reference's
parameters as the JAX package's ``tools/validate_parity.py`` sets them
(``ROWS`` and the knobs below; ``chip_smoke.py`` and
``tools/torch_profile_main_path.py`` import them from here), and prints
one JSON line per row:
failures, flagged, shots, shots/s, the launches of each kernel (the driver's warm-up decode
included), the JAX package's count at seed 7 (``docs/parity_results.jsonl``,
its TPU runs) and whether the failure rate lies within 3 sigma of the
reference's (``utils.metrics.rates_compatible``).

    python3 tools/torch_validate_depolarizing.py
    python3 tools/torch_validate_depolarizing.py --rows camel-362,bp4-osdcs --shots 4096

Rows:

- ``camel-362`` (Misc.ipynb cell 8): CAMEL on the [[362]] cycle-assembled
  code, depolarizing p = 0.02, BP4 at min-sum 0.8, 50 iterations, no OSD,
  1024-shot batches (4096 branch lanes);
- ``bp4-osd0`` / ``bp4-osdcs`` (Misc.ipynb cell 2): BP4 + OSD-0 / OSD-CS-10
  per basis on the [[882,24]] QC-GHP code, p = 0.1, min-sum 0.625, 100
  iterations, 2048-shot batches;
- ``phenom-osd`` / ``phenom-gdg`` (Syndrome code.ipynb cell 4):
  ``[hx | I]`` of [[288,12,18]] (144x432), p = 0.03, p_synd = 1e-3:
  BP+OSD-CS-10 at min-sum 0.625, 100 iterations; GDG with the notebook's
  knobs (pre-BP 8, factors 0.625, 40 steps, tree 4 / side 20, branch steps
  30, low-error mode, 256-shot ensemble buckets); 16384-shot batches;
- ``shyps-window`` / ``shyps-global`` (SHYPS.ipynb cells 2-3): the r = 3
  SHYPS code, p = 0.001, 4 rounds, BP+OSD-CS over the k weight-1
  candidates (``osd_order=0``), 1000 iterations; (W, F) = (3, 1) windows
  or the whole DEM.

Shot counts default to the JAX runs' (32768, or 65536 for phenom-osd,
16384 for the SHYPS rows); ``--shots`` overrides every row. Seed 7 by
default, the JAX tool's. The card's name and power limit are printed
first. Needs a card: without one it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _shyps_ref(ler_per_round: float, shots: int = 20000) -> tuple[int, int]:
    """The reference's (failures, shots) from its LER per round over 4 rounds."""
    return round((1 - (1 - ler_per_round) ** 4) * shots), shots


# name -> (runner, default shots, (reference failures, shots), the JAX
# package's failures at seed 7 and its shots)
ROWS = {
    "camel-362": ("camel", 32768, (26, 100_000), (12, 32768)),
    "bp4-osd0": ("bp4_osd0", 32768, (77, 100_000), (25, 32768)),
    "bp4-osdcs": ("bp4_osdcs", 32768, (22, 100_000), (4, 32768)),
    "phenom-osd": ("phenom_osd", 65536, (20200, 1_000_000), (1268, 65536)),
    "phenom-gdg": ("phenom_gdg", 32768, (1360, 1_000_000), (34, 32768)),
    "shyps-window": ("shyps_window", 16384, _shyps_ref(2.13e-3), (128, 16384)),
    "shyps-global": ("shyps_global", 16384, _shyps_ref(2.35e-3), (126, 16384)),
}

# the depolarizing rows: p, the ``BP4OSD`` knobs, CAMEL or not, and the
# driver's batch (CAMEL decodes 4 branch lanes a shot)
BP4_ROWS = {
    "camel": (0.02, dict(max_iter=50, ms_scaling_factor=0.8, osd_method="off", osd_order=0),
              True, 1024),
    "bp4_osd0": (0.1, dict(max_iter=100, ms_scaling_factor=0.625, osd_method="osd_0",
                           osd_order=0), False, 2048),
    "bp4_osdcs": (0.1, dict(max_iter=100, ms_scaling_factor=0.625, osd_method="osd_cs",
                            osd_order=10), False, 2048),
}
# the phenomenological rows: (p, p_synd), the decoders' knobs, the batch
PHENOM_P = (0.03, 1e-3)
PHENOM_OSD_KNOBS = dict(max_iter=100, ms_scaling_factor=0.625, osd_method="osd_cs",
                        osd_order=10)
PHENOM_GDG_KNOBS = dict(max_iter=8, ms_scaling_factor=0.625, gdg_factor=0.625,
                        max_iter_per_step=6, max_step=40, max_tree_depth=4,
                        max_side_depth=20, max_side_branch_step=30,
                        max_tree_branch_step=30, low_error_mode=True, ensemble_bucket=256)
PHENOM_BATCH = 16384
# the SHYPS rows' ``decode_shyps`` arguments (but the window form's flag)
SHYPS_KNOBS = dict(r=3, p=0.001, num_repeat=4, max_iter=1000, osd_order=0, W=3, F=1)


def row_code(kind: str):
    """The code of a depolarizing or phenomenological row: the [[362]]
    cycle-assembled code (CAMEL), the [[882,24]] QC-GHP code (bp4) or the
    [[288,12,18]] BB code (phenom)."""
    from slidingwindowdecoder_torch.codes import (
        bb_code_by_n,
        create_cycle_assemble_codes,
        create_cyclic_permuting_matrix,
        create_QC_GHP_codes,
    )

    if kind == "camel":
        return create_cycle_assemble_codes(19, 3)
    if kind.startswith("bp4"):
        return create_QC_GHP_codes(63, create_cyclic_permuting_matrix(7, [27, 54, 0]),
                                   [0, 1, 6])
    return bb_code_by_n(288)[0]


def bp4_row_decoder(kind: str, device=None):
    """The ``BP4OSD`` that ``depolarizing_decoding`` builds for a
    depolarizing row (uniform p/3 priors)."""
    from slidingwindowdecoder_torch.decoders import BP4OSD

    code = row_code(kind)
    p, knobs, _, _ = BP4_ROWS[kind]
    probs = np.full(code.N, p / 3)
    return BP4OSD(code.hx, code.hz, channel_probs_x=probs, channel_probs_y=probs,
                  channel_probs_z=probs, device=device, **knobs)


def phenom_row_decoder(kind: str, pcm, priors, device=None):
    """The decoder of a phenomenological row on ``[hx | I]``."""
    from slidingwindowdecoder_torch.decoders import BPOSD, GDG

    if kind == "phenom_osd":
        return BPOSD(pcm, priors, device=device, **PHENOM_OSD_KNOBS)
    return GDG(pcm, priors, device=device, **PHENOM_GDG_KNOBS)


def bp4_row_call(kind: str, shots: int, seed: int, random_synd: bool = False):
    """The ``bp4_run`` arguments (a list) and keywords of one decode by a
    depolarizing row's decoder on the card (``bp4_row_decoder``): ``core``
    (the bp4 rows) or ``camel_core`` (CAMEL: 4 branch lanes a shot) on
    ``shots`` depolarizing samples of ``seed`` (the row's first batch at
    that seed), or on uniformly random syndromes, which BP4 converges on
    none of. The messages are the decode's stride-0 views over the batch."""
    import torch

    from slidingwindowdecoder_torch.decoders import bp4 as bp4_decoder
    from slidingwindowdecoder_torch.harness.depolarizing import sample_depolarizing

    code, (p, _, camel, _) = row_code(kind), BP4_ROWS[kind]
    dec = bp4_row_decoder(kind, "cuda")
    rng = np.random.default_rng(seed)
    ex, ez = sample_depolarizing(code.N, p, shots, rng)
    sx, sz = (ez.astype(np.int64) @ code.hx.T) % 2, (ex.astype(np.int64) @ code.hz.T) % 2
    if random_synd:
        sx, sz = rng.integers(0, 2, sx.shape), rng.integers(0, 2, sz.shape)
    calls = []
    orig = bp4_decoder.bp4_run
    bp4_decoder.bp4_run = lambda *a, **k: calls.append((list(a), k)) or orig(*a, **k)
    try:
        (dec.camel_core if camel else dec.core)(
            *(torch.as_tensor(x.astype(np.uint8), device="cuda") for x in (sx, sz)))
    finally:
        bp4_decoder.bp4_run = orig
    (args, kw), = calls
    return args, kw


def run_row(kind: str, shots: int, seed: int, device=None) -> dict:
    """One row through the port's driver on ``device`` (None means
    "cuda"): {"failures", "flagged", "shots", "seconds", "shots_per_s"}
    (``seconds`` as the driver times it; no flags on the phenomenological
    rows, whose driver counts none)."""
    from slidingwindowdecoder_torch.harness.depolarizing import depolarizing_decoding
    from slidingwindowdecoder_torch.harness.phenomenological import decode_phenomenological
    from slidingwindowdecoder_torch.harness.shyps import decode_shyps

    if kind in BP4_ROWS:
        p, knobs, camel, batch = BP4_ROWS[kind]
        r = depolarizing_decoding(row_code(kind), p, shots, camel=camel, batch_size=batch,
                                  seed=seed, verbose=False, device=device, **knobs)
    elif kind.startswith("phenom"):
        r = decode_phenomenological(
            row_code(kind), *PHENOM_P, shots,
            {"d": lambda pcm, pr: phenom_row_decoder(kind, pcm, pr, device)},
            batch_size=PHENOM_BATCH, seed=seed, verbose=False)["d"]
        r["num_flagged"] = None
    else:
        r = decode_shyps(num_shots=shots, window=kind == "shyps_window", seed=seed,
                         verbose=False, device=device, **SHYPS_KNOBS)
        r = {"num_err": r["num_failed"], "num_flagged": r["num_flagged"], "shots": shots,
             "seconds": r["seconds"], "shots_per_sec": r["shots_per_sec"]}
    return {"failures": r["num_err"], "flagged": r["num_flagged"], "shots": r["shots"],
            "seconds": r["seconds"], "shots_per_s": r["shots_per_sec"]}



def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names (default: all seven)")
    ap.add_argument("--shots", type=int, default=None, help="shots per row")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.ops import bp4_cuda, bp_cuda, gf2_cuda
    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    counters = {"bp_span": (bp_cuda.bp_span, "launches"),
                "bp_span_pinned": (bp_cuda.bp_span, "pinned_launches"),
                "bp_span_wide": (bp_cuda.bp_span, "wide_launches"),
                "bp_span_wide_pinned": (bp_cuda.bp_span, "pinned_wide_launches"),
                "cn_update": (bp_cuda.cn_update, "launches"),
                "cn_update_pinned": (bp_cuda.cn_update, "pinned_launches"),
                "gauss_jordan_key": (gf2_cuda.gauss_jordan_key, "launches"),
                "osd_cs_fused": (gf2_cuda.osd_cs_fused, "launches"),
                "gauss_jordan_key_cluster": (gf2_cuda.gauss_jordan_key, "cluster_launches"),
                "osd_cs_fused_cluster": (gf2_cuda.osd_cs_fused, "cluster_launches"),
                "bp4_span": (bp4_cuda.bp4_span, "launches")}
    plain = (bp_cuda.cn_update, bp_cuda.bp_span, gf2_cuda.gauss_jordan_key,
             gf2_cuda.osd_cs_fused, bp4_cuda.bp4_span)
    for name in args.rows.split(",") if args.rows else ROWS:
        kind, default_shots, ref, jax_count = ROWS[name]
        shots = args.shots or default_shots
        t0 = time.perf_counter()
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        plain_before = sum(f.plain_calls for f in plain)
        with contextlib.redirect_stdout(sys.stderr):
            res = run_row(kind, shots, args.seed)
        launches = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
        print(json.dumps({
            "row": name, **res, "ler": res["failures"] / res["shots"],
            "ref_failures": ref[0], "ref_shots": ref[1], "ref_ler": ref[0] / ref[1],
            "z3_compatible": rates_compatible(res["failures"], res["shots"], *ref),
            "jax_failures_seed7": jax_count[0], "jax_shots": jax_count[1],
            "wall_with_warmup_s": time.perf_counter() - t0,
            "launches": {k: v for k, v in launches.items() if v},
            "plain_calls": sum(f.plain_calls for f in plain) - plain_before,
            "seed": args.seed, "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
