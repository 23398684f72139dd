#!/usr/bin/env python3
"""Code-capacity parity rows of the PyTorch port, on one CUDA card.

Runs the eight code-capacity rows of ``docs/PARITY.md`` through the port's
device-resident campaign (``harness.device_campaign.run_cc_campaign_device``)
with the reference's parameters (the JAX package's
``tools/validate_parity.py`` rows cc-* and cc882-*, held in
``harness.code_capacity.PARITY_ROWS``), and prints one JSON
line per row: failures, shots, shots/s and whether the failure rate lies
within 3 sigma of the reference's (``utils.metrics.rates_compatible``).

    python3 tools/torch_validate_code_capacity.py
    python3 tools/torch_validate_code_capacity.py --rows cc-osd0,cc882-bpgd-all \\
        --shots 262144

Rows: [[288,12,18]] BB at p=0.02: BP+OSD-0, BP+OSD-CS-10, GDG; [[882,24]]
QC-GHP (``Misc.ipynb`` cell 10) at p=0.04: BPGD over all VNs, BPGD with
max_step=100, BP+OSD-0, BP+OSD-CS-10, GDG. ``--shots`` overrides every
row's count (default: 1,048,576 on [[288]], 262,144 on [[882]]); batches
of 65536 shots. ``--gdg-mode spans`` runs the GDG rows in the
span-compacted form in place of the host-stepped one (the same results;
for timing the two).
The card's name and power limit are printed first.
Needs a card: without one it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 65536


def main() -> int:
    import torch

    from slidingwindowdecoder_torch.harness.code_capacity import (
        PARITY_ROWS,
        parity_code,
        parity_decoder,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(PARITY_ROWS),
                    help="comma-separated row names (default: all eight)")
    ap.add_argument("--shots", type=int, default=None,
                    help="shots per row (default 1048576 on [[288]], 262144 on [[882]])")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gdg-mode", choices=("host_loop", "spans"), default="host_loop",
                    help="ensemble_mode of the GDG rows (default host_loop)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.harness.device_campaign import run_cc_campaign_device
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
                "osd_cs_fused": (gf2_cuda.osd_cs_fused, "launches")}
    for name in args.rows.split(","):
        N, p, which, ref, overrides = PARITY_ROWS[name]
        if which == "gdg":
            overrides = {**overrides, "ensemble_mode": args.gdg_mode}
        shots = args.shots or (1_048_576 if N == 288 else 262_144)
        code = parity_code(N)
        dec = parity_decoder(code, p, which, overrides)
        t0 = time.perf_counter()
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        res = run_cc_campaign_device(code, p, shots, dec, batch=min(BATCH, shots),
                                     seed=args.seed)
        launches = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
        print(json.dumps({
            "row": name, "N": N, "p": p, **({"gdg_mode": args.gdg_mode} if which == "gdg"
                                            else {}), "failures": res["num_err"],
            "flagged": res["num_flagged"], "shots": res["shots"],
            "ler": res["ler"], "ref_failures": ref[0], "ref_shots": ref[1],
            "ref_ler": ref[0] / ref[1],
            "z3_compatible": rates_compatible(res["num_err"], res["shots"], *ref),
            "seconds": res["seconds"], "shots_per_s": res["shots_per_sec"],
            "wall_with_warmup_s": time.perf_counter() - t0, "launches": launches,
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
