#!/usr/bin/env python3
"""Where the time of a decide-and-peel call goes (``csrc/peel.cu``), on one
CUDA card.

Captures the decide-and-peel calls of ``chip_smoke.py``'s ``[peel]`` phase
on the card (the GDG ensemble's step-4 aggressive decision and guess on a
512-shot bucket x 22 branches, the GDG shortening and the shortened
``OSDWindow`` on window 0 of the seed-2024 samples, BPGD's step 3 on the
[[882]] code) and, for each, at several column counts a block (the
transposed layout's ``MAX_COLS``: 32, 16, 8; the batch-major layout's
``BATCH_MAJOR_COLS``: 1, 2, 4, 8), holds the launch bit-exact against the
plain pair and prints one JSON line: the Python call's time (CUDA events
over 50 calls), the kernel's device time a launch (``torch.profiler``) and
the host time a call (50 calls enqueued, no synchronize between). Then
the host time of one call by part, on the guess: the entry point, the
wrapper alone, its four output allocations, the ctypes launch and the
stream query. The ptxas report of the kernel (registers, spills) comes
first, from a build into a temporary directory.

    python3 tools/torch_probe_peel.py

Needs a card: without one it exits 2. The card's name and power limit are
printed first.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {True: ("MAX_COLS", (32, 16, 8)), False: ("BATCH_MAJOR_COLS", (1, 2, 4, 8))}


def _call(decimation, garr, args, transposed):
    """The captured call as a closure, and its state and decision."""
    state, rest = args[:4], args[4:]
    if len(rest) == 3:
        decision = dict(index=rest[0], value=rest[1], do_set=rest[2])
        fn = decimation.set_index_and_peel_t if transposed else decimation.set_index_and_peel
    else:
        decision = dict(set_mask=rest[0], values=rest[1] if len(rest) > 1 else None)
        fn = decimation.set_values_and_peel_t if transposed else decimation.set_values_and_peel
    return (lambda: fn(garr, *state, *decision.values())), state, decision


def device_ms(fn, reps: int = 30) -> float:
    """The kernel's device time a launch over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if "peel_kernel" in e.key:
            total += (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
            count += e.count
    if count != reps:
        raise SystemExit(f"the profiler saw {count} peel launches in {reps} calls")
    return total / count / 1e3


def host_ms(fn, reps: int = 50) -> float:
    """The host time a call: ``reps`` calls enqueued, then one synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.decoders import bpgd, gdg, osd_window
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        gdg_window_factory,
        window_decoder_factory,
    )
    from slidingwindowdecoder_torch.harness.code_capacity import parity_code, parity_decoder
    from slidingwindowdecoder_torch.ops import decimation, peel_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    print(cs.card_line(), flush=True)
    kept = cuda_build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.BUILD_DIR = Path(tmp)
        cuda_build.build([peel_cuda.SOURCE])
        cuda_build.BUILD_DIR = kept
    print(json.dumps({"ptxas": [line.strip() for line in
                                cuda_build.build_log[peel_cuda.SOURCE].splitlines()
                                if "registers" in line or "spill" in line]}), flush=True)

    _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    det, _, _ = sample_dem_numpy(dem, cs.REF_SHOTS, np.random.default_rng(cs.SEED))
    _, _, gdem, gplan = build_bb_window_experiment(144, cs.GDG_P, 12, 3, 1)
    gdet, _, _ = sample_dem_numpy(gdem, cs.GDG_SHOTS, np.random.default_rng(cs.SEED))
    spec = gplan.windows[0]
    gsynd = torch.as_tensor(gdet[:, spec.row_start:spec.row_end], device="cuda")
    gdec = gdg_window_factory(max_iter=8, ensemble_bucket=cs.GDG_BUCKET, device="cuda")(spec)
    spec = plan.windows[0]
    synd = torch.as_tensor(det[:, spec.row_start:spec.row_end], device="cuda")
    sdec = window_decoder_factory(True, device="cuda")(spec)
    code = parity_code(882)
    bdec = parity_decoder(code, cs.CC_P, "bpgd", {"max_step": 100}, device="cuda")
    bsynd = torch.as_tensor(cs.cc_samples(code)[:cs.CC_SHOTS], device="cuda")
    cases = {
        "GDG aggressive": (True, gdg, "set_values_and_peel_t", cs.PEEL_GDG_CALL,
                           lambda: gdec.core(gsynd)),
        "GDG guess": (True, gdg, "set_index_and_peel_t", cs.PEEL_GDG_CALL,
                      lambda: gdec.core(gsynd)),
        "GDG shortening": (False, gdg, "set_values_and_peel", 0, lambda: gdec.core(gsynd)),
        "shortened": (False, osd_window, "set_values_and_peel", 0, lambda: sdec.core(synd)),
        "BPGD": (False, bpgd, "set_index_and_peel", cs.PEEL_BPGD_CALL,
                 lambda: bdec.core(bsynd)),
    }
    captured = {}
    for name, (transposed, module, attr, index, run) in cases.items():
        garr, args = cs._capture_call(module, attr, index, run)
        fn, state, decision = _call(decimation, garr, args, transposed)
        captured[name] = (transposed, garr, fn, state, decision)
        st = decimation._plain_decision(garr, state, transposed, **decision)
        ref = decimation._peel_loop(garr, *st, transposed=transposed)
        knob, counts = VARIANTS[transposed]
        default = getattr(peel_cuda, knob)
        try:
            for cols in counts:
                setattr(peel_cuda, knob, cols)
                out = fn()
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    raise SystemExit(f"{name}: {cols} columns a block differ from the plain pair")
                print(json.dumps({
                    "case": name, "shape": list(state[0].shape), "cols": cols,
                    "call_ms": cs.cuda_time_ms(fn, 50), "device_ms": device_ms(fn),
                    "host_ms": host_ms(fn)}), flush=True)
        finally:
            setattr(peel_cuda, knob, default)

    transposed, garr, fn, state, decision = captured["GDG guess"]
    vn, cn, deg, dead = state

    def wrapper():
        return peel_cuda.peel_fixpoint(garr, *state, transposed=True, **decision)

    def outputs():
        return [torch.empty_like(t) for t in state]

    lib, launch = peel_cuda._entry()
    out = outputs()
    cn_vn, vn_cn = peel_cuda.peel_tables(garr)
    stream = torch.cuda.current_stream().cuda_stream
    B = vn.shape[1]
    scratch = peel_cuda._scratch_for(vn.device, stream, B)
    stats = peel_cuda.sweep_stats("cuda")
    index = decision["index"].to(torch.int64)

    def ctypes_launch():
        return launch(*(t.data_ptr() for t in (*state, *out)), 2, None, None,
                      index.data_ptr(), decision["value"].data_ptr(),
                      decision["do_set"].data_ptr(), cn_vn.data_ptr(), vn_cn.data_ptr(),
                      garr["n"], garr["m"], garr["m_pad"], garr["dc"], garr["dv"], B, 1,
                      peel_cuda.INT32_MAX, 5, scratch.data_ptr(), stats.data_ptr(), stream)

    def stream_query():
        return torch.cuda.current_stream(vn.device).cuda_stream

    print(json.dumps({"host_ms_by_part": {
        name: host_ms(f, 500) for name, f in (
            ("entry point", fn), ("peel_fixpoint", wrapper), ("4 output allocations", outputs),
            ("ctypes launch", ctypes_launch), ("stream query", stream_query))}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
