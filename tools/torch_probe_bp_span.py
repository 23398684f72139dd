#!/usr/bin/env python3
"""Where the time goes inside the fused BP kernel's shared-table route
(``csrc/bp_span.cu``), on one CUDA card.

Builds a probe copy of the checkout's ``bp_span.cu`` with
``-DBP_SPAN_CLOCKS`` under ``build/probe_bp_span/``: thread 0 of each block
adds the cycles between consecutive block barriers to the stage that ran
between them (so a stage is timed up to its slowest thread), every warp adds
the cycles it waited at barriers, and the kernel counts its blocks, the
blocks that left at once (every column done at entry) and its
block-iterations; the stage names come from the build
(``bp_span_clock_names``). Then, on the four calls of the paths that the
shared-table route spends most of its time on, captured on the card as
``chip_smoke.py`` captures them:

- the GDG burst: step 4 of the first 512-shot ensemble bucket of window 0
  (p = 0.005, 8192 shots), [35, 224, 11264] f32, masked, ``synd_hat``;
- the BPGD burst: step 3 of the [[882]] code-capacity decode, [2048] f32;
- the post-BP bucket of the shortened ``OSDWindow``: 512 pre-BP survivors
  of window 0 (p = 0.004), 200 masked f32 iterations;
- the flagship's phase-B bucket: 1024 phase-A survivors, 48 unmasked bf16
  iterations;

and, asked for by name, the post-BP bucket's first column alone (``single``:
one block, each stage's floor) and the flagship's phase A (``phasea``: 16384
columns, 16 unmasked bf16 iterations, every column live at entry), it
prints one JSON line each: the package build's time in its in-place form
(CUDA events, each launch on a fresh copy of its inputs, since the kernel
writes them in place) and the profiler's device time, the probe's cycles
per block-iteration of every stage and their shares, the barrier wait's
share, the blocks' own records (the slowest block's cycles, iterations and
live columns; the span from the first block's start to the last block's
end) and whether the probe's outputs equal the package build's.

    python3 tools/torch_probe_bp_span.py [--cases gdg,bpgd,post,phaseb,single,phasea]

Needs a card: without one it exits 2. The card's name and power limit are
printed first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = ("gdg", "bpgd", "post", "phaseb")
# the first column of the post-BP bucket alone (one block, one slot: every
# stage's cost floor a block-iteration), and the flagship's phase A (16384
# columns from fresh messages, 16 unmasked bf16 iterations: every column
# live, many per slot)
EXTRA = ("single", "phasea")


def build_probe():
    """The probe build's library, compiled with the package's nvcc flags
    and -DBP_SPAN_CLOCKS."""
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    out_dir = cuda_build.BUILD_DIR / "probe_bp_span"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "bp_span_clocks.so"
    t0 = time.perf_counter()
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DBP_SPAN_CLOCKS", "-o",
                           str(lib_path), str(cuda_build.CSRC / bp_cuda.SPAN_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"the probe build failed:\n{proc.stdout}{proc.stderr}")
    print(f"[probe] built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    print(json.dumps({"ptxas": [line.strip() for line in proc.stdout.splitlines()
                                if "registers" in line or "spill" in line]}), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.swd_error_string.argtypes = [ctypes.c_int]
    lib.swd_error_string.restype = ctypes.c_char_p
    lib.bp_span_take_clocks.argtypes = [ctypes.c_void_p]
    lib.bp_span_take_clocks.restype = ctypes.c_int
    lib.bp_span_clock_names.restype = ctypes.c_char_p
    lib.bp_span_take_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bp_span_take_blocks.restype = ctypes.c_int
    lib.bp_span_clear_blocks.restype = ctypes.c_int
    return lib


def device_ms(fn, reps: int = 10) -> float:
    """The kernel's device time a launch (``torch.profiler``) over ``reps``
    calls, each on a fresh copy (made outside the profiled window)."""
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
        if "bp_span" in e.key:
            total += (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
            count += e.count
    return total / max(count, 1) / 1e3


def use_library(lib) -> None:
    """Route ``bp_cuda``'s launches through ``lib`` (the probe build or the
    package's)."""
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    cuda_build._loaded[bp_cuda.SPAN_SOURCE] = lib
    bp_cuda._span_entry.cache_clear()


def captured_cases(names):
    """{label: (args, kw)} of the wanted cases, captured on the card."""
    import numpy as np

    import chip_smoke as cs
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.harness.code_capacity import parity_code

    out = {}
    if "gdg" in names:
        _, _, gdem, gplan = build_bb_window_experiment(144, cs.GDG_P, 12, 3, 1)
        gdet, _, _ = sample_dem_numpy(gdem, cs.GDG_SHOTS, np.random.default_rng(cs.SEED))
        _, _, _, args, kw, _ = cs.capture_gdg_burst(gplan, gdet, cs.GDG_BUCKET)
        out["GDG burst"] = (args, kw)
    if "bpgd" in names:
        code = parity_code(882)
        args, kw, _ = cs.capture_bpgd_burst(code, cs.cc_samples(code)[:cs.CC_SHOTS])
        out["BPGD burst"] = (args, kw)
    if "phasea" in names:
        import torch

        from slidingwindowdecoder_torch.decoders import BPOSD
        from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, span_inputs

        _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
        det, _, _ = sample_dem_numpy(dem, cs.REF_SHOTS, np.random.default_rng(cs.SEED))
        spec = plan.windows[0]
        dec = BPOSD(spec.mat, spec.prior, max_iter=200, device="cuda")
        synd = torch.as_tensor(det[:, spec.row_start:spec.row_end], device="cuda")
        B, n = synd.shape[0], spec.mat.shape[1]
        llr = torch.as_tensor(dec.llr, device="cuda")
        out["phase A"] = span_inputs(
            dec.garr, bp_init_messages_sm(dec.garr, llr, B, "bfloat16"), llr, synd,
            torch.zeros((n, 4, B), device="cuda"),
            torch.zeros((B, n), dtype=torch.int8, device="cuda"),
            torch.zeros(B, dtype=torch.bool, device="cuda"),
            torch.zeros(B, dtype=torch.int32, device="cuda"), num_iter=16,
            msg_dtype="bfloat16", history_mode="none", io_layout="slot_major")
    if "post" in names or "phaseb" in names or "single" in names:
        _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
        det, _, _ = sample_dem_numpy(dem, cs.REF_SHOTS, np.random.default_rng(cs.SEED))
        _, cases, _ = cs.flagship_buckets(plan, det, check=False)
        if "post" in names:
            out["post-BP bucket"] = cases["post-BP bucket"]
        if "phaseb" in names:
            out["phase-B bucket"] = cases["phase-B bucket"]
        if "single" in names:
            import torch

            from slidingwindowdecoder_torch.ops.bp import take_columns

            a, kw = cases["post-BP bucket"]
            one = torch.zeros(1, dtype=torch.long, device=a[1].device)
            out["post-BP column alone"] = ((
                a[0], take_columns(a[1], one), a[2], a[3][:, :1], a[4][:, :1],
                None if a[5] is None else a[5][:1], a[6][:, :, :1].contiguous(), a[7][:1],
                a[8][:1], a[9][:1]), kw)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--cases", default=",".join(CASES),
                        help=f"of {','.join(CASES + EXTRA)}")
    names = parser.parse_args().cases.split(",")
    import chip_smoke as cs
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    print(cs.card_line(), flush=True)
    probe = build_probe()
    package = cuda_build.load(bp_cuda.SPAN_SOURCE)
    stages = probe.bp_span_clock_names().decode().split(",")
    clocks = (ctypes.c_ulonglong * len(stages))()
    cases = captured_cases(names)
    for label, (args, kw) in cases.items():
        garr, mv = args[0], args[1]
        B = mv.shape[2]
        route = bp_cuda.span_route(garr, B, mv.dtype)

        def launch(a=args):
            return bp_cuda._launch_span(route, *cs.span_copy(a), **kw, inplace=True)

        use_library(package)
        ms = cs.fresh_time_ms(
            args, lambda a: bp_cuda._launch_span(route, *a, **kw, inplace=True), 10)
        ref = [x.clone() for x in launch()]
        copies = [cs.span_copy(args) for _ in range(5)]
        dev_ms = device_ms(lambda: bp_cuda._launch_span(route, *copies.pop(), **kw,
                                                         inplace=True), 4)
        use_library(probe)
        probe.bp_span_take_clocks(clocks)  # zero them
        cuda_build.check(probe, probe.bp_span_clear_blocks(), "blocks")
        out = launch()
        torch.cuda.synchronize()
        cuda_build.check(probe, probe.bp_span_take_clocks(clocks), "clocks")
        c = dict(zip(stages, clocks))
        nb = int(c["blocks"] + c["blocks left at once"])
        buf = (ctypes.c_ulonglong * (5 * max(nb, 1)))()
        cuda_build.check(probe, probe.bp_span_take_blocks(buf, nb), "blocks")
        records = [tuple(buf[5 * i:5 * i + 5]) for i in range(min(nb, 4096))]
        records = [r for r in records if r[2]]  # the blocks that ran
        use_library(package)
        same = all(torch.equal(x, y) for x, y in zip(out, ref))
        work = stages[:7]
        iters = max(c["block-iterations"], 1)
        blocks = max(c["blocks"], 1)
        total = sum(c[k] for k in work)
        ran = ref[4] - args[9]
        line = {
            "case": label, "B": B, "live": int((~args[8]).sum()), "dtype": str(mv.dtype),
            "num_iter": kw["num_iter"], "shot_iterations": int(ran.sum()),
            "longest": int(ran.max()), "ms": ms, "device_ms": dev_ms,
            "columns_per_block": bp_cuda.shots_per_block(
                garr, B, mv.dtype, torch.cuda.get_device_properties(0).multi_processor_count),
            "blocks": c["blocks"], "blocks_left_at_once": c["blocks left at once"],
            "block_iterations": c["block-iterations"],
            "cycles_per_block_iteration": {k: c[k] / iters for k in work},
            "cycles_per_block": total / blocks,
            "stage_share": {k: c[k] / max(total, 1) for k in work},
            "barrier_wait_share": c["barrier wait"] / max(c["warps"], 1) / max(total / blocks, 1),
            "probe_equals_package": same}
        if records:
            t0 = min(r[0] for r in records)
            slow = max(records, key=lambda r: r[2])
            cyc = [r[2] for r in records]
            line["blocks_seen"] = {
                "span_ms": (max(r[1] for r in records) - t0) / 1e6,
                "last_start_ms": (max(r[0] for r in records) - t0) / 1e6,
                "cycles_max": max(cyc), "cycles_mean": sum(cyc) / len(cyc),
                "slowest": {"cycles": slow[2], "block_iterations": slow[3],
                            "live_columns": slow[4], "start_ms": (slow[0] - t0) / 1e6,
                            "end_ms": (slow[1] - t0) / 1e6}}
        print(json.dumps(line), flush=True)
        if not same:
            raise SystemExit(f"{label}: the probe build's outputs differ from the package's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
