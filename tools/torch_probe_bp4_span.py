#!/usr/bin/env python3
"""Where the time goes inside the fused BP4 kernel (``csrc/bp4_span.cu``), on
one CUDA card.

Builds a probe copy of the checkout's ``bp4_span.cu`` with
``-DBP4_SPAN_CLOCKS`` under ``build/probe_bp4/``: at every barrier thread 0
of each block adds the cycles since the last one to its stage's count, so
each stage is timed up to its slowest thread (the entry's loads; the check,
variable and edge stages; the bookkeeping and the all-done test), summed
over the blocks with their block-iterations. Then, on the ``bp4_run`` calls
of the bp4 rows' [[882]] batch (2048 shots of seed 2024, 100 iterations at
min-sum 0.625), of the same batch on random syndromes (every shot runs all
100 iterations) and of CAMEL's 4096 [[362]] branch lanes (1024 shots, 50
iterations at 0.8; its variable stage waits on the last variable's two
chains of 171 adds), it prints one JSON line each: the package build's
time, the probe's cycles per block-iteration of each stage (one block a
shot) and their shares, and whether the probe's outputs equal the package
build's.

    python3 tools/torch_probe_bp4_span.py

Needs a card: without one it exits 2. The card's name and power limit are
printed first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("entry loads", "check stage", "variable stage", "edge stage", "bookkeeping")
CASES = (("bp4 [[882]] 2048 shots", "bp4_osdcs", 2048, False),
         ("bp4 [[882]] 2048 shots, random syndromes", "bp4_osdcs", 2048, True),
         ("camel [[362]] 4096 lanes", "camel", 1024, False))
SEED = 2024


def build_probe():
    """The probe build's (library, entry point), compiled with the package's
    nvcc flags and -DBP4_SPAN_CLOCKS."""
    from slidingwindowdecoder_torch.ops import bp4_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    out_dir = cuda_build.BUILD_DIR / "probe_bp4"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "bp4_span_clocks.so"
    t0 = time.perf_counter()
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DBP4_SPAN_CLOCKS", "-o",
                    str(lib_path), str(cuda_build.CSRC / bp4_cuda.SOURCE)],
                   check=True, capture_output=True, text=True)
    print(f"[probe] built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.swd_error_string.argtypes = [ctypes.c_int]
    lib.swd_error_string.restype = ctypes.c_char_p
    lib.bp4_span_take_clocks.argtypes = [ctypes.c_void_p]
    lib.bp4_span_take_clocks.restype = ctypes.c_int
    return bp4_cuda.bind(lib)


def time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch_validate_depolarizing import bp4_row_call

    from slidingwindowdecoder_torch.ops import bp4_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    probe = build_probe()
    package = bp4_cuda.bind(cuda_build.load(bp4_cuda.SOURCE))
    clocks = (ctypes.c_ulonglong * 6)()
    for label, kind, shots, random_synd in CASES:
        args, kw = bp4_row_call(kind, shots, SEED, random_synd=random_synd)
        B = args[7].shape[0]
        ms = time_ms(lambda: bp4_cuda.launch(package, *args, **kw))
        ref = bp4_cuda.launch(package, *args, **kw)
        probe[0].bp4_span_take_clocks(clocks)  # zero them
        out = bp4_cuda.launch(probe, *args, **kw)
        torch.cuda.synchronize()
        cuda_build.check(probe[0], probe[0].bp4_span_take_clocks(clocks), "clocks")
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        block_iters = clocks[5]
        per_iter = {name: clocks[k + 1] / max(block_iters, 1)
                    for k, name in enumerate(STAGES[1:])}
        total = sum(clocks[:5])
        print(json.dumps({
            "case": label, "B": B, "ms": ms, "block_iterations": block_iters,
            "iterations_run": int((out[8] - args[13]).max()),
            "cycles_per_block_iteration": per_iter,
            "entry_cycles_per_block": clocks[0] / B,
            "stage_share": {name: clocks[k] / total for k, name in enumerate(STAGES)},
            "probe_equals_package": same}), flush=True)
        if not same:
            raise SystemExit(f"{label}: the probe build's outputs differ from the package's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
