#!/usr/bin/env python3
"""Where one shot's time goes in kernel B's cluster route (one CUDA card).

Builds a probe copy of the checkout's ``gauss_jordan.cu`` with ``clock64``
timers written into the cluster kernel at fixed places of its text
(``ANCHORS``), and runs it on the first OSD bucket of the [[144]] global
decode (936x8784, BP+OSD-CS-10 with the bench knobs, bf16, seed 2024) and
of a [[288]] W=4 interior window (576x4896, its window-1 detectors decoded
by ``sliding_window_decoder``'s BP+OSD-CS-10, seed 2024): the buckets
``chip_smoke.py``'s ``[gj_cluster]`` takes. The shipped kernel has no
switch for this; the probe copy is built under ``build/probe`` and used
only here and by ``chip_smoke.py`` (``build_probe``, ``probe_split``,
``max_active``).

    python3 tools/torch_probe_gj_cluster.py [--reps N]

Thread 0 of every block sums the cycles of each phase of its own timeline
(a barrier's wait counts in the phase that ends at it) and the rounds, dead
rounds and steps; the sums over the blocks come back as means per block.
The probe copy also answers how many clusters of its kernel the card runs
at once (``max_active``). The tool also prints both entry points' times on
the shipped build (CUDA events), and checks the probe build's outputs
against the plain versions.

Prints one JSON line per bucket and entry point.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED = 2024
# phase names, in the order of the probe's counters
PHASES = ("load", "test", "cluster_sync", "decide", "pull", "xor", "elimination",
          "sweep_setup", "sweep", "finish", "total")
COUNTS = ("rounds", "dead_rounds", "steps")

_PRELUDE = r"""
__device__ unsigned long long swd_probe_acc[32];
#define PROBE_T() clock64()
"""

_EPILOGUE = r"""
extern "C" int swd_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, swd_probe_acc, sizeof(unsigned long long) * 32);
}
extern "C" int swd_probe_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(swd_probe_acc, z, sizeof(z));
}
// The most C-block clusters of the probe kernel the card runs at once at
// this shape, with the shipped launch's choice of template (a negative
// CUDA error code on failure).
template <bool FUSED, int KW>
static int swd_probe_active_kw(int C, size_t smem) {
  void (*kern)(const Args) = gj_cluster_kernel<FUSED, KW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  return err != cudaSuccess ? -(int)err : clusters;
}
template <bool FUSED>
static int swd_probe_active(int m, int n, int W, int C) {
  const size_t smem = make_cluster_layout(m, n, W, C, FUSED).total;
  const int R = cluster_rows(m, C);
  return R <= 128   ? swd_probe_active_kw<FUSED, 4>(C, smem)
         : R <= 256 ? swd_probe_active_kw<FUSED, 8>(C, smem)
                    : swd_probe_active_kw<FUSED, 16>(C, smem);
}
extern "C" int swd_probe_max_active(int m, int n, int W, int C, int fused) {
  return fused ? swd_probe_active<true>(m, n, W, C) : swd_probe_active<false>(m, n, W, C);
}
"""

# per-block sums, kept by thread 0 in registers; index = position in
# PHASES, then COUNTS
_DECLS = ("  unsigned long long pr_acc[%d] = {0};\n  long long pr_t = PROBE_T(), pr_t0 = pr_t;\n"
          "  auto pr_mark = [&](int k) { const long long t = PROBE_T(); pr_acc[k] += t - pr_t; "
          "pr_t = t; };\n" % (len(PHASES) + len(COUNTS)))
_FLUSH = ("  if (threadIdx.x == 0) {\n    pr_acc[%d] = PROBE_T() - pr_t0;\n"
          "    for (int k = 0; k < %d; ++k) atomicAdd(&swd_probe_acc[k], pr_acc[k]);\n  }\n"
          % (PHASES.index("total"), len(PHASES) + len(COUNTS)))


def _p(name):
    return PHASES.index(name)


def _c(name):
    return len(PHASES) + COUNTS.index(name)


# (anchor, replacement) pairs in the cluster kernel's text; each anchor must
# occur exactly once in that kernel. (LINE, text, (before, after)) puts
# ``before`` and ``after`` around the one line holding ``text``. They follow
# the kernel's text: an edit to ``gj_cluster_kernel`` that moves one of them
# must update this list.
LINE = "line"
ANCHORS = [
    ("  extern __shared__ __align__(16) unsigned char smem[];\n  cg::cluster_group cluster",
     "  extern __shared__ __align__(16) unsigned char smem[];\n" + _DECLS
     + "  cg::cluster_group cluster"),
    ("  int pos = 0, r = 0, round = 0;\n  while (r < rank && pos < n) {\n",
     f"  pr_mark({_p('load')});\n  const long long pr_e0 = pr_t;\n"
     "  int pos = 0, r = 0, round = 0;\n  while (r < rank && pos < n) {\n"
     f"    pr_acc[{_c('rounds')}] += 1;\n"),
    # the round's wait for every block's posts
    (LINE, "// every block's posts of this round are in every block",
     (f"    pr_mark({_p('test')});\n", f"    pr_mark({_p('cluster_sync')});\n")),
    ("    if (!any) {  // every candidate of this round is dead in every block\n",
     f"    pr_mark({_p('decide')});\n"
     "    if (!any) {  // every candidate of this round is dead in every block\n"
     f"      pr_acc[{_c('dead_rounds')}] += 1;\n"),
    # the pivot row's pull ends where the warp's first holding row begins
    (LINE, "for (int t = warp; t < total; t += kWarps) {",
     (f"      pr_mark({_p('pull')});\n", "")),
    ("    ++r;\n    pos += win + 1;\n    __syncthreads();\n  }\n",
     f"    ++r;\n    pos += win + 1;\n    __syncthreads();\n    pr_mark({_p('xor')});\n"
     f"    pr_acc[{_c('steps')}] += 1;\n  }}\n"
     f"  pr_acc[{_p('elimination')}] += PROBE_T() - pr_e0;\n  pr_t = PROBE_T();\n"),
    ("  if (!FUSED) {\n    uint32_t* out = a.state_out + ((long long)b * m + r0) * Wp1;",
     f"  if (!FUSED) {{\n    pr_mark({_p('finish')});\n"
     "    uint32_t* out = a.state_out + ((long long)b * m + r0) * Wp1;"),
    ("    cluster.sync();  // no block leaves while block 0 reads it\n    return;\n",
     "    cluster.sync();  // no block leaves while block 0 reads it\n"
     f"    pr_mark({_p('finish')});\n" + _FLUSH.replace("\n  ", "\n    ") + "    return;\n"),
    ("  // a_j and the Gram terms, pipelined: at stage s block q continues block\n",
     f"  pr_mark({_p('sweep_setup')});\n"
     "  // a_j and the Gram terms, pipelined: at stage s block q continues block\n"),
    ("  if (q == last) {  // the winner, as gj_kernel picks it\n",
     f"  pr_mark({_p('sweep')});\n  if (q == last) {{  // the winner, as gj_kernel picks it\n"),
    (LINE, "if (q == last) store_solution", ("", f"  pr_mark({_p('finish')});\n" + _FLUSH)),
]


def instrument(text: str) -> str:
    """The probe copy of ``text``: the anchors replaced in the cluster
    kernel's body (from its signature to the next launch helper), the
    counters, their read-out functions and the occupancy query added."""
    head, sep, body = text.partition("gj_cluster_kernel(const Args a) {")
    if not sep:
        raise SystemExit("no gj_cluster_kernel in the source")
    end = body.index("\ntemplate <bool FUSED, int KW>\nint launch_kw")
    kern, rest = body[:end], body[end:]
    for anchor, *repl in ANCHORS:
        if anchor == LINE:
            text_, (before, after) = repl
            lines = kern.split("\n")
            hits = [i for i, ln in enumerate(lines) if text_ in ln]
            if len(hits) != 1:
                raise SystemExit(f"line found {len(hits)} times, want 1:\n{text_}")
            i = hits[0]
            lines[i] = before + lines[i] + ("\n" + after.rstrip("\n") if after else "")
            kern = "\n".join(lines)
            continue
        if kern.count(anchor) != 1:
            raise SystemExit(f"anchor found {kern.count(anchor)} times, want 1:\n{anchor}")
        kern = kern.replace(anchor, repl[0])
    inc = "#include <stdint.h>\n"
    head = head.replace(inc, inc + _PRELUDE, 1)
    return head + sep + kern + rest + _EPILOGUE


def build_probe() -> ctypes.CDLL:
    """The probe copy of the checkout's ``gauss_jordan.cu``, built (once for
    each text) under ``build/probe`` and loaded."""
    from slidingwindowdecoder_torch.utils import cuda_build

    text = instrument((cuda_build.CSRC / "gauss_jordan.cu").read_text())
    digest = hashlib.sha256((text + " ".join(cuda_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    out = cuda_build.BUILD_DIR / "probe" / f"gauss_jordan_probe-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cu = out.with_suffix(".cu")
        cu.write_text(text)
        t0 = time.perf_counter()
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                               str(cu)], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the probe copy:\n{proc.stdout}{proc.stderr}")
        print(f"# probe build {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    lib = ctypes.CDLL(str(out))
    lib.swd_error_string.argtypes = [ctypes.c_int]
    lib.swd_error_string.restype = ctypes.c_char_p
    lib.swd_probe_max_active.argtypes = [ctypes.c_int] * 5
    lib.swd_probe_max_active.restype = ctypes.c_int
    return lib


def max_active(probe, m: int, n: int, W: int, C: int, fused: bool) -> int:
    """The most C-block clusters of this shape the card runs at once
    (``cudaOccupancyMaxActiveClusters`` on the probe build's kernel, whose
    shared memory is the shipped kernel's): a bucket of B shots runs in
    ceil(B / this) waves."""
    got = probe.swd_probe_max_active(m, n, W, C, int(fused))
    if got < 0:
        raise SystemExit(f"occupancy query failed: {probe.swd_error_string(-got).decode()}")
    return got


def entry_from(lib):
    """A stand-in for ``ops.gf2_cuda._entry`` that binds ``lib``'s entry
    points with the same argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    types = {"gauss_jordan_key": [p] * 7 + [i] * 5 + [p],
             "osd_cs_fused": [p] * 10 + [i] * 7 + [p],
             "gauss_jordan_key_cluster": [p] * 7 + [i] * 6 + [p],
             "osd_cs_fused_cluster": [p] * 10 + [i] * 8 + [p]}

    def entry(name):
        fn = getattr(lib, name)
        fn.argtypes = types[name]
        fn.restype = ctypes.c_int
        return lib, fn

    return entry


def first_osd_bucket(decoder, synd):
    """The arguments of the first ``osd_decode`` call of a BP+OSD
    ``decoder`` in one ``core`` call on ``synd``."""
    from slidingwindowdecoder_torch.decoders import bposd

    seen = []
    orig = bposd.osd_decode

    def first(*a, **k):
        if not seen:
            seen.append((tuple(x.clone() if hasattr(x, "clone") else x for x in a), dict(k)))
        return orig(*a, **k)

    bposd.osd_decode = first
    try:
        decoder.core(synd)
    finally:
        bposd.osd_decode = orig
    return seen[0]


def buckets():
    """(label, osd_decode args, kwargs) of the two buckets."""
    import torch

    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        build_global_decoder,
        window_decoder_factory,
    )

    out = []
    dem = build_bb_window_experiment(144, 0.004, 12, 3, 1)[2]
    det, _, _ = sample_dem_numpy(dem, 8192, np.random.default_rng(SEED))
    dec = build_global_decoder(dem, device="cuda")
    out.append(("936x8784", *first_osd_bucket(dec, torch.as_tensor(det, device="cuda"))))
    _, _, dem, plan = build_bb_window_experiment(288, 0.005, 6, 4, 1)
    det, _, _ = sample_dem_numpy(dem, 16384, np.random.default_rng(SEED))
    spec = plan.windows[1]
    dec = window_decoder_factory(False, device="cuda")(spec)
    synd = torch.as_tensor(det[:, spec.row_start:spec.row_end], device="cuda")
    out.append(("576x4896", *first_osd_bucket(dec, synd)))
    return out


def round_split(gj, key, rank: int, K: int):
    """Rounds and dead rounds of a round of K candidates, from the plain
    elimination's pivots: step r's round takes the first live column at or
    after the previous pivot's sorted position, so the rounds between two
    pivots at sorted positions p' < p are (p - p' - 1) // K + 1."""
    import torch

    B, n = key.shape
    k = torch.where(key == 0, torch.zeros_like(key), key).cpu().numpy()
    rounds = np.zeros(B, np.int64)
    for b in range(B):
        order = np.lexsort((np.arange(n), k[b]))
        where = np.empty(n, np.int64)
        where[order] = np.arange(n)
        pc = gj["piv_col"][b].cpu().numpy()
        pos = np.sort(where[pc[pc >= 0]])
        gaps = np.diff(np.concatenate([[-1], pos]))
        rounds[b] = int(np.sum((gaps - 1) // K + 1))
    return rounds


def probe_split(probe, call, blocks: int):
    """One ``call`` (a ``gf2_cuda`` entry point on a bucket) on the probe
    build ``probe``: its outputs, its time (CUDA events, ms) and the split
    of its blocks' cycles: rounds, dead rounds and steps per block (a
    shot's, every block of a cluster counting alike), cycles per phase per
    block, each phase's share and the cycles per round of the round's
    phases."""
    import torch

    from slidingwindowdecoder_torch.ops import gf2_cuda

    acc = (ctypes.c_ulonglong * 32)()
    orig_entry = gf2_cuda._entry
    gf2_cuda._entry = entry_from(probe)
    try:
        call()  # warm-up of the probe build
        torch.cuda.synchronize()
        if probe.swd_probe_reset():
            raise SystemExit("probe reset failed")
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = call()
        t1.record()
        torch.cuda.synchronize()
        if probe.swd_probe_read(acc):
            raise SystemExit("probe read failed")
    finally:
        gf2_cuda._entry = orig_entry
    per_block = {p: acc[i] / blocks for i, p in enumerate(PHASES)}
    counts = {c: acc[len(PHASES) + i] / blocks for i, c in enumerate(COUNTS)}
    total = per_block["total"]
    return out, {
        "probe_ms": t0.elapsed_time(t1),
        "counts_per_block": counts,
        "cycles_per_block": per_block,
        "share_of_block_cycles": {p: v / total for p, v in per_block.items() if total},
        "cycles_per_round": {p: per_block[p] / max(counts["rounds"], 1)
                             for p in ("test", "cluster_sync", "decide", "pull", "xor")},
    }


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.ops import gf2_cuda
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        _osd_sweep_cs_sortless,
        ordered_gauss_jordan_key,
    )

    probe = build_probe()
    for label, a, k in buckets():
        Hw, synd, key, llr = a[:4]
        m, n, rank, meta = k["m"], k["n"], k["rank"], k["meta"]
        pi, pj = (torch.as_tensor(meta[x], device="cuda") for x in ("pair_i", "pair_j"))
        W, B = Hw.shape[1], synd.shape[0]
        C = gf2_cuda.gj_cluster_supported(m, n, W, True)
        ref = ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
        ref_sol, ref_pm = _osd_sweep_cs_sortless(ref, key, llr, pi, pj,
                                                 order_w=meta["order_w"])
        calls = {
            "gauss_jordan_key_cluster": lambda: gf2_cuda.gauss_jordan_key(
                Hw, synd, key, m=m, n=n, rank=rank),
            "osd_cs_fused_cluster": lambda: gf2_cuda.osd_cs_fused(
                Hw, synd, key, llr, pi, pj, m=m, n=n, rank=rank, order_w=meta["order_w"]),
        }
        steps = (ref["piv_col"] >= 0).sum(dim=1).cpu().numpy()
        for name, call in calls.items():
            call()  # the shipped build
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            for _ in range(args.reps):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.reps
            out, split = probe_split(probe, call, B * C)
            if name == "osd_cs_fused_cluster":
                ok = (torch.equal(out["solution"], ref_sol)
                      and torch.equal(out["min_pm"].view(torch.int32), ref_pm.view(torch.int32)))
            else:
                ok = all(torch.equal(out[x], ref[x]) for x in ref)
            rec = {
                "bucket": label, "entry": name, "shots": B, "C": C,
                "clusters_at_once": max_active(probe, m, n, W, C, "osd" in name),
                "bit_exact_probe_build": ok, "ms": ms,
                "probe_ms": split.pop("probe_ms"),
                "steps_per_shot_plain": float(steps.mean()),
                "rounds_per_shot_plain_K8": float(round_split(ref, key, rank, 8).mean()),
                "rounds_per_shot_plain_K16": float(round_split(ref, key, rank, 16).mean()),
                "rounds_per_shot_plain_K32": float(round_split(ref, key, rank, 32).mean()),
                "probe_counts_per_block": split.pop("counts_per_block"), **split,
            }
            print(json.dumps(rec), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(out.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
