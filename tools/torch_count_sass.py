#!/usr/bin/env python3
"""SASS instructions of CUDA's ``expf`` and ``log1pf`` on the card's toolkit.

``utils/roofline.py`` bounds the fused BP4 kernel (``csrc/bp4_span.cu``) by
the instructions each ``expf`` and ``log1pf`` must execute. This builds a
probe with three kernels (``y = x``, ``y = expf(x)``, ``y = log1pf(x)``)
with the package's nvcc flags for ``sm_90a`` under ``build/sass_probe/``,
disassembles it with ``cuobjdump -sass`` (kept there as ``probe.sass``)
and walks each kernel's control flow: the fewest instructions any run from
its entry to an ``EXIT`` executes, counted apart for the MUFU instructions
(the special-function unit's, at its own rate) and for all others. Left
out: NOPs, the convergence-barrier markers (``BSSY``, ``BSYNC``) and the
moves of constants into registers (``MOV`` of an immediate, ``HFMA2.MMA``
of ``-RZ, RZ``), which a kernel's loop hoists. A predicated branch may go
either way. So each count is at most what any argument executes: the
special-argument branches are left out (``log1pf``'s skip them for every
positive finite argument, ``expf`` has none). Prints one JSON line: each
kernel's counts, each function's beyond the copy kernel's, and the
toolkit's version.

    python3 tools/torch_count_sass.py
    python3 tools/torch_count_sass.py --sass build/sass_probe/probe.sass

``--sass`` reads a dump instead of building one (no toolkit needed).
Otherwise it needs the CUDA toolkit (``nvcc``, ``cuobjdump``); no card.
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
extern "C" __global__ void probe_copy(const float* x, float* y) { y[threadIdx.x] = x[threadIdx.x]; }
extern "C" __global__ void probe_expf(const float* x, float* y) { y[threadIdx.x] = expf(x[threadIdx.x]); }
extern "C" __global__ void probe_log1pf(const float* x, float* y) { y[threadIdx.x] = log1pf(x[threadIdx.x]); }
"""
INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def build_sass() -> tuple[str, str]:
    """(the probe's SASS, nvcc's version line), built under
    ``build/sass_probe/``."""
    from slidingwindowdecoder_torch.utils import cuda_build

    nvcc = cuda_build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out_dir = cuda_build.BUILD_DIR / "sass_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = out_dir / "probe.cu", out_dir / "probe.cubin"
    src.write_text(PROBE)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    (out_dir / "probe.sass").write_text(sass)
    version = subprocess.run([nvcc, "--version"], check=True, capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    return sass, version


def functions(sass: str) -> dict:
    """{kernel: [(address, predicate, opcode, operands), ...]} and each
    kernel's labels ({name: index}), in program order."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            out[name] = {"insns": [], "labels": {}}
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            out[name]["labels"][m.group(1)] = len(out[name]["insns"])
            continue
        m = INSN.match(line)
        if m:
            out[name]["insns"].append((int(m.group(1), 16), (m.group(2) or "").strip(),
                                       m.group(3), m.group(4)))
    return out


def fewest(fn: dict, weight) -> int:
    """The least total ``weight(opcode, operands)`` over the paths from the
    entry to an unpredicated ``EXIT`` (Dijkstra over instruction indices)."""
    insns, labels = fn["insns"], fn["labels"]
    by_addr = {a: i for i, (a, *_) in enumerate(insns)}

    def target(operands):
        m = TARGET.search(operands)
        if not m:
            raise ValueError(f"branch without a target: {operands!r}")
        return labels[m.group(1)] if m.group(1) else by_addr[int(m.group(2), 16)]

    dist, heap = {0: 0}, [(0, 0)]
    while heap:
        d, i = heapq.heappop(heap)
        if d > dist.get(i, float("inf")) or i >= len(insns):
            continue
        _, pred, op, operands = insns[i]
        d += weight(op, operands)
        always = pred in ("", "@PT")
        base = op.split(".")[0]
        if base == "EXIT" and always:
            return d
        nxt = []
        if base in ("BRA", "JMP"):
            nxt.append(target(operands))
            if not always or re.search(r"!?U?P[0-6]\b", operands):  # a predicate operand
                nxt.append(i + 1)
        elif base in ("RET", "BRX", "JMX"):
            raise ValueError(f"{op} in a probe kernel: not walked")
        else:
            nxt.append(i + 1)
        for j in nxt:
            if d < dist.get(j, float("inf")):
                dist[j] = d
                heapq.heappush(heap, (d, j))
    raise ValueError("no path reaches an EXIT")


def is_setup(op: str, operands: str) -> bool:
    """A NOP, a convergence-barrier marker or a move of a constant."""
    return (op.split(".")[0] in ("NOP", "BSSY", "BSYNC")
            or (op == "MOV" and re.search(r",\s*-?(0x[0-9a-f]+|\d+)\s*$", operands) is not None)
            or (op == "HFMA2.MMA" and "-RZ, RZ" in operands))


def counts(sass: str) -> dict:
    """{kernel: {"mufu", "other", "static"}}: the fewest MUFU and other
    instructions over the kernel's paths (``is_setup``'s weigh nothing),
    and all its instructions but NOPs."""
    res = {}
    for name, fn in functions(sass).items():
        res[name] = {
            "mufu": fewest(fn, lambda op, o: int(op.startswith("MUFU"))),
            "other": fewest(fn, lambda op, o: int(not op.startswith("MUFU")
                                                   and not is_setup(op, o))),
            "static": sum(1 for *_, op, _o in fn["insns"] if not op.startswith("NOP")),
        }
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", default=None, help="read this cuobjdump -sass dump")
    args = ap.parse_args()
    if args.sass:
        with open(args.sass) as f:
            sass, version = f.read(), None
    else:
        sass, version = build_sass()
    c = counts(sass)
    base = c["probe_copy"]
    print(json.dumps({
        "instructions": c,
        "beyond_copy": {f: {k: c[f"probe_{f}"][k] - base[k] for k in ("mufu", "other")}
                        for f in ("expf", "log1pf")},
        "nvcc": version}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
