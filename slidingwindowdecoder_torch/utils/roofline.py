"""Roofline accounting on the NVIDIA H100 (after the JAX package's
``utils/roofline.py``, whose traffic model is the TPU design's).

The bounds here are the least time the card could take for a kernel's
work on the inputs of one run: the larger of the bytes it must move over
the device-memory rate and the operations it must do over the peak rate
of their type. ``chip_smoke.py`` prints each kernel's time beside them.

Peaks (``PEAKS["h100"]``), the H100 SXM5 80GB HBM3's public specs: 3.35
TB/s device memory; arithmetic outside the tensor cores at 132 SMs x
1.98 GHz times the results per clock per SM of compute capability 9.0
(CUDA C++ Programming Guide, arithmetic instruction throughput): 128 for
float32 add, multiply and compare (the published 67 TFLOP/s counts an FMA
as two), 64 for 32-bit integer add, compare, shift and logic, and 64 for
float64 add; 16 for the special-function unit's MUFU instructions
(``exp2``, ``log2``, reciprocal), which run beside the float32 pipe.

The fused BP kernel (``csrc/bp_span.cu``) keeps a shot's message block in
shared memory for the whole call, so its device-memory traffic is not the
TPU design's four slot-major passes an iteration: per row not done at
entry it reads and writes the message block once a call, reads its int32
syndrome and sign seed and its VN state and writes its error, and it
writes the history ring at every iteration that records history. Only the
ring's writes grow with the iterations; the operations grow with every
shot-iteration run (``span_bound``, ``bp_iteration_model``). The fused BP4
kernel (``csrc/bp4_span.cu``) is bound the same way (``bp4_span_bound``):
its messages stay in shared memory for the call. The decide-and-peel
kernel (``csrc/peel.cu``) keeps each column's decimation state in shared
memory for its decision and all its sweeps, so its traffic is one read and
one write of the state (``peel_bound``) and one read of the decision
(``decide_peel_bound``).
"""

from __future__ import annotations

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_ops_per_s": 132 * 128 * 1.98e9,
    "int32_ops_per_s": 132 * 64 * 1.98e9,
    "fp64_adds_per_s": 132 * 64 * 1.98e9,
    "mufu_ops_per_s": 132 * 16 * 1.98e9,
}
PEAKS = {"h100": H100}

# operations of one fused BP iteration, counted from csrc/bp_span.cu: per
# valid edge the CN stage's two passes (clip 2, abs and cap 2, min update
# 3, sign count 2; clip 2, abs and cap 2, select 2, sign 2, negate 1,
# scale 1), the VN sum's add and the edge stage (subtract 1, pin test 2,
# sign count 2); per VN the prior add, the rounding and the pin select
SPAN_OPS_PER_EDGE, SPAN_OPS_PER_VN = 25, 3

# instructions of CUDA's expf and log1pf on sm_90a that every argument
# executes (tools/torch_count_sass.py, nvcc 12.9: the fewest on any path
# through each function's SASS beyond a copy kernel's, constant moves and
# barrier markers left out): the MUFU ones apart (expf's one ex2; log1pf is
# a polynomial, no MUFU), the others one operation each at the float32 rate
EXPF_OPS, EXPF_MUFU = 7, 1
LOG1PF_OPS, LOG1PF_MUFU = 23, 0
# operations of one fused BP4 iteration, counted from csrc/bp4_span.cu: per
# edge of either graph the check stage's two passes (19, as SPAN_OPS_PER_EDGE
# counts them), the variable sum's add, and the edge stage (decided test 1,
# two subtracts, two negations, logaddexp's max, subtract, abs, negation and
# add with one expf and one log1pf, the final subtract, the parity's shift,
# mask and xor 3); per variable the three posteriors (4 adds), the hard
# decision (6 compares, 3 selects), the error bits (4), and two log1pexp
# terms (negation, subtract, abs, negation, max, add, one expf and one
# log1pf each); the MUFU instructions of those expf and log1pf apart
BP4_OPS_PER_EDGE = 19 + 1 + 14 + EXPF_OPS + LOG1PF_OPS
BP4_OPS_PER_VN = 4 + 9 + 4 + 2 * (6 + EXPF_OPS + LOG1PF_OPS)
BP4_MUFU_PER_EDGE = EXPF_MUFU + LOG1PF_MUFU
BP4_MUFU_PER_VN = 2 * (EXPF_MUFU + LOG1PF_MUFU)


def detect_chip(device=None) -> str:
    """The peak table's key of ``device``'s card (``torch.cuda.
    get_device_name``): "h100", or "cpu" for a CPU device. Raises for a
    card with no table here."""
    import torch

    from .device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return "h100"
    raise ValueError(f"no peak rates for {name!r}")


def cn_bound_bytes(valid, m: int, B: int, itemsize: int) -> int:
    """The bytes a check-node update of ``m`` checks at ``B`` columns must
    move: the messages of the valid edges read and written, the checks'
    int32 parities and their rows of the valid mask (the padding rows up to
    ``m_pad`` and the invalid slots count nothing)."""
    return 2 * int(valid.sum()) * B * itemsize + m * B * 4 + valid.shape[0] * m


def gj_ops(m: int, n: int, W: int, rank: int, B: int, xor_rows: int) -> int:
    """32-bit operations of the elimination on these inputs: per step the
    OR over the unused rows' words, the key scan and the pivot-column bit
    test, and the W+1 word XORs of every row that holds the pivot bit
    (``xor_rows``, summed over steps and shots, counted by the plain
    version)."""
    per_shot = sum((m - r) * W + n + m for r in range(rank))
    return per_shot * B + xor_rows * (W + 1)


def span_bound(*, live: int, shot_iters: int, hist_writes: int, edges: int, n: int, dc: int,
               m_pad: int, msg_bytes: int, ring_bytes: int) -> dict:
    """The bound of one ``bp_span`` call on its inputs: ``live`` rows not
    done at entry (a done row's block is neither read nor compared), each
    moving its message block read and written (``dc * m_pad`` messages of
    ``msg_bytes``), its int32 syndrome and sign seed, its VN state and
    error, plus ``hist_writes`` ring entries of ``ring_bytes``; and
    ``shot_iters`` shot-iterations of ``SPAN_OPS_PER_EDGE`` operations a
    valid edge and ``SPAN_OPS_PER_VN`` a VN, all at the float32 rate
    (though the sign counts run at the integer one), on the H100.

    Returns {"ops", "bytes", "ops_ms", "bytes_ms", "bound_ms", "bound_by"}.
    """
    peaks = H100
    ops = shot_iters * (edges * SPAN_OPS_PER_EDGE + n * SPAN_OPS_PER_VN)
    nbytes = live * (2 * dc * m_pad * msg_bytes + 8 * m_pad + 2 * n) + ring_bytes * hist_writes
    ops_ms = ops / peaks["fp32_ops_per_s"] * 1e3
    bytes_ms = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def bp4_span_bound(*, shot_iters: int, edges: int, n: int, in_bytes: int,
                   out_bytes: int) -> dict:
    """The bound of one ``bp4_span`` call on its inputs: ``in_bytes`` read
    once and ``out_bytes`` written once (the caller counts them from the
    call's tensors), and ``shot_iters`` shot-iterations of
    ``BP4_OPS_PER_EDGE`` operations on each of the ``edges`` valid edges of
    both graphs and ``BP4_OPS_PER_VN`` on each of the ``n`` variables at
    the float32 rate on the H100, beside their MUFU instructions
    (``BP4_MUFU_PER_EDGE``, ``BP4_MUFU_PER_VN``) at the special-function
    unit's rate, the two pipes running at once. The bound errs low: it
    counts each ``expf`` and ``log1pf`` by the fewest instructions any
    argument executes, none of the index and shared-memory address
    arithmetic, and no latency.

    Returns {"ops", "mufu_ops", "bytes", "ops_ms", "mufu_ms", "bytes_ms",
    "bound_ms", "bound_by"}.
    """
    ops = shot_iters * (edges * BP4_OPS_PER_EDGE + n * BP4_OPS_PER_VN)
    mufu = shot_iters * (edges * BP4_MUFU_PER_EDGE + n * BP4_MUFU_PER_VN)
    nbytes = in_bytes + out_bytes
    ops_ms = ops / H100["fp32_ops_per_s"] * 1e3
    mufu_ms = mufu / H100["mufu_ops_per_s"] * 1e3
    bytes_ms = nbytes / H100["hbm_bytes_per_s"] * 1e3
    return {"ops": ops, "mufu_ops": mufu, "bytes": nbytes, "ops_ms": ops_ms,
            "mufu_ms": mufu_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, mufu_ms, bytes_ms),
            "bound_by": "operations" if max(ops_ms, mufu_ms) >= bytes_ms else "bytes"}


def peel_bound(*, n: int, m: int, B: int, dc: int, dv: int, column_sweeps: int) -> dict:
    """The bound of one ``peel`` / ``peel_t`` call (``csrc/peel.cu``) on
    ``B`` columns of an m x n graph: each column's state read once and
    written once at its real rows (int8 VN states n, int8 check states and
    int32 degrees of the m checks, the dead flag), the int32 tables read
    once (``dc`` slots of each check, ``dv`` of each VN); and
    ``column_sweeps`` column-sweeps (the call's data: each column's sweeps
    up to its fixpoint or the batch's stop) of two integer operations on
    each check (the degree-1 test), at the int32 rate on the H100.

    Returns {"ops", "bytes", "ops_ms", "bytes_ms", "bound_ms", "bound_by"}.
    """
    ops = column_sweeps * 2 * m
    nbytes = 2 * B * (n + 5 * m + 1) + 4 * (m * dc + n * dv)
    ops_ms = ops / H100["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / H100["hbm_bytes_per_s"] * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def decide_peel_bound(*, n: int, m: int, B: int, dc: int, dv: int, column_sweeps: int,
                      decision: str | None) -> dict:
    """The bound of one decide-and-peel call (``csrc/peel.cu``): ``peel_bound``'s
    bytes and operations, plus the decision read once and tested: "mask"
    (the mask in the VN layout, n bytes a column, and one operation a VN),
    "mask+values" (the values' n bytes too), "index" (a VN index, a value
    and a do-set flag: 10 bytes a column) or None (the plain peel).

    Returns {"ops", "bytes", "ops_ms", "bytes_ms", "bound_ms", "bound_by"}.
    """
    b = peel_bound(n=n, m=m, B=B, dc=dc, dv=dv, column_sweeps=column_sweeps)
    ops, nbytes = b["ops"], b["bytes"]
    if decision == "index":  # int64 index, value and do-set bytes
        nbytes += B * 10
    elif decision in ("mask", "mask+values"):
        ops += B * n
        nbytes += B * n * (2 if decision == "mask+values" else 1)
    elif decision is not None:
        raise ValueError(f"unknown decision {decision!r}")
    ops_ms = ops / H100["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / H100["hbm_bytes_per_s"] * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def bp_iteration_model(graph, batch: float, msg_bytes: int, ring_bytes: int = 4) -> dict:
    """What one more iteration of a ``bp_span`` call costs when ``batch``
    rows run it and record history (``span_bound``'s growth per
    iteration): the ring's writes, ``batch * n * ring_bytes`` bytes (the
    message blocks stay in shared memory), and ``batch * (edges *
    SPAN_OPS_PER_EDGE + n * SPAN_OPS_PER_VN)`` operations. ``call_bytes``
    is what the call moves once, whatever its iterations: each row's
    message block read and written, syndrome, sign seed, VN state and
    error. ``msg_bytes`` is the message size (2 for bf16, 4 for f32)."""
    n, dc, m_pad = graph.n, graph.dc, graph.m_pad
    return {
        "bytes": float(batch * n * ring_bytes),
        "flops": float(batch * (graph.num_edges * SPAN_OPS_PER_EDGE + n * SPAN_OPS_PER_VN)),
        "call_bytes": float(batch * (2 * dc * m_pad * msg_bytes + 8 * m_pad + 2 * n)),
    }


def measure_bp_roofline(
    garr, graph, llr, synds, *, msg_dtype: str = "bfloat16",
    iters_lo: int = 24, iters_hi: int = 48,
) -> dict:
    """Per-iteration time of ``decode_bp`` (unmasked, full history: one
    ``bp_span`` launch a call on the card) by the two-point slope over
    ``iters_lo`` and ``iters_hi`` iterations (the call's fixed costs
    cancel), each the least of three calls timed with CUDA events after
    a warm-up; beside it the model of the same iteration
    (``bp_iteration_model`` for the rows that ran it, counted from the
    two runs' iterations) and the card's peaks.

    Returns the JAX keys: ``bp_iter_ms``, ``hbm_bw_frac`` (modelled bytes
    over time, as a share of the memory rate), ``mfu`` (modelled
    operations over time, as a share of the float32 rate) and
    ``roofline_headroom_x`` (time over the larger of the two bounds: how
    far the iteration is from its roofline; JAX divides the memory rate by
    the achieved rate, which is that ratio for a memory-bound iteration).
    ``synds`` [B, m] on the card: syndromes that BP does not converge on
    (uniform random bits) make every row run every iteration.
    """
    import torch

    from ..ops.bp import decode_bp

    chip = detect_chip(synds.device)
    if chip not in PEAKS:
        raise ValueError("measure_bp_roofline times the card: synds must be on a CUDA device")
    peaks = PEAKS[chip]

    calls = 0

    def run(num_iter):
        nonlocal calls
        calls += 1
        return decode_bp(garr, llr, synds, num_iter=num_iter, masked=False,
                         freeze_messages=False, history_mode="full", msg_dtype=msg_dtype)

    def timed(num_iter):
        iters = int(run(num_iter)["iterations"].sum())  # warm-up, and the rows' trips
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(num_iter)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best, iters

    (t_lo, it_lo), (t_hi, it_hi) = timed(iters_lo), timed(iters_hi)
    per_iter_s = max((t_hi - t_lo) / (iters_hi - iters_lo), 1e-9)
    batch = synds.shape[0]
    rows = (it_hi - it_lo) / (iters_hi - iters_lo)  # rows that ran one more iteration
    msg_bytes = 2 if msg_dtype == "bfloat16" else 4
    model = bp_iteration_model(graph, rows, msg_bytes)
    bw, fl = model["bytes"] / per_iter_s, model["flops"] / per_iter_s
    bound_s = max(model["bytes"] / peaks["hbm_bytes_per_s"],
                  model["flops"] / peaks["fp32_ops_per_s"])
    return {
        "chip": chip,
        "batch": batch,
        "msg_dtype": msg_dtype,
        "rows_per_iter": rows,
        "bp_iter_ms": per_iter_s * 1e3,
        "call_ms": {iters_lo: t_lo * 1e3, iters_hi: t_hi * 1e3},
        "modeled_bytes_per_iter": model["bytes"],
        "modeled_flops_per_iter": model["flops"],
        "achieved_gbytes_per_s": bw / 1e9,
        "hbm_bw_frac": bw / peaks["hbm_bytes_per_s"],
        "mfu": fl / peaks["fp32_ops_per_s"],
        "roofline_headroom_x": per_iter_s / bound_s,
        "calls": calls,
    }
