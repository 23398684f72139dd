"""OSD-CS through ``ops.gf2_cuda.osd_cs_fused`` against the JAX package, and
the design of the fused kernel (``csrc/gauss_jordan.cu``) on the CPU.

On the CPU the fused entry point runs its plain version (the elimination
and the sweep of ``ops.gf2_solve``), held here to the JAX ``osd_decode`` on
a [[72]] window and on the rank-deficient [[144]] 216x1656 window. The
kernel itself runs only on a card (``tests/test_torch_cuda.py``); what can
be checked without one is its algorithm: a numpy model of its sorted
greedy scan gives the plain elimination's pivots and reduced state, and
its first non-pivot columns are the sweep's iterated argmins.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
from slidingwindowdecoder_torch.ops import gf2_cuda
from slidingwindowdecoder_torch.ops import gf2_solve as tg
from slidingwindowdecoder_tpu.ops import gf2_solve as jg


@functools.cache
def _window(code: int, which: int):
    """(H, prior) of a window: [[72]] x3 W=2 at p=0.01, [[144]] x12 W=3 at
    p=0.004 (window -1 is 216x1656 of rank 210)."""
    args = {72: (0.01, 3, 2), 144: (0.004, 12, 3)}[code]
    spec = build_bb_window_experiment(code, *args, 1)[3].windows[which]
    return spec.mat, np.asarray(spec.prior, np.float64)


def _osd_inputs(rng, H, prior, B, jitter=True):
    m, n = H.shape
    synd = (rng.random((B, m)) < 0.08).astype(np.uint8)
    rel = (rng.standard_normal((B, n)) * 4).astype(np.float32)
    # jittered priors: no two candidates tie exactly (see test_osd_cs_ties)
    p = prior * (1 + 0.01 * rng.random(n)) if jitter else prior
    llr = np.log((1 - p) / p).astype(np.float32)
    return synd, rel, llr


def _both(H, synd, rel, llr, order=10):
    """(port, JAX) osd_decode outputs, OSD-CS of ``order``."""
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    k = n - rank
    pats = tg.osd_candidate_patterns(k, order, "osd_cs")
    Hw = tg.pack_rows_host(H)
    out_t = tg.osd_decode(torch.from_numpy(Hw.view(np.int32)), torch.from_numpy(synd),
                          torch.from_numpy(rel), torch.from_numpy(llr), m=m, n=n,
                          rank=rank, k=k, meta=tg.analyze_patterns(pats, k))
    out_j = jg.osd_decode(jnp.asarray(Hw), jnp.asarray(synd), jnp.asarray(rel),
                          jnp.asarray(llr), pats, m=m, n=n, rank=rank, k=k,
                          meta=jg.analyze_patterns(pats, k))
    return {key: v.numpy() for key, v in out_t.items()}, {
        key: np.asarray(v) for key, v in out_j.items()}


@pytest.mark.parametrize("code, which, order, B", [(72, 0, 4, 64), (144, -1, 10, 24)])
def test_osd_cs_fused_path_matches_jax(rng, code, which, order, B):
    """osd_decode (CS, 1-D prior) on the CPU runs the fused entry point's
    plain version: solutions, OSD-0 and inconsistency equal to JAX's,
    ``min_pm`` within rtol 1e-6 (the two sum in other orders)."""
    H, prior = _window(code, which)
    synd, rel, llr = _osd_inputs(rng, H, prior, B)
    before = (gf2_cuda.osd_cs_fused.plain_calls, gf2_cuda.gauss_jordan_key.plain_calls)
    out_t, out_j = _both(H, synd, rel, llr, order)
    after = (gf2_cuda.osd_cs_fused.plain_calls, gf2_cuda.gauss_jordan_key.plain_calls)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    for key in ("solution", "osd0", "inconsistent"):
        np.testing.assert_array_equal(out_t[key], out_j[key], err_msg=key)
    np.testing.assert_allclose(out_t["min_pm"], out_j["min_pm"], rtol=1e-6)
    assert (out_t["solution"] != out_t["osd0"]).any()
    if which == -1:  # rank 210 of 216 rows: random syndromes leave the span
        assert out_t["inconsistent"].any()


def test_osd_cs_ties(rng):
    """With the window's own priors (few distinct values) candidates tie
    exactly, and the port and JAX may round different ones lower. Every
    shot they decode differently must be such a tie: both corrections
    satisfy the syndrome and have equal path metrics in f64."""
    H, prior = _window(72, 0)
    synd, rel, llr = _osd_inputs(rng, H, prior, 32, jitter=False)
    out_t, out_j = _both(H, synd, rel, llr, 4)
    np.testing.assert_array_equal(out_t["inconsistent"], out_j["inconsistent"])
    differ = (out_t["solution"] != out_j["solution"]).any(axis=1)
    assert differ.any()  # these inputs hold a tie that decides a shot
    # where both pick the same correction, its metric agrees to f32 sum order
    np.testing.assert_allclose(out_t["min_pm"][~differ], out_j["min_pm"][~differ],
                               rtol=1e-6)
    for b in np.nonzero(differ & ~out_t["inconsistent"])[0]:
        pms = [llr.astype(np.float64) @ s[b] for s in (out_t["solution"], out_j["solution"])]
        for s in (out_t["solution"], out_j["solution"]):
            np.testing.assert_array_equal((H @ s[b]) % 2, synd[b])
        assert pms[0] == pms[1], b


def _greedy_scan_model(H, synd, key, rank):
    """The kernel's elimination for one shot, in numpy: sort (key, column)
    once (-0.0 as +0.0), then take as pivot of each step the first live
    column after the previous pivot, its lowest unused holding row as
    pivot row, and clear the column from every other row."""
    m, n = H.shape
    order = np.lexsort((np.arange(n), np.where(key == 0, 0.0, key)))
    rows = np.concatenate([H, synd[:, None]], axis=1).astype(np.uint8)
    unused = np.ones(m, bool)
    pcol, prow = [], []
    pos = 0
    while len(pcol) < rank:
        j = order[pos]
        pos += 1
        hold = np.nonzero(rows[:, j])[0]
        live = hold[unused[hold]]
        if live.size == 0:  # dead: it stays dead
            continue
        p = live[0]
        rows[hold[hold != p]] ^= rows[p]
        unused[p] = False
        pcol.append(j)
        prow.append(p)
    return np.array(pcol), np.array(prow), rows, order


@pytest.mark.parametrize("code, which", [(72, 2), (144, -1)])
def test_sorted_greedy_scan_matches_elimination(rng, code, which):
    """The model of the kernel's scan gives the plain elimination's pivots,
    reduced rows and inconsistency, on keys with exact ties and +-0.0, and
    the sweep's ``order_w`` iterated argmins are the first non-pivot
    columns of its sorted order."""
    H, _ = _window(code, which)
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    assert rank < m  # the rank-deficient windows
    B, order_w = 4, 10
    synd = (rng.random((B, m)) < 0.5).astype(np.uint8)
    key = (rng.integers(-8, 8, (B, n)) * 0.5).astype(np.float32)  # exact ties
    key[:, ::7] = -0.0
    key[:, 3::7] = 0.0
    out = tg.ordered_gauss_jordan_key(
        torch.from_numpy(tg.pack_rows_host(H).view(np.int32)), torch.from_numpy(synd),
        torch.from_numpy(key), m=m, n=n, rank=rank)
    shifts = np.arange(32, dtype=np.uint32)
    red = out["reduced_wm"].numpy().view(np.uint32)  # [W, m, B]
    nonpiv = torch.ones((n, B), dtype=torch.bool)
    nonpiv.scatter_(0, out["piv_col"].T.long(), False)
    tops = tg._top_nonpivot_columns(torch.from_numpy(key).T, nonpiv, order_w).numpy()
    for b in range(B):
        pcol, prow, rows, order = _greedy_scan_model(H, synd[b], key[b], rank)
        np.testing.assert_array_equal(out["piv_col"][b].numpy(), pcol)
        np.testing.assert_array_equal(out["piv_row"][b].numpy(), prow)
        bits = ((red[:, :, b].T[:, :, None] >> shifts) & 1).reshape(m, -1)[:, :n]
        np.testing.assert_array_equal(bits, rows[:, :n])
        np.testing.assert_array_equal(out["synd_bits"][b].numpy(), rows[:, n])
        left = np.ones(m, bool)
        left[prow] = False
        assert bool(out["inconsistent"][b]) == bool((rows[left, n] != 0).any())
        np.testing.assert_array_equal(
            tops[:, b], [j for j in order if j not in set(pcol)][:order_w])


def test_fused_gate_layout():
    """The gate's byte count is its layout summed array by array, aligned
    to 16 bytes: 61,360 B fused and 52,928 B alone at the flagship window
    216x1728 (W 54). Shapes beyond the row limit or shared memory fail."""
    layout = gf2_cuda.smem_layout(216, 1728, 54, fused=True)
    assert layout == {
        "state": 216 * 55 * 4, "sorted_order": 2 * 1728, "pivot_columns": 2 * 216,
        "pivot_rows": 2 * 216, "candidate_tests": 2 * 8 * 17 * 4,
        "column_sums": 4 * 1728, "row_weights": 4 * 216, "column_masks": 12 * 54,
    }
    aligned = sum(-(-x // 16) * 16 for x in layout.values())
    assert gf2_cuda.smem_bytes(216, 1728, 54, fused=True) == aligned == 61_360
    assert gf2_cuda.smem_bytes(216, 1728, 54) == 52_928
    # a small state: the sort's pairs set the first region
    assert gf2_cuda.smem_layout(8, 1000, 32)["state"] == 1024 * 8
    assert gf2_cuda.gj_cuda_supported(216, 1728, 54, fused=True)
    assert not gf2_cuda.gj_cuda_supported(513, 600, 19)  # rows beyond the mask
    assert not gf2_cuda.gj_cuda_supported(500, 4000, 125, fused=True)  # 282 KB


def test_osd_decode_2d_prior_and_counters(rng):
    """A 2-D prior takes the elimination entry point plus the plain sweep
    (the fused kernel takes a 1-D prior only) and gives the 1-D result; on
    the CPU no kernel is launched."""
    H, prior = _window(72, 1)
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    k = n - rank
    synd, rel, llr = _osd_inputs(rng, H, prior, 16)
    meta = tg.analyze_patterns(tg.osd_candidate_patterns(k, 4, "osd_cs"), k)
    Hw = torch.from_numpy(tg.pack_rows_host(H).view(np.int32))
    fused, gj = gf2_cuda.osd_cs_fused, gf2_cuda.gauss_jordan_key
    counts = lambda: (fused.plain_calls, fused.launches, gj.plain_calls, gj.launches)  # noqa: E731
    outs = []
    for prior_t, want in ((torch.from_numpy(llr), (1, 0, 0, 0)),
                          (torch.from_numpy(llr).expand(16, n), (0, 0, 1, 0))):
        before = counts()
        outs.append(tg.osd_decode(Hw, torch.from_numpy(synd), torch.from_numpy(rel), prior_t,
                                  m=m, n=n, rank=rank, k=k, meta=meta))
        assert tuple(a - b for a, b in zip(counts(), before)) == want
    for key in outs[0]:
        assert torch.equal(outs[0][key], outs[1][key]), key
