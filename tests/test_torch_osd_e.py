"""OSD-E and the OSD-CS sweep of the port against the JAX package's
``osd_decode``, on the CPU.

The port's OSD-E (``ops.gf2_solve._osd_sweep_dense`` after the float-keyed
elimination) is held to JAX ``osd_decode`` with ``engine="xla"`` (the
integer-order XLA elimination) and with ``engine="pallas_interpret"`` (the
Pallas ``_gj_kernel`` in interpret mode); the port's OSD-CS path (float
keys, sortless sweep) is held to JAX's ``pallas_interpret`` path, which
runs the integer-order sweep ``_osd_sweep_cs``. Inputs are [[72]] x3 W=2
last-window (72x468, rank 66) and [[144]] x12 W=3 interior-window
(216x1728) PCMs, with coarse reliability keys (many exact ties, which go to
the lower column on both sides) and the window's own priors, or with
continuous keys and jittered priors.

Tolerances: OSD-0, the inconsistency flags and (with jittered priors) every
solution equal; ``min_pm`` within rtol 1e-6, because JAX sums its path
metrics in f32 einsums where the port sums exactly in f64. With the
window's own priors (a few distinct values) two candidates may have
exactly equal f64 metrics, and JAX's f32 sums may round either one lower:
a shot the two decode differently must be such a tie (both corrections
satisfy the syndrome, or on the rank-deficient window give the same
decoded syndrome, and their f64 metrics are equal).
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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: these decodes are many small ops, and where
    the test workers share the cores more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _window(code: int):
    """(H, prior) of the [[72]] last window or a [[144]] interior window."""
    if code == 72:
        spec = build_bb_window_experiment(72, 0.01, 3, 2, 1)[3].windows[2]
    else:
        spec = build_bb_window_experiment(144, 0.004, 12, 3, 1)[3].windows[1]
    return spec.mat, np.asarray(spec.prior, np.float64)


def _inputs(rng, code: int, B: int, keys: str):
    H, prior = _window(code)
    m, n = H.shape
    synd = (rng.random((B, m)) < 0.08).astype(np.uint8)
    if keys == "tie":
        rel = (rng.integers(0, 16, (B, n)) * 0.5).astype(np.float32)
        p = prior
    else:
        rel = (rng.standard_normal((B, n)) * 4).astype(np.float32)
        p = prior * (1 + 0.01 * rng.random(n))
    llr = np.log((1 - p) / p).astype(np.float32)
    return H, synd, rel, llr


def _decode(H, synd, rel, llr, method: str, order: int, engine: str):
    """(port, JAX) ``osd_decode`` outputs as numpy."""
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    k = n - rank
    pats = tg.osd_candidate_patterns(k, order, method)
    Hw = tg.pack_rows_host(H)
    out_t = tg.osd_decode(torch.from_numpy(Hw.view(np.int32)), torch.from_numpy(synd),
                          torch.from_numpy(rel), torch.from_numpy(llr), m=m, n=n,
                          rank=rank, k=k, meta=tg.analyze_patterns(pats, k))
    out_j = jg.osd_decode(jnp.asarray(Hw), jnp.asarray(synd), jnp.asarray(rel),
                          jnp.asarray(llr), pats, m=m, n=n, rank=rank, k=k,
                          meta=jg.analyze_patterns(pats, k), engine=engine)
    return ({key: v.numpy() for key, v in out_t.items()},
            {key: np.asarray(v) for key, v in out_j.items()})


def _assert_same(H, synd, llr, out_t, out_j, keys: str):
    np.testing.assert_array_equal(out_t["osd0"], out_j["osd0"])
    np.testing.assert_array_equal(out_t["inconsistent"], out_j["inconsistent"])
    np.testing.assert_allclose(out_t["min_pm"], out_j["min_pm"], rtol=1e-6)
    sol_t, sol_j = out_t["solution"], out_j["solution"]
    differ = np.nonzero((sol_t != sol_j).any(axis=1))[0]
    if keys == "jitter":
        assert differ.size == 0, differ
    llr64 = llr.astype(np.float64)
    for b in differ:  # exact f64 ties only
        # both satisfy the syndrome (on a rank-deficient PCM, its part in
        # the pivot rows' span: both give the same decoded syndrome)
        want = synd[b] if not out_t["inconsistent"][b] else (H @ sol_j[b]) % 2
        np.testing.assert_array_equal((H @ sol_t[b]) % 2, want, err_msg=f"shot {b}")
        np.testing.assert_array_equal((H @ sol_j[b]) % 2, want, err_msg=f"shot {b}")
        assert llr64 @ sol_t[b] == llr64 @ sol_j[b], b
    return sol_t


@pytest.mark.parametrize("engine", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("code, B", [(72, 32), (144, 8)], ids=["72x468", "216x1728"])
@pytest.mark.parametrize("keys", ["tie", "jitter"])
def test_osd_e_matches_jax(rng, engine, code, B, keys):
    """OSD-E of order 5 (31 candidates): the port's elimination runs
    ``gauss_jordan_key`` (its plain version here) and the dense sweep."""
    H, synd, rel, llr = _inputs(rng, code, B, keys)
    before = (gf2_cuda.gauss_jordan_key.plain_calls, gf2_cuda.osd_cs_fused.plain_calls)
    out_t, out_j = _decode(H, synd, rel, llr, "osd_e", 5, engine)
    after = (gf2_cuda.gauss_jordan_key.plain_calls, gf2_cuda.osd_cs_fused.plain_calls)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    sol = _assert_same(H, synd, llr, out_t, out_j, keys)
    assert (sol != out_t["osd0"]).any()  # the sweep found better candidates


@pytest.mark.parametrize("code, B", [(72, 32), (144, 8)], ids=["72x468", "216x1728"])
@pytest.mark.parametrize("keys", ["tie", "jitter"])
def test_osd_cs_matches_integer_order_sweep(rng, code, B, keys):
    """The port's OSD-CS-6 (float keys, sortless sweep) against JAX's
    integer-order path (``engine="pallas_interpret"``: the Pallas
    elimination and ``_osd_sweep_cs``): equal but at exact f64 ties, so the
    integer-order sweep needs no port of its own."""
    H, synd, rel, llr = _inputs(rng, code, B, keys)
    out_t, out_j = _decode(H, synd, rel, llr, "osd_cs", 6, "pallas_interpret")
    sol = _assert_same(H, synd, llr, out_t, out_j, keys)
    assert (sol != out_t["osd0"]).any()


def test_osd_e_reads_only_the_support(rng):
    """The dense sweep reads only the first ``support`` non-pivot columns:
    a pattern set padded with zero columns gives the same solutions, and
    an OSD-E candidate never sets a column beyond them."""
    H, synd, rel, llr = _inputs(rng, 72, 16, "jitter")
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    k = n - rank
    pats = tg.osd_candidate_patterns(k, 3, "osd_e")
    meta = tg.analyze_patterns(pats, k)
    assert meta["kind"] == "dense" and meta["support"] == 3
    gj = tg.ordered_gauss_jordan_key(torch.from_numpy(tg.pack_rows_host(H).view(np.int32)),
                                     torch.from_numpy(synd), torch.from_numpy(rel),
                                     m=m, n=n, rank=rank)
    sol, pm = tg._osd_sweep_dense(gj, torch.from_numpy(rel), torch.from_numpy(llr),
                                  pats, supp=3)
    sol_w, pm_w = tg._osd_sweep_dense(gj, torch.from_numpy(rel), torch.from_numpy(llr),
                                      np.pad(pats, ((0, 0), (0, 4))), supp=3)
    np.testing.assert_array_equal(sol.numpy(), sol_w.numpy())
    np.testing.assert_array_equal(pm.numpy(), pm_w.numpy())
    piv = np.zeros((16, n), bool)
    np.put_along_axis(piv, gj["piv_col"].numpy().astype(np.int64), True, axis=1)
    flipped = (sol.numpy() != 0) & ~piv
    assert (flipped.sum(axis=1) <= 3).all()


@pytest.mark.parametrize("decoder", ["BPOSD", "OSDWindow"])
def test_decoders_with_osd_e_match_jax(decoder):
    """``BPOSD`` and ``OSDWindow`` with ``osd_method="osd_e"`` (order 4) on
    64 syndromes of a [[72]] window (72x468, the window's priors), 8 BP
    iterations so that most shots reach OSD: the JAX decoders' corrections
    on every shot but exact f64 ties, which must satisfy the syndrome with
    equal weight."""
    from slidingwindowdecoder_torch import decoders as td
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_tpu import decoders as jd

    _, _, dem, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    spec = plan.windows[0]
    synd = sample_dem_numpy(dem, 64, np.random.default_rng(2024))[0][
        :, spec.row_start:spec.row_end]
    kw = dict(osd_method="osd_e", osd_order=4,
              **({"max_iter": 8} if decoder == "BPOSD" else {"post_max_iter": 8}))
    res_t = getattr(td, decoder)(spec.mat, spec.prior, device="cpu", **kw).decode_batch(synd)
    res_j = getattr(jd, decoder)(spec.mat, spec.prior, **kw).decode_batch(synd)
    assert res_t.osd_applied.sum() > 32
    np.testing.assert_array_equal(res_t.osd_applied, res_j.osd_applied)
    llr = np.log((1 - spec.prior) / spec.prior).astype(np.float32).astype(np.float64)
    for b in np.nonzero((res_t.error != res_j.error).any(axis=1))[0]:
        for e in (res_t.error[b], res_j.error[b]):
            np.testing.assert_array_equal((spec.mat @ e) % 2, synd[b], err_msg=f"shot {b}")
        assert llr @ res_t.error[b] == llr @ res_j.error[b], b
