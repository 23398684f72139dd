"""The peel, GDG's fused ensemble, ``decoders.BP`` and ``check_syndrome``
of the port against the JAX package (CPU).

``ops.decimation.peel`` / ``peel_t`` (with and without ``max_sweeps``) on
CPU tensors run their plain loops, the plain versions of ``csrc/peel.cu``
(``tests/test_torch_cuda.py`` holds the kernel against them on the card).
Inputs are made with numpy from a seed and fed to both sides; the peel is
integer arithmetic, so every output is bit-exact. ``gdg_ensemble`` is
reached through ``GDG(ensemble_mode="fused")`` on both sides: errors,
convergence and iterations per shot exactly (jittered priors, so no exact
ties), ``min_pm`` to rtol 1e-6 (the port sums path metrics exactly in
f64, JAX in f32 in XLA's order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import BP, GDG
from slidingwindowdecoder_torch.decoders import gdg as tgdg
from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_torch.ops import decimation as tdec
from slidingwindowdecoder_torch.ops import peel_cuda
from slidingwindowdecoder_tpu.decoders import BP as JBP
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.ops import bp as jbp
from slidingwindowdecoder_tpu.ops import decimation as jdec


@pytest.fixture(autouse=True)
def one_thread():
    """Small inputs: more torch threads gain nothing here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pcm(rng, shape):
    if shape == "random":
        m, n = 30, 70
        H = (rng.random((m, n)) < 0.1).astype(np.uint8)
        H[rng.integers(0, m, n), np.arange(n)] = 1
        H[np.arange(m), rng.integers(0, n, m)] = 1
        return H
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment

    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    return plan.windows[0].mat


def _graphs(H):
    g = compile_graph(H)
    return graph_tensors(g, "cpu"), graph_device_arrays(g)


def _states(rng, H, gt, gj, B, frac, transposed):
    """The same random decisions (``frac`` of the VNs, random values, so
    many contradictions; every fourth column decides none) from a random
    syndrome on both sides, and a fifth of the columns dead at entry."""
    m, n = H.shape
    synd = rng.integers(0, 2, (B, m)).astype(np.uint8)
    mask = rng.random((B, n)) < frac
    mask[::4] = False
    vals = rng.integers(0, 2, (B, n)).astype(np.int8)
    dead = rng.random(B) < 0.2
    if transposed:
        st = tdec.init_decimation_state_t(gt, torch.from_numpy(synd.T.copy()))
        st = tdec.vn_set_values_t(gt, *st[:3], torch.from_numpy(dead),
                                  torch.from_numpy(mask.T.copy()),
                                  torch.from_numpy(vals.T.copy()))
        sj = jdec.init_decimation_state_t(gj, jnp.asarray(synd.T))
        sj = jdec.vn_set_values_t(gj, *sj[:3], jnp.asarray(dead), jnp.asarray(mask.T),
                                  jnp.asarray(vals.T))
    else:
        st = tdec.init_decimation_state(gt, torch.from_numpy(synd))
        st = tdec.vn_set_values(gt, *st[:3], torch.from_numpy(dead), torch.from_numpy(mask),
                                torch.from_numpy(vals))
        sj = jdec.init_decimation_state(gj, jnp.asarray(synd))
        sj = jdec.vn_set_values(gj, *sj[:3], jnp.asarray(dead), jnp.asarray(mask),
                                jnp.asarray(vals))
    return st, sj


def _assert_equal(st, sj):
    for name, a, b in zip(("vn", "cn", "deg", "dead"), st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert a.dtype == {"vn": torch.int8, "cn": torch.int8, "deg": torch.int32,
                           "dead": torch.bool}[name], name


@pytest.mark.parametrize("max_sweeps", [None, 1, 2, 3])
@pytest.mark.parametrize("transposed", [False, True], ids=["peel", "peel_t"])
@pytest.mark.parametrize("shape", ["random", "window"])
def test_peel_matches_jax(shape, transposed, max_sweeps):
    """``peel`` / ``peel_t`` with JAX's ``max_sweeps`` (None: to the
    fixpoint) on random states with dead columns at entry, bit for bit;
    the plain loop's calls are counted."""
    rng = np.random.default_rng(5)
    H = _pcm(rng, shape)
    gt, gj = _graphs(H)
    frac = {"random": 0.5, "window": 0.8}[shape]
    st, sj = _states(rng, H, gt, gj, 64, frac, transposed)
    dead_at_entry = st[3].numpy().copy()
    before = peel_cuda.peel_fixpoint.plain_calls
    if transposed:
        pt = tdec.peel_t(gt, *st, max_sweeps=max_sweeps)
        pj = jdec.peel_t(gj, *sj, max_sweeps=max_sweeps)
    else:
        pt = tdec.peel(gt, *st, max_sweeps=max_sweeps)
        pj = jdec.peel(gj, *sj, max_sweeps=max_sweeps)
    assert peel_cuda.peel_fixpoint.plain_calls == before + 1
    _assert_equal(pt, pj)
    assert dead_at_entry.any() and not pt[3].numpy().all()
    assert (pt[0].numpy() != -1).sum() > (st[0].numpy() != -1).sum()


def test_max_sweeps_caps_the_batch():
    """On a path graph forced from one end (one VN a sweep), ``max_sweeps``
    k decides exactly k more VNs, and 0 or less still runs JAX's first
    sweep."""
    n = 12
    H = np.zeros((n - 1, n), np.uint8)
    for i in range(n - 1):
        H[i, i] = H[i, i + 1] = 1
    gt, gj = _graphs(H)
    synd = np.zeros((1, n - 1), np.uint8)
    mask = np.zeros((1, n), bool)
    mask[0, 0] = True
    st = tdec.vn_set_values(gt, *tdec.init_decimation_state(gt, torch.from_numpy(synd)),
                            torch.from_numpy(mask), torch.zeros((1, n), dtype=torch.int8))
    sj = jdec.vn_set_values(gj, *jdec.init_decimation_state(gj, jnp.asarray(synd)),
                            jnp.asarray(mask), jnp.zeros((1, n), jnp.int8))
    for k in (-1, 0, 1, 4, n):
        pt = tdec.peel(gt, *st, max_sweeps=k)
        _assert_equal(pt, jdec.peel(gj, *sj, max_sweeps=k))
        assert int((pt[0] != -1).sum()) == 1 + min(max(k, 1), n - 1)


@pytest.mark.parametrize("n", [9, 16])
@pytest.mark.parametrize("dead_row", [0, 1])
def test_peel_stops_with_the_last_live_row(n, dead_row):
    """The batch-major twin of ``test_torch_decimation_t.py::
    test_peel_t_stops_with_the_last_live_row``: two copies of a path graph
    of ``n`` VNs, a live row forced from both ends and a dead row forced
    from one end. JAX stops after the live row's first sweep that forces
    nothing, leaving the dead row's chain part forced; the port too,
    whichever row is dead."""
    H = np.zeros((n - 1, n), np.uint8)
    for i in range(n - 1):
        H[i, i] = H[i, i + 1] = 1
    gt, gj = _graphs(H)
    live_row = 1 - dead_row
    synd = np.zeros((2, n - 1), np.uint8)
    mask = np.zeros((2, n), bool)
    mask[live_row, [0, n - 1]] = True
    mask[dead_row, 0] = True
    vals = np.zeros((2, n), np.int8)
    dead = np.arange(2) == dead_row
    st = tdec.init_decimation_state(gt, torch.from_numpy(synd))
    st = tdec.vn_set_values(gt, *st[:3], torch.from_numpy(dead), torch.from_numpy(mask),
                            torch.from_numpy(vals))
    sj = jdec.init_decimation_state(gj, jnp.asarray(synd))
    sj = jdec.vn_set_values(gj, *sj[:3], jnp.asarray(dead), jnp.asarray(mask),
                            jnp.asarray(vals))
    pt = tdec.peel(gt, *st)
    _assert_equal(pt, jdec.peel(gj, *sj))
    vn = pt[0].numpy()
    assert not pt[3][live_row] and (vn[live_row] == 0).all()
    n_sweeps = -(-(n - 2) // 2) + 1
    np.testing.assert_array_equal(vn[dead_row], [0] * (1 + n_sweeps) + [-1] * (n - 1 - n_sweeps))


# small GDG knobs on the [[72]] hx: 12 branches, D_max 12
GDG_KW = dict(max_iter=8, ms_scaling_factor=1.0, gdg_factor=1.0, max_iter_per_step=4,
              max_step=12, max_tree_depth=2, max_side_depth=4, max_tree_branch_step=4,
              max_side_branch_step=4, ensemble_bucket=16)


@pytest.fixture(scope="module")
def gdg_inputs():
    """64 code-capacity syndromes of the [[72]] hx at p = 0.16 with
    jittered priors; every fourth replaced by a random syndrome, most of
    which no correction matches, so that no branch of those shots
    converges and the main column's error is reported."""
    code, _, _ = bb_code_by_n(72)
    rng = np.random.default_rng(11)
    probs = 0.16 * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((64, code.N)) < probs).astype(np.uint8)
    synds = ((errs @ code.hx.T) % 2).astype(np.uint8)
    synds[::4] = rng.integers(0, 2, synds[::4].shape)
    return code, probs, synds


@pytest.fixture(scope="module")
def jax_gdg(gdg_inputs):
    """The JAX GDG's fused form (both loop forms) and host-stepped form."""
    code, probs, synds = gdg_inputs
    return {(mode, ee): JGDG(code.hx, probs, ensemble_mode=mode, ensemble_early_exit=ee,
                             **GDG_KW).decode_batch(synds)
            for mode, ee in (("fused", False), ("fused", True), ("host_loop", False))}


def _differ(a, b):
    return (a.error != b.error).any(axis=1) | (a.converged != b.converged) | (
        a.iterations != b.iterations)


@pytest.mark.parametrize("early_exit", [False, True])
def test_gdg_ensemble_matches_jax(gdg_inputs, jax_gdg, early_exit):
    """``GDG(ensemble_mode="fused")`` runs ``gdg_ensemble`` on both sides:
    per shot equal, non-converged shots included; against the
    host-stepped form it may differ only on shots with no converged
    branch, and exactly where the JAX package's two forms differ."""
    code, probs, synds = gdg_inputs
    rt = GDG(code.hx, probs, ensemble_mode="fused", ensemble_early_exit=early_exit,
             device="cpu", **GDG_KW).decode_batch(synds)
    rj = jax_gdg["fused", early_exit]
    assert 0 < (~rt.converged).sum() < len(synds) // 2
    assert not _differ(rt, rj).any()
    np.testing.assert_allclose(rt.min_pm, rj.min_pm, rtol=1e-6)
    rh = GDG(code.hx, probs, ensemble_mode="host_loop", device="cpu",
             **GDG_KW).decode_batch(synds)
    differ = _differ(rt, rh)
    assert not (differ & rt.converged).any()
    np.testing.assert_array_equal(differ, _differ(rj, jax_gdg["host_loop", False]))


@pytest.mark.parametrize("early_exit", [False, True])
def test_fused_ensemble_steps(gdg_inputs, monkeypatch, early_exit):
    """The fused form runs every one of ``D_max`` steps on every bucket
    (``early_exit`` False), or stops before the first step at which no
    column is unfinished (True), here before ``D_max`` (16 shots with
    correctable syndromes)."""
    code, probs, synds = gdg_inputs
    dec = GDG(code.hx, probs, ensemble_mode="fused", ensemble_early_exit=early_exit,
              device="cpu", **GDG_KW)
    seen, step = [], tgdg._ensemble_step

    def counted(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw):
        seen.append(d)
        return step(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw)

    monkeypatch.setattr(tgdg, "_ensemble_step", counted)
    dec.core(torch.from_numpy(synds[np.arange(len(synds)) % 4 != 0][:16]))
    if early_exit:
        assert seen == list(range(len(seen))) and len(seen) < dec.D_max
    else:
        assert seen == list(range(dec.D_max))


def test_bp_decoder_matches_jax():
    """``decoders.BP`` (BPOSD with OSD off, the JAX defaults: 50
    iterations, factor 1.0, clip 50) on 64 [[72]] syndromes at p = 0.12:
    errors, convergence and iterations per shot."""
    code, _, _ = bb_code_by_n(72)
    rng = np.random.default_rng(2)
    probs = 0.12 * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((64, code.N)) < probs).astype(np.uint8)
    synds = ((errs @ code.hx.T) % 2).astype(np.uint8)
    dec = BP(code.hx, probs, device="cpu")
    assert (dec.max_iter, dec.alpha, dec.clip, dec.osd_method) == (50, 1.0, 50.0, None)
    rt = dec.decode_batch(synds)
    rj = JBP(code.hx, probs).decode_batch(synds)
    assert 0 < rt.converged.sum() < len(synds)
    for k in ("error", "converged", "iterations"):
        np.testing.assert_array_equal(np.asarray(getattr(rt, k)), np.asarray(getattr(rj, k)),
                                      err_msg=k)


@pytest.mark.parametrize("shape", ["random", "window"])
def test_check_syndrome_matches_jax(shape):
    """``ops.bp.check_syndrome``: [B, n] errors (decided VNs of either
    value included) -> [B, m] int32 syndromes, equal to JAX's."""
    rng = np.random.default_rng(9)
    H = _pcm(rng, shape)
    gt, gj = _graphs(H)
    err = (rng.random((48, H.shape[1])) < 0.3).astype(np.int8)
    st = tbp.check_syndrome(gt, torch.from_numpy(err))
    sj = np.asarray(jbp.check_syndrome(gj, jnp.asarray(err)))
    assert st.dtype == torch.int32 and sj.dtype == np.int32
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(st.numpy(), (err.astype(np.int64) @ H.T) % 2)


@pytest.mark.parametrize("transposed", [False, True], ids=["peel", "peel_t"])
def test_peel_refuses_other_devices(transposed):
    """On a tensor neither on the CPU nor on a card, ``peel`` / ``peel_t``
    neither run the plain loop nor fall back: the kernel's wrapper raises."""
    H = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    garr = graph_tensors(compile_graph(H), "cpu")
    n, rows = 3, garr["m_pad"] if transposed else 2
    shape = (lambda r: (r, 4)) if transposed else (lambda r: (4, r))
    state = (torch.zeros(shape(n), dtype=torch.int8, device="meta"),
             torch.zeros(shape(rows), dtype=torch.int8, device="meta"),
             torch.zeros(shape(rows), dtype=torch.int32, device="meta"),
             torch.zeros(4, dtype=torch.bool, device="meta"))
    before = peel_cuda.peel_fixpoint.plain_calls
    with pytest.raises(ValueError, match="unsupported device"):
        (tdec.peel_t if transposed else tdec.peel)(garr, *state)
    assert peel_cuda.peel_fixpoint.plain_calls == before
