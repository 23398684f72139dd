"""The port's transposed (batch-minor) decimation ops against the JAX
package's ``_t`` forms and against the port's own batch-major forms.

Inputs are made with numpy from a seed and fed to both sides. Every op is
integer arithmetic, so every output must be bit-exact (no tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.ops import decimation as tdec
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.ops import decimation as jdec


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


def _both(H):
    g = compile_graph(H)
    return g, graph_tensors(g, "cpu"), graph_device_arrays(g)


def _assert_equal(st, sj):
    for name, a, b in zip(("vn_t", "cn_t", "deg_t", "dead"), st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _assert_matches_batch_major(st, sb, m):
    """The transposed state equals the batch-major one, transposed (the
    pad rows of the CN arrays stay inert)."""
    vn_t, cn_t, deg_t, dead = st
    vn, cn, deg, dead_b = sb
    assert torch.equal(vn_t.T, vn) and torch.equal(dead, dead_b)
    assert torch.equal(cn_t[:m].T, cn) and torch.equal(deg_t[:m].T, deg)
    assert (cn_t[m:] == -1).all() and (deg_t[m:] == 0).all()


def _decide(rng, H, gt, gj, B, frac):
    """The same random decisions (``frac`` of the VNs, random values, many
    contradictions; every fourth row decides none) applied by the port's
    transposed form, the JAX transposed form and the port's batch-major
    form, from a random syndrome."""
    m, n = H.shape
    synd = rng.integers(0, 2, (B, m)).astype(np.uint8)
    mask = rng.random((B, n)) < frac
    mask[::4] = False
    vals = rng.integers(0, 2, (B, n)).astype(np.int8)
    st = tdec.init_decimation_state_t(gt, torch.from_numpy(synd.T.copy()))
    sj = jdec.init_decimation_state_t(gj, jnp.asarray(synd.T))
    _assert_equal(st, sj)
    st = tdec.vn_set_values_t(gt, *st, torch.from_numpy(mask.T.copy()),
                              torch.from_numpy(vals.T.copy()))
    sj = jdec.vn_set_values_t(gj, *sj, jnp.asarray(mask.T), jnp.asarray(vals.T))
    sb = tdec.vn_set_values(gt, *tdec.init_decimation_state(gt, torch.from_numpy(synd)),
                            torch.from_numpy(mask), torch.from_numpy(vals))
    return st, sj, sb


@pytest.mark.parametrize("shape", ["random", "window"])
def test_vn_set_values_t_matches_jax(rng, shape):
    """Two rounds of decisions; the second overlaps decided VNs with other
    values (conflicts) and drives checks to degree 0 with odd parity
    (contradictions)."""
    H = _pcm(rng, shape)
    _, gt, gj = _both(H)
    B, (m, n) = 64, H.shape
    st, sj, sb = _decide(rng, H, gt, gj, B, 0.3)
    _assert_equal(st, sj)
    _assert_matches_batch_major(st, sb, m)
    mask = rng.random((B, n)) < 0.6
    mask[::4] = False
    vals = rng.integers(0, 2, (B, n)).astype(np.int8)
    st = tdec.vn_set_values_t(gt, *st, torch.from_numpy(mask.T.copy()),
                              torch.from_numpy(vals.T.copy()))
    sj = jdec.vn_set_values_t(gj, *sj, jnp.asarray(mask.T), jnp.asarray(vals.T))
    sb = tdec.vn_set_values(gt, *sb, torch.from_numpy(mask), torch.from_numpy(vals))
    _assert_equal(st, sj)
    _assert_matches_batch_major(st, sb, m)
    dead = st[3].numpy()
    assert dead.any() and not dead.all()
    assert (st[1][:m].numpy() == -1).any()


@pytest.mark.parametrize("shape", ["random", "window"])
@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peel_t_matches_jax(shape, density, seed):
    """The peel to its fixpoint, on three draws of the decisions: the JAX
    ``peel_t`` and the port's batch-major ``peel``, bit for bit, dead rows
    included (they are swept for as long as a live row forces)."""
    rng = np.random.default_rng(seed)
    H = _pcm(rng, shape)
    _, gt, gj = _both(H)
    frac = {"random": {"sparse": 0.5, "dense": 0.7},
            "window": {"sparse": 0.7, "dense": 0.9}}[shape][density]
    st, sj, sb = _decide(rng, H, gt, gj, 64, frac)
    pt = tdec.peel_t(gt, *st)
    _assert_equal(pt, jdec.peel_t(gj, *sj))
    _assert_matches_batch_major(pt, tdec.peel(gt, *sb), H.shape[0])
    assert (pt[0].numpy() != -1).sum() > (st[0].numpy() != -1).sum()
    assert pt[3].numpy().any()


@pytest.mark.parametrize("n", [9, 16])
@pytest.mark.parametrize("dead_row", [0, 1])
def test_peel_t_stops_with_the_last_live_row(n, dead_row):
    """Two copies of a path graph of ``n`` VNs: a live row forced from
    both ends (ceil((n-2)/2) forcing sweeps) and a dead row forced from one
    end. JAX stops after the live row's first sweep that forces nothing,
    leaving the dead row's chain part forced; the port must stop there
    too, whichever row is dead."""
    H = np.zeros((n - 1, n), np.uint8)
    for i in range(n - 1):
        H[i, i] = H[i, i + 1] = 1
    _, gt, gj = _both(H)
    live_row = 1 - dead_row
    synd = np.zeros((2, n - 1), np.uint8)
    mask = np.zeros((2, n), bool)
    mask[live_row, [0, n - 1]] = True
    mask[dead_row, 0] = True
    vals = np.zeros((2, n), np.int8)
    dead = np.arange(2) == dead_row
    st = tdec.init_decimation_state_t(gt, torch.from_numpy(synd.T.copy()))
    st = tdec.vn_set_values_t(gt, *st[:3], torch.from_numpy(dead),
                              torch.from_numpy(mask.T.copy()), torch.from_numpy(vals.T.copy()))
    sj = jdec.init_decimation_state_t(gj, jnp.asarray(synd.T))
    sj = jdec.vn_set_values_t(gj, *sj[:3], jnp.asarray(dead), jnp.asarray(mask.T),
                              jnp.asarray(vals.T))
    pt = tdec.peel_t(gt, *st)
    _assert_equal(pt, jdec.peel_t(gj, *sj))
    vn = pt[0].numpy().T
    assert not pt[3][live_row] and (vn[live_row] == 0).all()
    n_sweeps = -(-(n - 2) // 2) + 1
    np.testing.assert_array_equal(vn[dead_row], [0] * (1 + n_sweeps) + [-1] * (n - 1 - n_sweeps))


@pytest.mark.parametrize("shape", ["random", "window"])
def test_unsatisfied_counts_match_jax(rng, shape):
    """``num_flip`` in both layouts, against JAX: from a decoded syndrome
    (which the transposed form takes with pad rows equal to the target's)
    and, batch-major, from the error alone."""
    H = _pcm(rng, shape)
    g, gt, gj = _both(H)
    B, (m, n) = 48, H.shape
    st, sj, sb = _decide(rng, H, gt, gj, B, 0.4)
    err = (rng.random((B, n)) < 0.1).astype(np.int8)
    synd = rng.integers(0, 2, (B, m)).astype(np.uint8)
    shat = ((err.astype(np.int64) @ H.T) % 2).astype(np.int8)
    pad = np.zeros((g.m_pad - m, B), np.int8)
    shat_t, synd_t = np.concatenate([shat.T, pad]), np.concatenate([synd.T, pad])
    ct = tdec.unsatisfied_counts_t(gt, torch.from_numpy(shat_t), torch.from_numpy(synd_t),
                                   st[1])
    cj = jdec.unsatisfied_counts_t(gj, jnp.asarray(shat_t), jnp.asarray(synd_t), sj[1])
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    cn = sb[1]
    cb = tdec.unsatisfied_counts(gt, None, torch.from_numpy(synd), cn,
                                 synd_hat=torch.from_numpy(shat))
    cb_err = tdec.unsatisfied_counts(gt, torch.from_numpy(err), torch.from_numpy(synd), cn)
    cbj = jdec.unsatisfied_counts(gj, jnp.asarray(err), jnp.asarray(synd), jnp.asarray(cn))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(cbj))
    np.testing.assert_array_equal(cb_err.numpy(), np.asarray(cbj))
    np.testing.assert_array_equal(ct.numpy(), cb.numpy().T)
    assert ct.numpy().max() >= 2
