"""The port's decimation ops (``ops.decimation``) and graph tables against
the JAX package.

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


def _random_pcm(rng, m=30, n=70, dens=0.1):
    H = (rng.random((m, n)) < dens).astype(np.uint8)
    H[rng.integers(0, m, n), np.arange(n)] = 1
    H[np.arange(m), rng.integers(0, n, m)] = 1
    return H


def _pcm(rng, shape):
    if shape == "random":
        return _random_pcm(rng)
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment

    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    return plan.windows[0].mat


def _both(H):
    g = compile_graph(H)
    return g, graph_tensors(g, "cpu"), graph_device_arrays(g)


def _assert_states_equal(st, sj):
    for name, a, b in zip(("vn_state", "cn_state", "cn_degree", "dead"), st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("shape", ["random", "window"])
def test_graph_tensors_tables_match_jax(rng, shape):
    """Every table that ``graph_tensors`` shares with the JAX
    ``graph_device_arrays`` holds the same values."""
    _, gt, gj = _both(_pcm(rng, shape))
    shared = ("cn_vn", "cn_valid", "vn_cn", "vn_valid", "cn_degree", "cn_valid_sm")
    for key in shared:
        np.testing.assert_array_equal(gt[key].numpy(), np.asarray(gj[key]), err_msg=key)


def _decided_state(rng, H, gt, gj, B, frac):
    """Both sides' state after deciding a random ``frac`` of the VNs to
    random values (many contradictions); every fourth row decides none."""
    m, n = H.shape
    synd = rng.integers(0, 2, (B, m)).astype(np.uint8)
    mask = rng.random((B, n)) < frac
    mask[::4] = False
    vals = rng.integers(0, 2, (B, n)).astype(np.int8)
    st = tdec.vn_set_values(gt, *tdec.init_decimation_state(gt, torch.from_numpy(synd)),
                            torch.from_numpy(mask), torch.from_numpy(vals))
    sj = jdec.vn_set_values(gj, *jdec.init_decimation_state(gj, jnp.asarray(synd)),
                            jnp.asarray(mask), jnp.asarray(vals))
    return st, sj


@pytest.mark.parametrize("shape", ["random", "window"])
def test_vn_set_values_matches_jax(rng, shape):
    """Two rounds of decisions: the second overlaps decided VNs with other
    values (conflicts) and drives checks to degree 0 with odd parity
    (contradictions); both set ``dead``."""
    H = _pcm(rng, shape)
    _, gt, gj = _both(H)
    B, n = 64, H.shape[1]
    st = tdec.init_decimation_state(gt, torch.from_numpy(np.zeros((B, H.shape[0]), np.uint8)))
    sj = jdec.init_decimation_state(gj, jnp.zeros((B, H.shape[0]), jnp.uint8))
    _assert_states_equal(st, sj)
    st, sj = _decided_state(rng, H, gt, gj, B, 0.3)
    _assert_states_equal(st, sj)
    mask = rng.random((B, n)) < 0.6
    mask[::4] = False  # these rows decide nothing and stay alive
    vals = rng.integers(0, 2, (B, n)).astype(np.int8)
    st = tdec.vn_set_values(gt, *st, torch.from_numpy(mask), torch.from_numpy(vals))
    sj = jdec.vn_set_values(gj, *sj, jnp.asarray(mask), jnp.asarray(vals))
    _assert_states_equal(st, sj)
    dead = st[3].numpy()
    assert dead.any() and not dead.all()
    assert (st[1].numpy() == -1).any()  # some checks were cleared


@pytest.mark.parametrize("shape", ["random", "window"])
@pytest.mark.parametrize("density", ["sparse", "mid", "dense"])
def test_peel_matches_jax(rng, shape, density):
    """The peel to its fixpoint from states with a small, middling and
    large share of decided VNs (more decided VNs, more degree-1 checks)."""
    H = _pcm(rng, shape)
    _, gt, gj = _both(H)
    frac = {"random": {"sparse": 0.5, "mid": 0.6, "dense": 0.7},
            "window": {"sparse": 0.7, "mid": 0.8, "dense": 0.9}}[shape][density]
    st, sj = _decided_state(rng, H, gt, gj, 64, frac)
    pt = tdec.peel(gt, *st)
    pj = jdec.peel(gj, *sj)
    _assert_states_equal(pt, pj)
    # the peel forced further VNs, and some shots ended dead
    assert (pt[0].numpy() != -1).sum() > (st[0].numpy() != -1).sum()
    assert pt[3].numpy().any()


def test_peel_to_fixpoint_forces_a_chain():
    """A path graph: deciding the first VN forces every other one, one per
    sweep, so the fixpoint takes n - 1 sweeps and is exact."""
    n = 6
    H = np.zeros((n - 1, n), np.uint8)
    for i in range(n - 1):
        H[i, i] = H[i, i + 1] = 1
    _, gt, gj = _both(H)
    synd = np.array([[1, 0, 1, 1, 0]], np.uint8)
    mask = np.zeros((1, n), bool)
    mask[0, 0] = True
    vals = np.zeros((1, n), np.int8)
    st = tdec.vn_set_values(gt, *tdec.init_decimation_state(gt, torch.from_numpy(synd)),
                            torch.from_numpy(mask), torch.from_numpy(vals))
    vn, cn, deg, dead = tdec.peel(gt, *st)
    np.testing.assert_array_equal(vn.numpy()[0], [0, 1, 1, 0, 1, 1])
    assert (cn.numpy() == -1).all() and not dead.any() and (deg.numpy() == 0).all()
    sj = jdec.vn_set_values(gj, *jdec.init_decimation_state(gj, jnp.asarray(synd)),
                            jnp.asarray(mask), jnp.asarray(vals))
    _assert_states_equal((vn, cn, deg, dead), jdec.peel(gj, *sj))
