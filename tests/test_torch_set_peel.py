"""The port's decide-and-peel entry points against the JAX package (CPU).

``ops.decimation.set_values_and_peel`` / ``_t`` (a mask with values) and
``set_index_and_peel`` / ``_t`` (one VN index, value and do-set flag a
column) on CPU tensors run their plain versions, ``vn_set_values(_t)`` and
then the plain peel loop, the plain versions of ``csrc/peel.cu``'s
decide-and-peel launch (``tests/test_torch_cuda.py`` holds the kernel
against them on the card). Here they are held against the JAX package's
``vn_set_values(_t)`` followed by its ``peel(_t)``, the pair its decoders
run: the same inputs, made with numpy from a seed, on both sides; integer
arithmetic, so every output bit for bit. The decisions hit decided VNs of
both values (conflicts), kill columns through checks that reach degree 0
with parity 1 (contradictions), and run with JAX's ``max_sweeps``; the
transposed state keeps its pad rows inert.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.ops import decimation as tdec
from slidingwindowdecoder_torch.ops import peel_cuda
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
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


def _entry_state(rng, H, B):
    """A state in mid-decimation (numpy, batch-major): a random syndrome,
    a third of the VNs decided at random and peeled, a tenth of the
    columns dead at entry, some of them by contradiction."""
    m, n = H.shape
    g = compile_graph(H)
    gt = graph_tensors(g, "cpu")
    synd = torch.from_numpy(rng.integers(0, 2, (B, m)).astype(np.uint8))
    mask = torch.from_numpy(rng.random((B, n)) < 1 / 3)
    vals = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.int8))
    st = tdec.init_decimation_state(gt, synd)
    st = tdec.peel(gt, *tdec.vn_set_values(gt, *st, mask, vals))
    dead = st[3].numpy() | (rng.random(B) < 0.1)
    return [x.numpy() for x in st[:3]] + [dead]


def _decision(rng, vn, frac):
    """A mask over ``frac`` of the VNs, decided VNs included (half of them
    hit again with their own value, half with the other: conflicts), and
    random values; every fifth column decides nothing."""
    mask = rng.random(vn.shape) < frac
    mask[::5] = False
    vals = rng.integers(0, 2, vn.shape).astype(np.int8)
    again = (vn != -1) & (rng.random(vn.shape) < 0.5)
    vals[again] = vn[again]
    return mask, vals


def _to_t(H, g, state):
    """The batch-major numpy state in the transposed layout, pad rows
    m..m_pad inert (state -1, degree 0)."""
    vn, cn, deg, dead = state
    m_pad = g.m_pad
    cn_t = np.full((m_pad, vn.shape[0]), -1, np.int8)
    deg_t = np.zeros((m_pad, vn.shape[0]), np.int32)
    cn_t[:H.shape[0]] = cn.T
    deg_t[:H.shape[0]] = deg.T
    return [vn.T.copy(), cn_t, deg_t, dead]


def _run_both(H, state, transposed, max_sweeps, torch_fn, mask, vals, **decision):
    """The port's entry point on the torch state, JAX's vn_set_values(_t)
    + peel(_t) on the same state with the same (one-hot) decision;
    (torch outputs, JAX outputs)."""
    g = compile_graph(H)
    gt, gj = graph_tensors(g, "cpu"), graph_device_arrays(g)
    if transposed:
        state = _to_t(H, g, state)
        mask, vals = mask.T.copy(), vals.T.copy()
    st = [torch.from_numpy(np.ascontiguousarray(x)) for x in state]
    before = peel_cuda.peel_fixpoint.plain_calls, tdec.vn_set_values.card_calls
    out = torch_fn(gt, *st, **decision, max_sweeps=max_sweeps)
    assert (peel_cuda.peel_fixpoint.plain_calls, tdec.vn_set_values.card_calls) == (
        before[0] + 1, before[1])
    js = [jnp.asarray(x) for x in state]
    set_fn, peel_fn = ((jdec.vn_set_values_t, jdec.peel_t) if transposed
                       else (jdec.vn_set_values, jdec.peel))
    decided = set_fn(gj, *js, jnp.asarray(mask), jnp.asarray(vals))
    return out, peel_fn(gj, *decided, max_sweeps=max_sweeps), decided, g


def _assert_equal(st, sj):
    for name, a, b in zip(("vn", "cn", "deg", "dead"), st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert a.dtype == {"vn": torch.int8, "cn": torch.int8, "deg": torch.int32,
                           "dead": torch.bool}[name], name


@pytest.mark.parametrize("max_sweeps", [None, 2])
@pytest.mark.parametrize("values", ["given", "none"])
@pytest.mark.parametrize("transposed", [False, True], ids=["batch_major", "transposed"])
@pytest.mark.parametrize("shape", ["random", "window"])
def test_set_values_and_peel_matches_jax(shape, transposed, values, max_sweeps):
    """The mask form (``values`` None: all 0) against JAX's pair, bit for
    bit; the decision alone kills columns (conflicts and contradictions),
    and the transposed pad rows stay inert."""
    rng = np.random.default_rng(31)
    H = _pcm(rng, shape)
    state = _entry_state(rng, H, 48)
    mask, vals = _decision(rng, state[0], {"random": 0.3, "window": 0.5}[shape])
    if values == "none":
        vals = np.zeros_like(vals)
    fn = tdec.set_values_and_peel_t if transposed else tdec.set_values_and_peel
    vt = torch.from_numpy(vals.T.copy() if transposed else vals)
    out, ref, decided, g = _run_both(
        H, state, transposed, max_sweeps, fn, mask, vals,
        set_mask=torch.from_numpy(mask.T.copy() if transposed else mask),
        values=None if values == "none" else vt.bool())
    _assert_equal(out, ref)
    assert np.asarray(decided[3]).sum() > state[3].sum()  # the decision killed columns
    assert (out[0].numpy() != -1).sum() > (np.asarray(decided[0]) != -1).sum()
    if transposed:
        m = H.shape[0]
        assert (out[1].numpy()[m:] == -1).all() and (out[2].numpy()[m:] == 0).all()
        assert g.m_pad > m


@pytest.mark.parametrize("max_sweeps", [None, 1])
@pytest.mark.parametrize("transposed", [False, True], ids=["batch_major", "transposed"])
@pytest.mark.parametrize("shape", ["random", "window"])
def test_set_index_and_peel_matches_jax(shape, transposed, max_sweeps):
    """The index form against JAX's pair on the one-hot the JAX decoders
    build, ``(VN == index) & do_set`` with the value broadcast, bit for
    bit: indices of decided VNs of either value, of undecided ones, out
    of range (n: sets nothing) and with ``do_set`` off."""
    rng = np.random.default_rng(37)
    H = _pcm(rng, shape)
    n = H.shape[1]
    state = _entry_state(rng, H, 64)
    vn = state[0]
    index = rng.integers(0, n, 64)
    undecided = [np.flatnonzero(r == -1) for r in vn]
    pick = rng.random(64) < 0.6  # most pick an undecided VN
    for b in np.flatnonzero(pick):
        if len(undecided[b]):
            index[b] = rng.choice(undecided[b])
    index[7] = n
    value = rng.integers(0, 2, 64).astype(np.int8)
    do_set = rng.random(64) < 0.85
    onehot = (np.arange(n)[None, :] == index[:, None]) & do_set[:, None]
    conflicts = do_set & (vn[np.arange(64), np.minimum(index, n - 1)] != -1) & (index < n)
    assert conflicts.any() and (do_set & ~conflicts).any()
    fn = tdec.set_index_and_peel_t if transposed else tdec.set_index_and_peel
    out, ref, _, _ = _run_both(
        H, state, transposed, max_sweeps, fn, onehot, np.repeat(value[:, None], n, 1),
        index=torch.from_numpy(index), value=torch.from_numpy(value),
        do_set=torch.from_numpy(do_set))
    _assert_equal(out, ref)


def test_no_decision_is_the_peel():
    """``peel`` runs the entry point with no decision: the same outputs as
    ``set_values_and_peel`` with an empty mask, and as JAX's ``peel``."""
    rng = np.random.default_rng(41)
    H = _pcm(rng, "random")
    g = compile_graph(H)
    gt, gj = graph_tensors(g, "cpu"), graph_device_arrays(g)
    st = tdec.init_decimation_state(gt, torch.from_numpy(
        rng.integers(0, 2, (32, H.shape[0])).astype(np.uint8)))
    st = tdec.vn_set_values(gt, *st, torch.from_numpy(rng.random((32, H.shape[1])) < 0.4),
                            torch.zeros((32, H.shape[1]), dtype=torch.int8))
    a = tdec.peel(gt, *st)
    b = tdec.set_values_and_peel(gt, *st, torch.zeros_like(st[0], dtype=torch.bool))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _assert_equal(a, jdec.peel(gj, *(jnp.asarray(x.numpy()) for x in st)))


@pytest.mark.parametrize("form", ["mask", "index"])
def test_decide_and_peel_refuses_other_devices(form):
    """On a tensor neither on the CPU nor on a card the entry points
    neither run the plain pair nor fall back: the kernel's wrapper raises,
    and no torch op of ``vn_set_values`` runs."""
    H = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    garr = graph_tensors(compile_graph(H), "cpu")
    state = (torch.zeros((4, 3), dtype=torch.int8, device="meta"),
             torch.zeros((4, 2), dtype=torch.int8, device="meta"),
             torch.zeros((4, 2), dtype=torch.int32, device="meta"),
             torch.zeros(4, dtype=torch.bool, device="meta"))
    before = peel_cuda.peel_fixpoint.plain_calls, tdec.vn_set_values.card_calls
    with pytest.raises(ValueError, match="unsupported device"):
        if form == "mask":
            tdec.set_values_and_peel(garr, *state, torch.zeros((4, 3), dtype=torch.bool,
                                                               device="meta"))
        else:
            z = torch.zeros(4, dtype=torch.int64, device="meta")
            tdec.set_index_and_peel(garr, *state, z, z.to(torch.int8), z.bool())
    assert (peel_cuda.peel_fixpoint.plain_calls, tdec.vn_set_values.card_calls) == before


def test_card_calls_counts_vn_set_values_on_a_card_only():
    """``vn_set_values.card_calls`` counts the torch ops' calls on a card's
    tensors (none here): the CPU calls of either form leave it as it is."""
    H = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    garr = graph_tensors(compile_graph(H), "cpu")
    st = tdec.init_decimation_state(garr, torch.zeros((2, 2), dtype=torch.uint8))
    before = tdec.vn_set_values.card_calls
    tdec.vn_set_values(garr, *st, torch.ones((2, 3), dtype=torch.bool),
                       torch.zeros((2, 3), dtype=torch.int8))
    st_t = tdec.init_decimation_state_t(garr, torch.zeros((2, 2), dtype=torch.uint8))
    tdec.vn_set_values_t(garr, *st_t, torch.ones((3, 2), dtype=torch.bool),
                         torch.zeros((3, 2), dtype=torch.int8))
    assert tdec.vn_set_values.card_calls == before
