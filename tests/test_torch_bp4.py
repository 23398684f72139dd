"""BP4, BP4+OSD, CAMEL and the depolarizing driver of the port against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages: the
[[72,12,6]] BB code (hx, hz 36x72, dv 3) and the [[362]] cycle-assembled
code (171x362, dc 20, whose last VN has degree 171 in both graphs), with
depolarizing samples and jittered priors where bit-exactness is claimed.

Tolerances, as measured:

- The CN stage (the port's plain ``_cn_update_sm``, kernel A's plain
  version, in BP4's slot-major layout) is bit-exact against JAX
  ``_cn_minsum_bm`` on every valid edge (invalid slots are 0 on both
  sides, of either sign in the kernel).
- ``bp4_run``: equal errors, convergence and iteration counts on every
  shot; posteriors and messages within an absolute 1e-3 after 20
  iterations (measured 4.8e-4 on posteriors up to 244): XLA's CPU
  ``exp``/``log1p`` differ from torch's by an ulp, and min-sum carries the
  difference on.
- ``BP4OSD`` (OSD-0, OSD-CS, OSD-E) and CAMEL: equal errors on every shot
  but where two candidates, or two CAMEL branches, have exactly equal f64
  path metrics (the port sums them exactly in f64, JAX in f32, which may
  round either lower); each such shot is named by the assertion. On
  [[362]] (dv 171) only the decisions are held equal: each side adds 171
  slots in its own order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import (
    bb_code_by_n,
    create_cycle_assemble_codes,
    create_cyclic_permuting_matrix,
    create_QC_GHP_codes,
)
from slidingwindowdecoder_torch.decoders.bp4 import BP4OSD
from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.harness.depolarizing import (
    depolarizing_decoding,
    sample_depolarizing,
)
from slidingwindowdecoder_torch.ops import bp4 as tb
from slidingwindowdecoder_torch.ops.bp import _cn_update_sm
from slidingwindowdecoder_torch.ops.bp_cuda import cn_update
from slidingwindowdecoder_tpu.decoders.bp4 import BP4OSD as JaxBP4OSD
from slidingwindowdecoder_tpu.graphs.tanner import compile_graph as jax_compile_graph
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.harness import depolarizing as jax_depolarizing
from slidingwindowdecoder_tpu.ops import bp4 as jb


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: these decodes are many small ops, and where
    the test workers share the cores more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _code(name: str):
    if name == "bb72":
        return bb_code_by_n(72)[0]
    return create_cycle_assemble_codes(19, 3)


def _samples(code, p: float, B: int, seed: int):
    ex, ez = sample_depolarizing(code.N, p, B, np.random.default_rng(seed))
    return ((ez @ code.hx.T) % 2).astype(np.uint8), ((ex @ code.hz.T) % 2).astype(np.uint8)


def _jittered(code, p: float, rng):
    """Per-qubit X, Y, Z probabilities near p/3, all distinct."""
    return tuple(np.full(code.N, p / 3) * (1 + 0.05 * rng.random(code.N)) for _ in range(3))


def _kw(probs, **kw):
    return dict(channel_probs_x=probs[0], channel_probs_y=probs[1], channel_probs_z=probs[2],
                **kw)


def test_cn_stage_matches_jax_on_valid_edges(rng):
    """Kernel A's plain version (through ``cn_update`` on CPU tensors) in
    BP4's layout against JAX ``_cn_minsum_bm``, with ties of |x|, equal
    values, zeros and values beyond the clip: bit-exact on valid edges."""
    code = _code("bb72")
    g = compile_graph(code.hx)
    B = 128
    mv = rng.standard_normal((g.m, g.dc, B)).astype(np.float32) * 30
    mv[:, 1][::3] = -mv[:, 0][::3]  # ties of |x|
    mv[:, 2][::5] = mv[:, 3][::5]  # equal values
    mv[:, 4][::7] = 0.0  # zeros count as negative
    mv[:, 5][::4] = 80.0  # beyond the clip
    par = rng.integers(0, 2, (B, g.m)).astype(np.int8)
    ref = np.asarray(jb._cn_minsum_bm(graph_device_arrays(jax_compile_graph(code.hx)),
                                      jnp.asarray(mv), jnp.asarray(par.T), alpha=0.625,
                                      clip=50.0))
    mv_sm = np.zeros((g.dc, g.m_pad, B), np.float32)
    mv_sm[:, : g.m] = mv.transpose(1, 0, 2)
    par_sm = np.zeros((g.m_pad, B), np.int32)
    par_sm[: g.m] = par.T
    valid = torch.from_numpy(g.cn_valid_sm)
    before = cn_update.plain_calls
    out = cn_update(torch.from_numpy(mv_sm), valid, torch.from_numpy(par_sm), alpha=0.625,
                    clip=50.0)
    assert cn_update.plain_calls == before + 1
    np.testing.assert_array_equal(
        out.numpy()[:, : g.m].transpose(1, 0, 2)[g.cn_valid].view(np.int32),
        ref[g.cn_valid].view(np.int32))
    assert (out.numpy()[~g.cn_valid_sm] == 0).all()
    torch.testing.assert_close(_cn_update_sm(torch.from_numpy(mv_sm), valid,
                                             torch.from_numpy(par_sm), alpha=0.625,
                                             clip=50.0), out, rtol=0, atol=0)


def test_col_sums_follow_slot_order():
    """``_col_sums`` on [[362]] (one VN of degree 171) equals the slot-by-
    slot sum of the padded gather, bit for bit."""
    code = _code("362")
    g = graph_tensors(compile_graph(code.hx), "cpu")
    tb.bp4_graph(g)
    assert g["dv"] == 171 and g["bp4_counts"][9:] == [1] * 162
    gen = torch.Generator().manual_seed(3)
    mc = torch.randn((g["dc"], g["m_pad"], 16), generator=gen)
    src = torch.cat([mc.reshape(-1, 16), torch.zeros((1, 16))])
    mcv = src[g["vn_from_cn_flat"]].reshape(g["n"], g["dv"], 16)
    acc = mcv[:, 0]
    for j in range(1, g["dv"]):
        acc = acc + mcv[:, j]
    torch.testing.assert_close(tb._col_sums(g, mc), acc, rtol=0, atol=0)


def test_bp4_run_matches_jax(rng):
    """20 iterations on 128 [[72]] shots at p = 0.08 with jittered X/Y/Z
    priors and a third of the shots with VN 5 decided (CAMEL's decimation,
    parities flipped as the driver does): errors, convergence and iteration
    counts equal; posteriors and messages within 1e-3."""
    code = _code("bb72")
    B = 128
    sx, sz = _samples(code, 0.08, B, 11)
    probs = np.stack(_jittered(code, 0.08, rng))
    llr = np.log((1 - probs.sum(0)) / probs).astype(np.float32)
    vn = np.full((B, code.N), -1, np.int8)
    vn[::3, 5] = rng.integers(0, 4, len(vn[::3]))
    cx, cz = sx.astype(np.int8), sz.astype(np.int8)
    dec = vn[:, 5] >= 0
    cx[np.ix_(dec, np.nonzero(code.hx[:, 5])[0])] ^= (vn[dec, 5] // 2)[:, None]
    cz[np.ix_(dec, np.nonzero(code.hz[:, 5])[0])] ^= (vn[dec, 5] % 2)[:, None]
    kw = dict(num_iter=20, alpha=0.8, clip=50.0)

    gxj = graph_device_arrays(jax_compile_graph(code.hx))
    gzj = graph_device_arrays(jax_compile_graph(code.hz))
    lj = [jnp.asarray(x) for x in llr]
    out_j = jb.bp4_run(gxj, gzj, *jb.bp4_init_messages(gxj, gzj, *lj, B), *lj,
                       jnp.asarray(sx), jnp.asarray(sz), jnp.asarray(vn), jnp.asarray(cx),
                       jnp.asarray(cz), jnp.zeros(B, bool), jnp.zeros(B, jnp.int32), **kw)
    out_j = [np.asarray(o) for o in out_j]
    gx = graph_tensors(compile_graph(code.hx), "cpu")
    gz = graph_tensors(compile_graph(code.hz), "cpu")
    lt = [torch.from_numpy(x) for x in llr]
    out_t = tb.bp4_run(gx, gz, *tb.bp4_init_messages(gx, gz, *lt, B), *lt,
                       *(torch.from_numpy(a) for a in (sx, sz, vn, cx, cz)),
                       torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32), **kw)
    out_t = [o.numpy() for o in out_t]
    for name, a, b in zip(("err_x", "err_z", "done", "iters"), out_t[5:], out_j[5:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(out_t[2:5], out_j[2:5]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    for t, j, H in ((out_t[0], out_j[0], code.hx), (out_t[1], out_j[1], code.hz)):
        g = compile_graph(H)
        np.testing.assert_allclose(t[:, : g.m].transpose(1, 0, 2)[g.cn_valid],
                                   j[g.cn_valid], rtol=0, atol=1e-3)
    assert 0 < out_t[7].mean() < 1  # some shots converged, some did not


def _assert_equal_or_tied(code, dec, res_t, res_j, sx, sz, exact_conv=True):
    """Equal errors on every shot but exact f64 ties of the path metric;
    each differing shot's errors satisfy both syndromes."""
    code_hx, code_hz = code.hx, code.hz
    if exact_conv:
        np.testing.assert_array_equal(res_t.converged, res_j.converged)
        np.testing.assert_array_equal(res_t.iterations, res_j.iterations)
    differ = np.nonzero((res_t.error != res_j.error).any(axis=(1, 2)))[0]
    llr = [v.astype(np.float64) for v in (dec.llr_x, dec.llr_y, dec.llr_z)]

    def pm(e):
        both = e[0] & e[1]
        return llr[1] @ both + llr[0] @ (e[0] & ~both) + llr[2] @ (e[1] & ~both)

    for b in differ:
        for r in (res_t, res_j):
            np.testing.assert_array_equal((code_hx @ r.error[b, 1]) % 2, sx[b], err_msg=str(b))
            np.testing.assert_array_equal((code_hz @ r.error[b, 0]) % 2, sz[b], err_msg=str(b))
        assert pm(res_t.error[b].astype(bool)) == pm(res_j.error[b].astype(bool)), b
    return differ


@pytest.mark.parametrize("method, order", [("osd_0", 0), ("osd_cs", 10), ("osd_e", 4)])
def test_bp4osd_matches_jax(rng, method, order):
    """BP4 + OSD per basis on 128 [[72]] shots at p = 0.1 with 6 BP4
    iterations (so that many reach OSD), jittered priors, 16-shot OSD
    buckets: equal errors on every shot but exact ties, equal convergence
    and iteration counts."""
    code = _code("bb72")
    sx, sz = _samples(code, 0.1, 128, 23)
    kw = _kw(_jittered(code, 0.1, rng), max_iter=6, ms_scaling_factor=0.9,
             osd_method=method, osd_order=order, osd_bucket=16)
    dec = BP4OSD(code.hx, code.hz, device="cpu", **kw)
    res_t = dec.decode_batch(sx, sz)
    res_j = JaxBP4OSD(code.hx, code.hz, **kw).decode_batch(sx, sz)
    assert 0.1 < 1 - res_t.converged.mean() < 0.7
    differ = _assert_equal_or_tied(code, dec, res_t, res_j, sx, sz)
    assert differ.size == 0, differ  # jittered priors leave no exact ties
    np.testing.assert_allclose(res_t.min_pm, res_j.min_pm, rtol=1e-6)
    # every output, BP4's or OSD's, satisfies both syndromes
    np.testing.assert_array_equal((res_t.error[:, 1] @ code.hx.T) % 2, sx)
    np.testing.assert_array_equal((res_t.error[:, 0] @ code.hz.T) % 2, sz)


@pytest.mark.parametrize("code_name, p, B, kw", [
    ("bb72", 0.05, 64, dict(max_iter=32, ms_scaling_factor=0.9)),
    ("362", 0.02, 8, dict(max_iter=50, ms_scaling_factor=0.8)),
], ids=["bb72", "362"])
def test_camel_matches_jax(code_name, p, B, kw):
    """CAMEL at the code's uniform depolarizing priors (so branches of equal
    weight tie exactly): the same branch on every shot but exact ties."""
    code = _code(code_name)
    sx, sz = _samples(code, p, B, 31)
    probs = (np.full(code.N, p / 3),) * 3
    kw = _kw(probs, osd_method="off", **kw)
    dec = BP4OSD(code.hx, code.hz, device="cpu", **kw)
    res_t = dec.camel_decode(sx, sz)
    res_j = JaxBP4OSD(code.hx, code.hz, **kw).camel_decode(sx, sz)
    np.testing.assert_array_equal(res_t.converged, res_j.converged)
    _assert_equal_or_tied(code, dec, res_t, res_j, sx, sz, exact_conv=code_name == "bb72")
    assert res_t.converged.mean() > 0.5


def test_depolarizing_harness_perp_orientation():
    """Residual-stabilizer corrections must not count as logical errors
    (the JAX package's test of the same name, on the port's codes): on a
    non-self-dual code a residual Z-stabilizer (row of hz) has no overlap
    with hz_perp, but may overlap hx_perp."""
    code = create_QC_GHP_codes(7, create_cyclic_permuting_matrix(7, [3, 5, 0]) % 2, [0, 1])
    assert not np.array_equal(code.hx, code.hz)  # non-self-dual
    hz_perp_T = code.hz_perp.T.astype(np.int64)
    hx_perp_T = code.hx_perp.T.astype(np.int64)
    dz = code.hz[:1].astype(np.int64)  # Z-stabilizer residual
    dx = code.hx[:1].astype(np.int64)  # X-stabilizer residual
    assert not ((dz @ hz_perp_T) % 2).any()
    assert not ((dx @ hx_perp_T) % 2).any()
    # the swapped orientation would (generically) flag these:
    assert ((dz @ hx_perp_T) % 2).any() or ((dx @ hz_perp_T) % 2).any()


@pytest.mark.parametrize("camel", [False, True], ids=["osd_cs", "camel"])
def test_depolarizing_decoding_matches_jax(camel):
    """``depolarizing_decoding`` on [[72]] at p = 0.06, 256 shots from seed
    7 in two batches: the JAX package's samples, failures and flags."""
    code = _code("bb72")
    kw = dict(max_iter=32, ms_scaling_factor=0.9, osd_method="off" if camel else "osd_cs",
              osd_order=0 if camel else 4, camel=camel, batch_size=128, seed=7,
              verbose=False)
    ex_t = sample_depolarizing(code.N, 0.06, 8, np.random.default_rng(1))
    ex_j = jax_depolarizing.sample_depolarizing(code.N, 0.06, 8, np.random.default_rng(1))
    for a, b in zip(ex_t, ex_j):
        np.testing.assert_array_equal(a, b)
    r_t = depolarizing_decoding(code, 0.06, 256, device="cpu", **kw)
    r_j = jax_depolarizing.depolarizing_decoding(code, 0.06, 256, **kw)
    for key in ("num_err", "num_flagged", "shots"):
        assert r_t[key] == r_j[key], key
    assert r_t["num_err"] > 0
