"""The benchmark's yardsticks alone: the seeded pool, the idle gaps' host
spans, the fused-BP bound."""

import torch

from benchmark.dem import build_dem
from benchmark.profile_read import _idle_by_span, _name
from benchmark.roofline import FP32_OPS_PER_S, HBM_BYTES_PER_S, span_bound_s
from benchmark.sampler import sample_pool


def test_pool_follows_the_seed():
    dem = build_dem(72, 3, 0.005)
    a = sample_pool(dem, 2, 32, 2**31 + 1, "cpu")
    b = sample_pool(dem, 2, 32, 2**31 + 1, "cpu")
    c = sample_pool(dem, 2, 32, 2**31 + 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0][0], a[0][1])  # the pool's batches differ
    assert a[0].shape == (2, 32, dem.chk.shape[0]) and a[1].shape == (2, 32, dem.obs.shape[0])


def test_idle_gaps_take_the_innermost_span():
    ranges = [(0, 100, "batch"), (10, 40, "core"), (12, 20, "osd"), (50, 90, "window")]
    gaps = [(14, 16), (30, 34), (60, 70), (95, 99), (120, 130)]
    idle = _idle_by_span(gaps, ranges)
    assert idle == {"osd": 2e-6, "core": 4e-6, "window": 10e-6, "batch": 4e-6,
                    "outside spans": 10e-6}


def test_kernel_names():
    assert _name("void (anonymous namespace)::bp_span_kernel<float, 8>(Args)") == \
        "bp_span_kernel<float, 8>"


def test_span_bound():
    # 2 columns x 10 iterations of a 3-check, 4-variable graph with 6 edges
    ops = 20 * (6 * 25 + 4 * 3)
    nbytes = 2 * (2 * 6 * 2 + 8 * 3 + 4) + 4 * 16
    want = max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
    got = span_bound_s(live=2, shot_iters=20, hist_writes=16, edges=6, n=4, m=3,
                       msg_bytes=2, ring_bytes=4, masked=False)
    assert got == want
    t = span_bound_s(live=torch.tensor(2.0, dtype=torch.float64),
                     shot_iters=torch.tensor(20.0, dtype=torch.float64),
                     hist_writes=torch.tensor(16.0, dtype=torch.float64), edges=6, n=4, m=3,
                     msg_bytes=2, ring_bytes=4, masked=False)
    assert float(t) == want
