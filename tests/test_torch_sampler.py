"""The port's on-device DEM sampler (``circuits.make_dem_sampler``) on the
CPU. The JAX sampler draws from JAX's PRNG, which the port does not
reproduce, so the two are not compared draw for draw: the port's samples
are held to their own GF(2) products (exact) and to the DEM's priors (3
sigma in all, 5 sigma a fault), and one generator seed gives one set of
draws."""

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import make_dem_sampler
from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
from slidingwindowdecoder_tpu.circuits import make_dem_sampler as jax_sampler

SHOTS = 4096


@pytest.fixture(scope="module")
def dem():
    _, _, dem, _ = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    return dem


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_products_are_exact(dem):
    det, obs, faults = make_dem_sampler(dem, "cpu")(torch.Generator().manual_seed(3), SHOTS)
    assert (det.shape, obs.shape, faults.shape) == (
        (SHOTS, dem.chk.shape[0]), (SHOTS, dem.obs.shape[0]), (SHOTS, dem.num_faults))
    assert det.dtype == obs.dtype == faults.dtype == torch.uint8
    f = faults.numpy().astype(np.int64)
    np.testing.assert_array_equal(det.numpy(), f @ dem.chk.T.astype(np.int64) % 2)
    np.testing.assert_array_equal(obs.numpy(), f @ dem.obs.T.astype(np.int64) % 2)


def test_rates_follow_the_priors(dem):
    _, _, faults = make_dem_sampler(dem, "cpu")(torch.Generator().manual_seed(4), SHOTS)
    counts = faults.numpy().sum(axis=0, dtype=np.int64)
    pr = dem.priors.astype(np.float64)
    total_sigma = np.sqrt(SHOTS * (pr * (1 - pr)).sum())
    assert abs(counts.sum() - SHOTS * pr.sum()) <= 3 * total_sigma
    assert (np.abs(counts - SHOTS * pr) <= 5 * np.sqrt(SHOTS * pr * (1 - pr))).all()


def test_same_seed_same_draws(dem):
    sample = make_dem_sampler(dem, "cpu")
    a = sample(torch.Generator().manual_seed(11), 256)
    b = sample(torch.Generator().manual_seed(11), 256)
    c = sample(torch.Generator().manual_seed(12), 256)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[2], c[2])


def test_matches_the_jax_samplers_contract(dem):
    """Same outputs, shapes and dtypes as the JAX sampler, each side's
    detectors and observables the GF(2) products of its own faults."""
    import jax

    jd, jo, jf = (np.asarray(x) for x in jax_sampler(dem)(jax.random.PRNGKey(0), 64))
    td, to, tf = (x.numpy() for x in make_dem_sampler(dem, "cpu")(torch.Generator(), 64))
    for a, b in ((jd, td), (jo, to), (jf, tf)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    np.testing.assert_array_equal(jd, jf.astype(np.int64) @ dem.chk.T % 2)
