"""The port's plain path against the JAX package, per shot, on the
[[144,12,12]] sliding-window paths whose failure gates in ``chip_smoke.py``
are the port's own counts: the shortened ``OSDWindow`` decode (p=0.004)
and GDG (p=0.005), 12 rounds, (W, F) = (3, 1), f32, on the first 128
shots of the seed-2024 samples that the smoke script decodes (16384 and
8192 shots drawn; a draw's first rows do not depend on its size).

Marked ``slow`` (tens of minutes on the CPU): run it with
``JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_main_paths_jax.py``.
Every shot must agree; an exact tie (ROADMAP section 3) would show here
as a differing shot and fail the test.
"""

import contextlib

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import sample_dem_numpy
from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_torch.windows import pipeline as tp
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.decoders import OSDWindow as JOSDWindow
from slidingwindowdecoder_tpu.windows import pipeline as jp

pytestmark = pytest.mark.slow

SHOTS, SEED = 128, 2024


@contextlib.contextmanager
def _torch_threads(k):
    n = torch.get_num_threads()
    torch.set_num_threads(min(k, n))
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _samples(p, drawn):
    _, _, dem, plan = tcl.build_bb_window_experiment(144, p, 12, 3, 1)
    det, obs, _ = sample_dem_numpy(dem, drawn, np.random.default_rng(SEED))
    return plan, det[:SHOTS], obs[:SHOTS]


def _compare(plan, det, obs, factory_t, factory_j):
    with _torch_threads(4):
        out_t = tp.decode_sliding_window(plan, det, factory_t, device="cpu", verbose=False)
    ev_t = tp.evaluate_logical_errors(plan, det, obs, out_t["total_e_hat"], device="cpu")
    out_j = jp.decode_sliding_window(plan, det, factory_j, verbose=False)
    ev_j = jp.evaluate_logical_errors(plan, det, obs, out_j["total_e_hat"])
    e_t, e_j = out_t["total_e_hat"].numpy(), np.asarray(out_j["total_e_hat"])
    differ = np.nonzero((e_t != e_j).any(axis=1))[0]
    print(f"failed {ev_t['num_failed']} (JAX {ev_j['num_failed']}), flagged "
          f"{ev_t['num_flagged']} (JAX {ev_j['num_flagged']}), shots differing "
          f"{differ.tolist()}")
    assert not len(differ)
    assert (ev_t["num_failed"], ev_t["num_flagged"]) == (ev_j["num_failed"],
                                                          ev_j["num_flagged"])


def test_shortened_path_matches_jax_per_shot():
    plan, det, obs = _samples(0.004, 16384)
    kw = dict(pre_max_iter=8, post_max_iter=200, osd_method="osd_cs", osd_order=10)
    _compare(plan, det, obs, tcl.window_decoder_factory(True, device="cpu"),
             jp.CachingDecoderFactory(lambda s: JOSDWindow(s.mat, s.prior, **kw)))


def test_gdg_path_matches_jax_per_shot():
    plan, det, obs = _samples(0.005, 8192)
    _compare(plan, det, obs,
             tcl.gdg_window_factory(max_iter=8, ensemble_bucket=32, device="cpu"),
             jp.CachingDecoderFactory(lambda s: JGDG(
                 s.mat, s.prior, max_iter=8, ensemble_bucket=32,
                 ensemble_mode="host_loop")))
