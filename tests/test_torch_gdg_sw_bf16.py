"""``sliding_window_gdg`` at the JAX package's GDG parity knobs (bf16
messages and ring, the span-compacted ensemble in 512-shot buckets,
``tools/validate_parity.py:88-112``) against the JAX package's own
``sliding_window_gdg`` on the CPU.

The experiment is the [[72]] x3 W=2 smoke experiment of
``test_torch_gdg.py`` (p=0.01, pre-BP 8, seed 2024), at 64 shots. The JAX
side runs its host-stepped ensemble in 64-shot buckets: its own tests hold
that form bit-identical to its spans form (tests/test_gdg.py), which takes
over two minutes to compile on a CPU. Corrections, failures and flags must be
equal.
"""

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_tpu.harness import circuit_level as jcl

SW = dict(N=72, p=0.01, num_repeat=3, num_shots=64, W=2, F=1, max_iter=8, seed=2024,
          verbose=False, msg_dtype="bfloat16", hist_dtype="bfloat16")


@pytest.fixture(autouse=True)
def two_threads():
    """The test workers share the cores: a decode of many small ops on
    many threads spends its time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_sliding_window_gdg_bf16_spans_matches_jax():
    seen, pipeline = [], jcl.decode_sliding_window

    def keep_total(*a, **k):
        out = pipeline(*a, **k)
        seen.append(np.asarray(out["total_e_hat"]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "decode_sliding_window", keep_total)
        rj = jcl.sliding_window_gdg(ensemble_mode="host_loop", ensemble_bucket=64, **SW)
    rt = tcl.sliding_window_gdg(device="cpu", ensemble_mode="spans", ensemble_bucket=512,
                                **SW)
    np.testing.assert_array_equal(rt["total_e_hat"].numpy(), seen[-1])
    for k in ("num_failed", "num_flagged", "num_windows", "ler"):
        assert rt[k] == rj[k], k
    assert rt["num_failed"] > 0
