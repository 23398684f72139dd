"""One rank of the two-process ``torch.distributed`` (gloo) test of the
port's sharded window pipeline, spawned by
``tests/test_torch_parallel.py::test_two_process_sharded_pipeline`` (not a
test itself).

The rank joins the group named by ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``, decodes its block of the [[72]] x3, W=2
samples through ``decode_sliding_window_sharded``, reduces the counts with
``evaluate_logical_errors_sharded`` and its own failures with
``global_sum``, and prints one JSON line.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from slidingwindowdecoder_torch.circuits import sample_dem_numpy  # noqa: E402
from slidingwindowdecoder_torch.decoders import BPOSD  # noqa: E402
from slidingwindowdecoder_torch.harness.circuit_level import (  # noqa: E402
    build_bb_window_experiment,
)
from slidingwindowdecoder_torch.parallel.distributed import (  # noqa: E402
    global_sum,
    initialize_distributed,
    shutdown_distributed,
)
from slidingwindowdecoder_torch.parallel.mesh import make_shot_mesh  # noqa: E402
from slidingwindowdecoder_torch.windows.pipeline import (  # noqa: E402
    CachingDecoderFactory,
    decode_sliding_window_sharded,
    evaluate_logical_errors_sharded,
)

# the experiment and knobs the test's single-process decode uses
EXP = (72, 0.02, 3, 2, 1)
SHOTS, SEED = 64, 2024
KNOBS = dict(max_iter=30, osd_method="osd_cs", osd_order=4, bp_bucket=16, osd_bucket=16,
             phase_a_iters=None, phase_b_spans=None)


def samples():
    _, _, dem, plan = build_bb_window_experiment(*EXP)
    det, obs, _ = sample_dem_numpy(dem, SHOTS, np.random.default_rng(SEED))
    return plan, det, obs


def factory(device):
    return CachingDecoderFactory(lambda spec: BPOSD(spec.mat, spec.prior, device=device,
                                                    **KNOBS))


def main() -> None:
    torch.set_num_threads(1)
    info = initialize_distributed(device="cpu", timeout_s=120)
    try:
        mesh = make_shot_mesh("cpu")
        plan, det, obs = samples()
        out = decode_sliding_window_sharded(plan, det, factory("cpu"), mesh)
        ev = evaluate_logical_errors_sharded(plan, det, obs, out["total_e_hat"], mesh)
        local_failed = int(ev["failed"].sum())
        print(json.dumps({
            "rank": info["process_id"], "size": info["num_processes"],
            "devices": [str(d) for d in info["devices"]],
            "rows": out["total_e_hat"].numpy().tolist(),
            "num_failed": ev["num_failed"], "num_flagged": ev["num_flagged"],
            "local_failed": local_failed, "global_failed": global_sum(local_failed),
        }), flush=True)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
