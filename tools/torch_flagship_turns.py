#!/usr/bin/env python3
"""The flagship decode's rate on one tree of the port, for comparing two
trees in one call on one card.

Imports ``chip_smoke.py`` and the package from ``TREE`` (a checkout, e.g.
the parent commit unpacked with ``git archive`` under ``build/``, which
git ignores), builds the kernels, and decodes the flagship experiment
([[144,12,12]], 12 rounds, p=0.004, (W,F) = (3,1), BP+OSD-CS-10 with the
bench knobs, bf16, 16384 seed-2024 shots) three times through that
tree's ``chip_smoke.phase_path``, which holds each decode to 414 failures
and to its kernels. The first decode of a process runs cold.

    python3 tools/torch_flagship_turns.py TREE

Run it in turns, parent, change, change, parent, in one call. Prints one
JSON line: the tree and the three rates (shots/s).
"""

import json
import sys


def main() -> int:
    tree = sys.argv[1]
    sys.path.insert(0, tree)
    import numpy as np

    import chip_smoke as smoke
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        window_decoder_factory,
    )

    smoke.phase_build()
    _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    det, obs, _ = sample_dem_numpy(dem, smoke.REF_SHOTS, np.random.default_rng(smoke.SEED))
    rates = []
    for _ in range(3):
        factory = window_decoder_factory(False, device="cuda", **smoke.FLAGSHIP_KNOBS)
        r = smoke.phase_path("main", plan, det, obs, factory, 12,
                             (smoke.REF_FAILED, smoke.REF_SHOTS), smoke.REF_FAILED,
                             ("bp_span", "osd_cs_fused"))
        rates.append(r["shots_per_s"])
    print(json.dumps({"tree": tree, "flagship_shots_per_s": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
