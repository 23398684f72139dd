"""Accumulation checkpoints for long Monte-Carlo sweeps (after the JAX
package's ``parallel/checkpoint.py``, which uses numpy only).

The reference loses all progress on interruption (10^7-shot sweeps take
hours, Data noise.ipynb cell 9). Here each host periodically persists
{shots_done, error counts, RNG derivation state} atomically and can
resume; a lost host's shot range can simply be re-run because per-host
streams are disjoint (each is derived from its ``process_id``).

RNG contract: randomness is *derived*, not carried — every batch's
generator is seeded with ``batch_seed(root_seed, process_id,
batch_index)``, a pure function, so resuming at batch ``i`` replays
exactly the stream an uninterrupted run would have used (tested by
tests/test_torch_code_capacity.py::test_checkpointed_campaign_resumes). The
checkpoint records ``root_seed`` and refuses to resume under a different
one.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def batch_seed(root_seed: int, process_id: int, batch_index: int) -> int:
    """The 63-bit generator seed of one (host, batch): pure in its
    arguments (the JAX package's ``batch_rng`` derivation,
    ``SeedSequence([root_seed, process_id, batch_index])``)."""
    ss = np.random.SeedSequence([int(root_seed), int(process_id), int(batch_index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class MonteCarloCheckpoint:
    def __init__(self, path: str, process_id: int = 0):
        self.path = path
        self.process_id = process_id
        self._file = os.path.join(path, f"mc_host{process_id}.json")

    def load(self) -> dict | None:
        """Resume state, or None when starting fresh."""
        try:
            with open(self._file) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def save(self, state: dict) -> None:
        """Atomic write (tmp + rename) of the accumulation state."""
        os.makedirs(self.path, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self._file)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def clear(self) -> None:
        if os.path.exists(self._file):
            os.unlink(self._file)


def run_checkpointed(
    total_shots: int,
    batch_size: int,
    run_batch,
    checkpoint: MonteCarloCheckpoint,
    *,
    checkpoint_every: int = 10,
    root_seed: int | None = None,
):
    """Drive ``run_batch`` to completion with periodic checkpoints.

    ``run_batch(batch_index, shots)`` derives its randomness from its
    batch index (``batch_seed``), so an interrupted and resumed run
    accumulates *identical* counts to an uninterrupted one. ``root_seed``
    is persisted, and a checkpoint written under another seed is refused.

    Accumulates integer counters returned by each batch; persists every
    ``checkpoint_every`` batches; resumes from the saved batch index.
    """
    state = checkpoint.load() or {
        "batch_index": 0,
        "counts": {},
        "shots_done": 0,
        "root_seed": root_seed,
    }
    if root_seed is not None and state.get("root_seed") not in (None, root_seed):
        raise ValueError(
            f"checkpoint was written with root_seed={state['root_seed']}; "
            f"refusing to resume with root_seed={root_seed} (counts would mix "
            "two different random streams)"
        )
    batch_index = state["batch_index"]
    counts: dict = dict(state["counts"])
    shots_done = state["shots_done"]

    num_batches = -(-total_shots // batch_size)
    while batch_index < num_batches:
        shots = min(batch_size, total_shots - batch_index * batch_size)
        result = run_batch(batch_index, shots)
        for key, val in result.items():
            counts[key] = counts.get(key, 0) + int(val)
        shots_done += shots
        batch_index += 1
        if batch_index % checkpoint_every == 0 or batch_index == num_batches:
            checkpoint.save(
                {
                    "batch_index": batch_index,
                    "counts": counts,
                    "shots_done": shots_done,
                    "root_seed": root_seed,
                }
            )
    return {"counts": counts, "shots_done": shots_done}
