"""Elastic recovery for multi-host Monte-Carlo sweeps (after the JAX
package's ``parallel/elastic.py``, on the port's ``parallel/checkpoint.py``).

The reference has no distributed runtime at all (SURVEY.md §5); here shot
ranges are statically partitioned over hosts (``host_shot_range``) with
disjoint derived RNG streams (``host_seed`` / ``batch_rng``), so failure
recovery needs no coordination protocol: a host is *lost* iff its
checkpoint stopped advancing, and its remaining shots can be re-run
anywhere because the randomness is a pure function of
(root_seed, process_id, batch_index) — not of which machine replays it.

``plan_recovery`` is the coordinator-side piece: given the checkpoint
directory it reports, per host, how far the accumulation got and exactly
which batch range a replacement worker must replay. Heartbeating is the
checkpoint mtime itself (a host that still decodes keeps writing).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from .checkpoint import MonteCarloCheckpoint


@dataclass(frozen=True)
class HostRecovery:
    process_id: int
    batches_done: int
    num_batches: int
    counts: dict
    stale_seconds: float | None  # None = no checkpoint file yet
    lost: bool = False  # set when plan_recovery is given stale_after

    @property
    def complete(self) -> bool:
        return self.batches_done >= self.num_batches

    @property
    def remaining_batches(self) -> range:
        return range(self.batches_done, self.num_batches)


def plan_recovery(
    checkpoint_dir: str,
    total_shots: int,
    batch_size: int,
    num_hosts: int,
    *,
    stale_after: float | None = None,
    now: float | None = None,
) -> dict[int, HostRecovery]:
    """Coordinator view of a (possibly interrupted) multi-host sweep.

    Returns per-host recovery records. With ``stale_after`` set, an
    incomplete host whose checkpoint has not been touched for that many
    seconds (relative to ``now``, default wall clock) gets ``lost=True``
    even mid-range (mtime heartbeat); its ``remaining_batches`` plus the
    persisted counts are everything a replacement needs. ``lost_hosts``
    applies the same rule to an existing plan.
    """
    from .distributed import host_shot_range

    now = time.time() if now is None else now
    out: dict[int, HostRecovery] = {}
    for pid in range(num_hosts):
        _, count = host_shot_range(total_shots, pid, num_hosts)
        num_batches = -(-count // batch_size) if count else 0
        ckpt = MonteCarloCheckpoint(checkpoint_dir, process_id=pid)
        state = ckpt.load()
        stale: float | None = None
        if state is None:
            done, counts = 0, {}
        else:
            done = int(state.get("batch_index", 0))
            counts = dict(state.get("counts", {}))
            try:
                stale = now - os.path.getmtime(ckpt._file)
            except OSError:
                stale = None
        incomplete = done < num_batches
        lost = (
            stale_after is not None
            and incomplete
            and (stale is None or stale > stale_after)
        )
        out[pid] = HostRecovery(
            process_id=pid,
            batches_done=done,
            num_batches=num_batches,
            counts=counts,
            stale_seconds=stale,
            lost=lost,
        )
    return out


def lost_hosts(
    plan: dict[int, HostRecovery], stale_after: float
) -> list[int]:
    """Hosts that are incomplete and either never checkpointed or whose
    heartbeat (checkpoint mtime) is older than ``stale_after`` seconds."""
    bad = []
    for pid, rec in plan.items():
        if rec.complete:
            continue
        if rec.stale_seconds is None or rec.stale_seconds > stale_after:
            bad.append(pid)
    return bad


def resume_lost_hosts(
    checkpoint_dir: str,
    total_shots: int,
    batch_size: int,
    num_hosts: int,
    run_batch_factory,
    *,
    stale_after: float,
    root_seed: int,
    checkpoint_every: int = 10,
) -> dict:
    """End-to-end elastic recovery: detect lost hosts and replay their
    remaining batches in the calling process.

    ``run_batch_factory(process_id)`` returns the host's
    ``run_batch(batch_index, shots)`` work function (typically a real
    decode batch through the port's decoders), which draws from
    ``checkpoint.batch_rng(root_seed, process_id, batch_index)`` (or seeds
    a ``torch.Generator`` with ``batch_seed``). Because the RNG stream is
    a pure function of (root_seed, process_id, batch_index), the replayed
    counts are exactly
    what the lost host would have produced. Returns the merged counts of
    the now-complete campaign; raises if any host is still incomplete
    afterwards (i.e. a live host is mid-range — call again later).
    """
    from .checkpoint import MonteCarloCheckpoint, run_checkpointed
    from .distributed import host_shot_range

    plan = plan_recovery(
        checkpoint_dir, total_shots, batch_size, num_hosts
    )
    for pid in lost_hosts(plan, stale_after):
        ckpt = MonteCarloCheckpoint(checkpoint_dir, process_id=pid)
        _, count = host_shot_range(total_shots, pid, num_hosts)
        run_checkpointed(
            count,
            batch_size,
            run_batch_factory(pid),
            ckpt,
            checkpoint_every=checkpoint_every,
            root_seed=root_seed,
        )
    plan = plan_recovery(checkpoint_dir, total_shots, batch_size, num_hosts)
    incomplete = [pid for pid, rec in plan.items() if not rec.complete]
    if incomplete:
        raise RuntimeError(
            f"hosts {incomplete} still incomplete after recovery (alive "
            "mid-range, or their replay failed)"
        )
    return merge_counts(plan)


def merge_counts(plan: dict[int, HostRecovery]) -> dict:
    """Aggregate persisted counters across hosts (the psum analog for
    recovery-time accounting)."""
    total: dict = {}
    for rec in plan.values():
        for k, v in rec.counts.items():
            total[k] = total.get(k, 0) + v
    return total
