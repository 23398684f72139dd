"""Multi-process initialization and collective helpers over
``torch.distributed`` (after the JAX package's ``parallel/distributed.py``).

Monte-Carlo scales over processes with shot-sharded meshes: one rank a
device (``parallel.mesh``). All decode state is rank-local; the only
traffic between ranks is the reduction of scalar counts (an
``all_reduce``), plus the rendezvous that ``init_process_group`` makes.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def _local_devices(dev: torch.device) -> list[torch.device]:
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Initialize the default process group when running multi-process;
    initialize nothing otherwise.

    The arguments default to the standard variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator ``host:port``), ``WORLD_SIZE`` and
    ``RANK``. Without an address no group is made (one process). The
    backend is ``nccl`` for a CUDA ``device`` (None means "cuda"; raises
    without a card) and ``gloo`` for the CPU; ``timeout_s`` bounds every
    collective of the group, so a lost peer raises instead of hanging.

    Returns {"process_id", "num_processes", "local_devices", "devices"}:
    the devices this process sees, and one device a rank (a rank r of a
    CUDA group runs on ``cuda:LOCAL_RANK`` of its host).
    """
    dev = resolve_device(device)
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address and not dist.is_initialized():
        num_processes = int(os.environ.get("WORLD_SIZE", "1")
                            if num_processes is None else num_processes)
        process_id = int(os.environ.get("RANK", "0") if process_id is None else process_id)
        kw = {}
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=timedelta(seconds=timeout_s), **kw,
        )
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    local = _local_devices(dev)
    return {
        "process_id": rank,
        "num_processes": world,
        "local_devices": local,
        "devices": [local[r % len(local)] for r in range(world)],
    }


def shutdown_distributed() -> None:
    """Destroy the default process group if one exists."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_shot_range(total_shots: int, process_id: int, num_processes: int):
    """Disjoint contiguous shot range for this host (remainder spread)."""
    base = total_shots // num_processes
    extra = total_shots % num_processes
    start = process_id * base + min(process_id, extra)
    count = base + (1 if process_id < extra else 0)
    return start, count


def host_seed(root_seed: int, process_id: int) -> np.random.Generator:
    """Independent per-host RNG stream (disjoint by construction)."""
    return np.random.default_rng(np.random.SeedSequence([root_seed, process_id]))


def global_sums(values, group=None) -> list[float]:
    """Sum process-local scalars over the group's processes: one
    ``all_reduce`` of a float64 vector on the group's device (exact for
    integer counts below 2**53). With one process (or none initialized)
    the values themselves."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return [float(v) for v in values]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    x = torch.tensor([float(v) for v in values], dtype=torch.float64, device=dev)
    dist.all_reduce(x, group=group)
    return x.tolist()


def global_sum(value: int | float, group=None) -> float:
    """Sum a process-local scalar over the group's processes
    (``global_sums`` of one value)."""
    return global_sums([value], group)[0]
