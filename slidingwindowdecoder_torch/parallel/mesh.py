"""Shot meshes over the process group, and the shot-sharded decode step
(after the JAX package's ``parallel/mesh.py``).

Shots are the data-parallel axis: one rank a device, each rank holding the
contiguous block of shots that ``PartitionSpec(axis, None)`` gives a
device in JAX. Decode state stays rank-local, and the only communication
is the reduction of scalar counts, one ``all_reduce`` a batch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .distributed import global_sum, host_shot_range


@dataclass(frozen=True)
class ShotMesh:
    """A 1-D mesh over the shot axis: this process's ``rank`` of ``size``
    ranks, its ``device``, and the process group (None: one process, no
    group)."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    def rows(self, total: int) -> slice:
        """This rank's contiguous block of ``total`` shots; ``total`` must
        divide over the ranks."""
        if total % self.size:
            raise ValueError(f"batch {total} must divide the mesh size {self.size}")
        start, count = host_shot_range(total, self.rank, self.size)
        return slice(start, start + count)


def make_shot_mesh(device=None) -> ShotMesh:
    """The shot mesh over the initialized process group (all its ranks),
    or over this process alone when none is initialized.

    ``device`` None means "cuda" (raises without a card): rank r then runs
    on ``cuda:LOCAL_RANK`` (default r modulo the cards of its host); pass
    ``device="cpu"`` to run every rank on its CPU (a ``gloo`` group).
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        return ShotMesh(0, 1, dev)
    rank, size = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    return ShotMesh(rank, size, dev, dist.group.WORLD)


def shard_over_shots(mesh: ShotMesh, array) -> torch.Tensor:
    """This rank's rows of a [B, ...] array, on the mesh's device."""
    rows = mesh.rows(array.shape[0])
    return torch.as_tensor(array[rows], device=mesh.device)


def shard_decode_step(mesh: ShotMesh, mat, prior, syndromes, *, num_iter: int = 32,
                      alpha: float = 1.0):
    """One sharded decode step: BP, the OSD-0 fallback for the shots BP
    left unconverged, and the failure count over the mesh.

    ``syndromes`` [B, m] is the whole batch (B must divide over the
    ranks); this rank decodes its block of rows (``ShotMesh.rows``). On the
    card BP is one ``bp_span`` launch and OSD-0 one ``gauss_jordan_key``
    launch. Returns {"error": this rank's rows [B / size, n] (uint8),
    "num_errors": the shots over the whole mesh whose correction misses
    its syndrome (int)}.
    """
    from ..decoders.bposd import osd_tables
    from ..graphs.tanner import compile_graph, graph_tensors
    from ..ops.bp import decode_bp
    from ..ops.gf2_solve import gf2_rank_packed, osd_decode
    from ..windows.pipeline import _gf2_matmul

    mat = np.asarray(mat)
    m, n = mat.shape
    dev = mesh.device
    garr = graph_tensors(compile_graph(mat), device=dev)
    prior = np.asarray(prior)
    llr = torch.as_tensor(np.log((1 - prior) / prior).astype(np.float32), device=dev)
    rank = gf2_rank_packed(mat)
    H_words, _, meta = osd_tables(mat, n - rank, 0, "osd_0", dev)

    synds = shard_over_shots(mesh, np.asarray(syndromes)).to(torch.uint8)
    out = decode_bp(garr, llr, synds, num_iter=num_iter, alpha=alpha)
    osd = osd_decode(H_words, synds, out["llr_sum"], llr, m=m, n=n, rank=rank,
                     k=n - rank, meta=meta)
    error = torch.where(out["converged"][:, None], out["error"].to(torch.uint8),
                        osd["solution"].to(torch.uint8))
    mat_t = torch.as_tensor(mat.T, dtype=torch.float32, device=dev)
    failed = (_gf2_matmul(error, mat_t) != synds).any(dim=1)
    num_errors = global_sum(int(failed.sum()), mesh.group)
    return {"error": error, "num_errors": int(num_errors)}
