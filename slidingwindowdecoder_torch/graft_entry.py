"""Driver entry points of the port (after the JAX package's root
``__graft_entry__.py``): a single-device forward step and a multi-rank
dry run.

``entry(device)`` returns a batched BP decode step over the [[72]] W=3
window-0 PCM and its example arguments.

``dryrun_multichip(n)`` runs the five decoder families' cores sharded
over the shots of an ``n``-rank process group (``torch.distributed``; one
process a rank, spawned here), and holds every rank's rows and every
reduced count against the same cores run in this process alone:

    python -m slidingwindowdecoder_torch.graft_entry --dryrun 2 --device cpu

A CUDA group is ``nccl`` with one rank a card (NCCL cannot put two ranks
on one card), so one H100 takes ``n = 1``; a CPU group is ``gloo``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
SHOTS_PER_RANK = 4


def _window_setup(N=72, num_repeat=3, W=3, F=1, p=0.004):
    from .harness.circuit_level import build_bb_window_experiment

    code, _, dem, plan = build_bb_window_experiment(N, p, num_repeat, W, F, method=1)
    return code, dem, plan


def entry(device=None):
    """(fn, example_args): batched BP decode (16 iterations, min-sum 1.0)
    of 32 syndromes on the [[72]] W=3 window-0 PCM, on ``device`` (None
    means "cuda"; raises without a card). ``fn(*args)`` returns (error,
    converged, llr_sum)."""
    from .graphs.tanner import compile_graph, graph_tensors
    from .ops.bp import decode_bp

    dev = resolve_device(device)
    _, _, plan = _window_setup()
    spec = plan.windows[0]
    garr = graph_tensors(compile_graph(spec.mat), dev)
    llr = torch.as_tensor(np.log((1 - spec.prior) / spec.prior).astype(np.float32), device=dev)
    synds = torch.zeros((32, spec.mat.shape[0]), dtype=torch.uint8, device=dev)

    def fn(garr, llr, synds):
        out = decode_bp(garr, llr, synds, num_iter=16, alpha=1.0)
        return out["error"], out["converged"], out["llr_sum"]

    return fn, (garr, llr, synds)


def sharded_cores(mesh, shots: int | None = None) -> dict:
    """The five cores of the JAX ``dryrun_multichip`` on ``mesh``'s rank:
    its rows of ``shots`` (default ``SHOTS_PER_RANK * mesh.size``) shots of
    each input (made from fixed seeds). Returns, by core, this rank's corrections (uint8)
    and the counts reduced over the mesh:

    - ``flagship``: the [[144]] W=3 BP(200)+OSD-CS-10 window pipeline
      (``decode_sliding_window_sharded`` and
      ``evaluate_logical_errors_sharded``);
    - ``osd_window``: the shortened ``OSDWindow`` pipeline on [[72]]x3;
    - ``gdg``: GDG's spans ensemble on [[72]] code capacity, p = 0.05;
    - ``bpgd``: BPGD's spans core on the same syndromes;
    - ``bp4``: BP4+OSD-0 on [[72]] under depolarizing-like X and Z flips.
    """
    from .circuits import sample_dem_numpy
    from .codes import bb_code_by_n
    from .decoders import BPGD, BPOSD, GDG, BP4OSD
    from .decoders.osd_window import OSDWindow
    from .parallel.distributed import global_sum
    from .parallel.mesh import shard_over_shots
    from .windows.pipeline import (
        CachingDecoderFactory,
        decode_sliding_window_sharded,
        evaluate_logical_errors_sharded,
    )

    dev, B = mesh.device, shots or SHOTS_PER_RANK * mesh.size
    out = {}

    def pipeline(name, plan, det, obs, build):
        res = decode_sliding_window_sharded(plan, det, CachingDecoderFactory(build), mesh)
        ev = evaluate_logical_errors_sharded(plan, det, obs, res["total_e_hat"], mesh)
        out[name] = {"rows": res["total_e_hat"].cpu().numpy(),
                     "counts": {"failed": ev["num_failed"], "flagged": ev["num_flagged"]}}

    _, dem, plan = _window_setup(144, 12)
    det, obs, _ = sample_dem_numpy(dem, B, np.random.default_rng(0))
    pipeline("flagship", plan, det, obs, lambda spec: BPOSD(
        spec.mat, spec.prior, max_iter=200, ms_scaling_factor=1.0, osd_method="osd_cs",
        osd_order=10, bp_bucket=4, osd_bucket=4, device=dev))
    _, dem2, plan2 = _window_setup()
    det2, obs2, _ = sample_dem_numpy(dem2, B, np.random.default_rng(1))
    pipeline("osd_window", plan2, det2, obs2, lambda spec: OSDWindow(
        spec.mat, spec.prior, pre_max_iter=8, post_max_iter=30, osd_method="osd_cs",
        osd_order=4, bucket=4, device=dev))

    code, _, _ = bb_code_by_n(72)
    p = 0.05
    rng = np.random.default_rng(2)
    errs = (rng.random((B, code.N)) < p).astype(np.uint8)
    synds = shard_over_shots(mesh, (errs @ code.hx.T) % 2).to(torch.uint8)
    probs = np.full(code.N, p)

    def core(name, res):
        conv = global_sum(int(res["converged"].sum()), mesh.group)
        out[name] = {"rows": res["error"].to(torch.uint8).cpu().numpy(),
                     "counts": {"converged": int(conv)}}

    core("gdg", GDG(code.hx, probs, max_iter=8, max_iter_per_step=4, max_step=8,
                    max_tree_depth=2, max_side_depth=4, ensemble_mode="spans",
                    ensemble_bucket=4, row_bucket=32, device=dev).core(synds))
    core("bpgd", BPGD(code.hx, probs, max_iter=8, max_iter_per_step=4, max_step=16,
                      mode="spans", row_bucket=32, device=dev).core(synds))
    p4 = 0.03
    rng4 = np.random.default_rng(3)
    ex = (rng4.random((B, code.N)) < p4).astype(np.uint8)
    ez = (rng4.random((B, code.N)) < p4).astype(np.uint8)
    sx = shard_over_shots(mesh, (ez @ code.hx.T) % 2).to(torch.uint8)
    sz = shard_over_shots(mesh, (ex @ code.hz.T) % 2).to(torch.uint8)
    probs4 = np.full(code.N, p4)
    core("bp4", BP4OSD(code.hx, code.hz, channel_probs_x=probs4, channel_probs_y=probs4,
                       channel_probs_z=probs4, max_iter=8, osd_method="osd_0", osd_bucket=4,
                       device=dev).core(sx, sz))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, *, device=None, timeout_s: float = 900.0) -> dict:
    """Run ``sharded_cores`` over an ``n_devices``-rank group, one spawned
    process a rank (``device`` None means "cuda", one card a rank, nccl;
    "cpu" means gloo), and hold each rank's rows and the reduced counts
    against ``sharded_cores`` of this process alone on ``device``. Raises
    if a rank fails, times out or disagrees. Returns, by core, the counts
    and the shots."""
    from .parallel.mesh import ShotMesh

    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} cards (nccl: one rank a "
                         f"card); {torch.cuda.device_count()} present")
    port = _free_port()
    procs = []
    for rank in range(n_devices):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(n_devices), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
        if dev.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "slidingwindowdecoder_torch.graft_entry", "--rank-of-dryrun",
             "--device", dev.type],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    ranks = {}
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=timeout_s)
            if proc.returncode != 0:
                raise RuntimeError(f"dryrun rank {rank} exited {proc.returncode}:\n"
                                   f"{stderr[-3000:]}")
            ranks[rank] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    B = SHOTS_PER_RANK * n_devices
    ref = sharded_cores(ShotMesh(0, 1, dev), B)
    summary = {}
    for name, r in ref.items():
        rows = np.concatenate([_unpack(ranks[k][name]["rows"]) for k in range(n_devices)])
        if not np.array_equal(rows, r["rows"]):
            raise RuntimeError(f"dryrun {name}: the ranks' rows differ from one process's")
        for k in range(n_devices):
            if ranks[k][name]["counts"] != r["counts"]:
                raise RuntimeError(f"dryrun {name}: rank {k} reduced {ranks[k][name]['counts']}, "
                                   f"one process counts {r['counts']}")
        summary[name] = {**r["counts"], "shots": B}
        print(f"dryrun_multichip: {name} ran sharded over {n_devices} ranks ({dev.type}); "
              f"{r['counts']} of {B}, every rank's rows equal to one process's", flush=True)
    return summary


def _pack(rows: np.ndarray) -> dict:
    return {"shape": list(rows.shape), "bits": np.packbits(rows.reshape(-1)).tobytes().hex()}


def _unpack(d: dict) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(d["bits"]), np.uint8))
    return bits[:int(np.prod(d["shape"]))].reshape(d["shape"])


def _rank_of_dryrun(device: str) -> None:
    """One rank of ``dryrun_multichip``: joins the group the environment
    names, runs ``sharded_cores`` and prints its rows and counts as one
    JSON line."""
    from .parallel.distributed import initialize_distributed, shutdown_distributed
    from .parallel.mesh import make_shot_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    info = initialize_distributed(device=device)
    try:
        mesh = make_shot_mesh(device)
        res = sharded_cores(mesh)
        print(json.dumps({
            "rank": info["process_id"], "size": info["num_processes"],
            **{k: {"rows": _pack(v["rows"]), "counts": v["counts"]} for k, v in res.items()},
        }), flush=True)
    finally:
        shutdown_distributed()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="slidingwindowdecoder_torch.graft_entry")
    ap.add_argument("--dryrun", type=int, default=None, help="ranks of dryrun_multichip")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank-of-dryrun", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of_dryrun:
        _rank_of_dryrun(args.device)
    elif args.dryrun is not None:
        print(json.dumps(dryrun_multichip(args.dryrun, device=args.device)))
    else:
        ap.error("nothing to do: pass --dryrun N")
    return 0


if __name__ == "__main__":
    sys.exit(main())
