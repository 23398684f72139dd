"""The port's scale-out (``parallel/distributed.py``, ``parallel/mesh.py``,
the sharded window pipeline and ``graft_entry``) against the JAX package
on the CPU: the same shot ranges and streams, the same sharded decode
step, and two ``gloo`` ranks whose rows and reduced counts equal one
process's."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.parallel import distributed as tdist
from slidingwindowdecoder_torch.parallel.mesh import (
    ShotMesh,
    make_shot_mesh,
    shard_decode_step,
    shard_over_shots,
)
from slidingwindowdecoder_tpu.parallel import distributed as jdist
from slidingwindowdecoder_tpu.parallel import mesh as jmesh

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_dist_child as child  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The inputs are small, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("total,hosts", [(103, 4), (96, 2), (7, 8), (16384, 1), (16384, 3)])
def test_host_shot_range_matches_jax(total, hosts):
    ranges = [tdist.host_shot_range(total, pid, hosts) for pid in range(hosts)]
    assert ranges == [jdist.host_shot_range(total, pid, hosts) for pid in range(hosts)]
    if total % hosts == 0:  # the mesh's blocks are P(axis, None)'s contiguous rows
        S = total // hosts
        assert [ShotMesh(r, hosts, torch.device("cpu")).rows(total)
                for r in range(hosts)] == [slice(r * S, (r + 1) * S) for r in range(hosts)]


@pytest.mark.parametrize("seed,pid", [(7, 0), (7, 1), (2024, 3)])
def test_host_seed_matches_jax(seed, pid):
    np.testing.assert_array_equal(tdist.host_seed(seed, pid).random(64),
                                  jdist.host_seed(seed, pid).random(64))


def test_single_process_needs_no_group(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    info = tdist.initialize_distributed(device="cpu")
    assert set(info) == {"process_id", "num_processes", "local_devices", "devices"}
    assert (info["process_id"], info["num_processes"]) == (0, 1)
    assert info["devices"] == [torch.device("cpu")]
    assert not torch.distributed.is_initialized()
    assert tdist.global_sum(5) == 5.0
    mesh = make_shot_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    with pytest.raises(ValueError, match="must divide"):
        ShotMesh(0, 3, torch.device("cpu")).rows(32)
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(shard_over_shots(ShotMesh(1, 3, torch.device("cpu")), x),
                                  x[2:4])


def test_entry_points_need_a_card_by_default(monkeypatch):
    from slidingwindowdecoder_torch.circuits import make_dem_sampler
    from slidingwindowdecoder_torch.graft_entry import dryrun_multichip, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tdist.initialize_distributed(), make_shot_mesh,
                 lambda: make_dem_sampler(None), entry, lambda: dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("p,num_iter", [(0.01, 16), (0.05, 8)])
def test_shard_decode_step_matches_jax(p, num_iter):
    """[[72]] hx, 64 code-capacity syndromes from seed 0: the port's step on
    a one-rank CPU mesh against the JAX step on a one-device mesh (BP,
    OSD-0 for the unconverged shots, the failure count)."""
    from slidingwindowdecoder_torch.codes import bb_code_by_n

    code, _, _ = bb_code_by_n(72)
    rng = np.random.default_rng(0)
    errs = (rng.random((64, code.N)) < p).astype(np.uint8)
    synds = ((errs @ code.hx.T) % 2).astype(np.uint8)
    prior = np.full(code.N, p)
    out_t = shard_decode_step(make_shot_mesh("cpu"), code.hx, prior, synds, num_iter=num_iter)
    out_j = jmesh.shard_decode_step(jmesh.make_shot_mesh(jax.devices()[:1]), code.hx, prior,
                                    synds, num_iter=num_iter)
    np.testing.assert_array_equal(out_t["error"].numpy(), np.asarray(out_j["error"]))
    assert out_t["num_errors"] == int(out_j["num_errors"])
    resid = (out_t["error"].numpy().astype(np.int64) @ code.hx.T + synds) % 2
    assert out_t["num_errors"] == int(resid.any(axis=1).sum())
    with pytest.raises(ValueError, match="must divide"):
        shard_decode_step(ShotMesh(0, 3, torch.device("cpu")), code.hx, prior, synds)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_pipeline():
    """Two gloo ranks decode the [[72]] x3, W=2 samples
    (``_torch_dist_child.py``): their rows joined equal one process's
    ``decode_sliding_window``, every rank reduces the same counts, which
    equal the JAX ``evaluate_logical_errors`` of the joined corrections,
    and ``global_sum`` of the ranks' failures is their sum."""
    from slidingwindowdecoder_torch.windows.pipeline import decode_sliding_window
    from slidingwindowdecoder_tpu.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_tpu.windows.pipeline import evaluate_logical_errors

    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": "2", "RANK": str(rank), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, str(ROOT / "tests/_torch_dist_child.py")],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    outs.sort(key=lambda o: o["rank"])
    assert [(o["rank"], o["size"]) for o in outs] == [(0, 2), (1, 2)]
    assert all(o["devices"] == ["cpu", "cpu"] for o in outs)

    plan, det, obs = child.samples()
    ref = decode_sliding_window(plan, det, child.factory("cpu"), device="cpu", verbose=False)
    rows = np.concatenate([np.asarray(o["rows"], np.uint8) for o in outs])
    np.testing.assert_array_equal(rows, ref["total_e_hat"].numpy())
    _, _, _, jplan = build_bb_window_experiment(*child.EXP)
    ev = evaluate_logical_errors(jplan, det, obs, rows)
    assert ev["num_failed"] > 0
    for o in outs:
        assert (o["num_failed"], o["num_flagged"]) == (ev["num_failed"], ev["num_flagged"])
        assert o["global_failed"] == sum(x["local_failed"] for x in outs) == ev["num_failed"]


def test_sharded_pipeline_without_a_mesh_matches_the_pipeline():
    """No mesh: the per-shot results of ``decode_sliding_window``; a
    one-rank mesh without a group gives the same, and the sharded
    accounting equals the plain one."""
    from slidingwindowdecoder_torch.windows.pipeline import (
        decode_sliding_window,
        decode_sliding_window_sharded,
        evaluate_logical_errors,
        evaluate_logical_errors_sharded,
    )

    plan, det, obs = child.samples()
    det, obs = det[:32], obs[:32]
    ref = decode_sliding_window(plan, det, child.factory("cpu"), device="cpu", verbose=False)
    single = decode_sliding_window_sharded(plan, det, child.factory("cpu"), device="cpu")
    assert set(single) == {"total_e_hat", "corrected_det", "window_seconds"}
    assert len(single["window_seconds"]) == plan.num_windows
    np.testing.assert_array_equal(single["total_e_hat"].numpy(), ref["total_e_hat"].numpy())
    np.testing.assert_array_equal(single["corrected_det"].numpy(), ref["corrected_det"].numpy())
    mesh = make_shot_mesh("cpu")
    meshed = decode_sliding_window_sharded(plan, det, child.factory("cpu"), mesh)
    np.testing.assert_array_equal(meshed["total_e_hat"].numpy(), ref["total_e_hat"].numpy())
    ev = evaluate_logical_errors(plan, det, obs, ref["total_e_hat"], device="cpu")
    evs = evaluate_logical_errors_sharded(plan, det, obs, meshed["total_e_hat"], mesh)
    assert set(evs) == {"failed", "num_flagged", "num_failed"}
    np.testing.assert_array_equal(evs["failed"], ev["failed"])
    assert (evs["num_failed"], evs["num_flagged"]) == (ev["num_failed"], ev["num_flagged"])


def test_dryrun_multichip_two_gloo_ranks(capsys):
    """``dryrun_multichip(2)`` on the CPU: the five sharded cores over two
    gloo ranks equal one process's, row for row and count for count."""
    from slidingwindowdecoder_torch.graft_entry import dryrun_multichip

    summary = dryrun_multichip(2, device="cpu", timeout_s=300)
    assert set(summary) == {"flagship", "osd_window", "gdg", "bpgd", "bp4"}
    assert all(v["shots"] == 8 for v in summary.values())
    assert capsys.readouterr().out.count("every rank's rows equal to one process's") == 5


def test_graft_entry_matches_jax_decode_bp(monkeypatch):
    """``entry("cpu")``'s step on its example arguments (zero syndromes)
    and on random syndromes equals the JAX ``entry``'s ``decode_bp``."""
    import __graft_entry__ as jentry
    from slidingwindowdecoder_torch.graft_entry import entry
    from slidingwindowdecoder_tpu.utils import compile_cache

    # no persistent compilation cache for this worker's later tests
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **k: None)

    fn, args = entry("cpu")
    jfn, jargs = jentry.entry()
    assert tuple(args[2].shape) == tuple(jargs[2].shape) == (32, jargs[2].shape[1])
    synds = np.random.default_rng(5).integers(0, 2, tuple(args[2].shape), dtype=np.uint8)
    for s in (np.zeros_like(synds), synds):
        out = fn(args[0], args[1], torch.as_tensor(s))
        jout = jfn(jargs[0], jargs[1], jax.numpy.asarray(s))
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
