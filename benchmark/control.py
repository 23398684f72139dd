#!/usr/bin/env python3
"""The control of a cell's correctness check: the reference in the next
lower precision, which the check has to fail. Not part of a benchmark run.

    python3 benchmark/control.py --workload bposd-p004 --seeds 11,12,13

For each seed, the control decodes the batches a run's check samples
(batches 1 to ``check_batches`` of the pool, the rows a run keeps of
each), its corrections and verdicts take the program's place, and the
harness's ``judge`` reads them against the reference and the cell's
limit: one JSON line a seed, which has to read ``correct`` false. The
configuration names its control: ``reference_msg_dtype`` (the reference
with its messages rounded to that dtype: a program with no such path of
its own) or ``program_knobs`` (the program's own lower-precision path).
Exits 1 if a control reads correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])


def control_reading(cell: dict, seed: int, device) -> dict:
    """The control in the program's place for the batches a run's check
    samples, judged by the harness's own check and limit."""
    import copy

    import torch

    from benchmark.harness import Cell, check_rows, judge
    from benchmark.reference.pipeline import Reference

    traffic, ctl = cell["traffic"], cell["config"]["control"]
    batches = range(1, 1 + traffic["check_batches"])
    if "program_knobs" in ctl:
        low = copy.deepcopy(cell)
        low["config"]["knobs"].update(ctl["program_knobs"])
        prog = Cell(low, seed, device)
        for j in batches:
            prog.batch(j, prog.factory, keep=True)
        prog.release()
    else:
        prog = Cell(cell, seed, device)
        prog.release()
        P = prog.det.shape[0]
        rows = [check_rows(seed, j, prog.S, traffic["check_rows"]) for j in batches]
        idx = [torch.as_tensor(r, device=device) for r in rows]
        det = torch.cat([prog.det[j % P][i] for j, i in zip(batches, idx)])
        obs = torch.cat([prog.obs[j % P][i] for j, i in zip(batches, idx)])
        total, failed = Reference(cell["config"], prog.dem, device,
                                  msg_dtype=ctl["reference_msg_dtype"]).decode(det, obs)
        failed = failed.cpu().numpy()
        at = 0
        for j, r in zip(batches, rows):
            prog.kept.append((j, r, total[at:at + len(r)], failed[at:at + len(r)]))
            at += len(r)
    return {"workload": cell["name"], "seed": seed, **judge(cell, prog, seed)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args()

    import torch

    from benchmark.harness import load_cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    failed_to_fail = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = control_reading(cell, seed, torch.device("cuda"))
        r["seconds"] = time.perf_counter() - t0
        failed_to_fail += r["correct"]
        print(json.dumps(r), flush=True)
    return 1 if failed_to_fail else 0


if __name__ == "__main__":
    sys.exit(main())
