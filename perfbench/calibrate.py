"""The readings that a cell's limits are set from, in one process (or one
world of ranks): the program's compared numbers over a dozen seeds or more
(the lower readings, their worst) and the control's over three or more (the
upper readings, their least).  The control is the program's own float32
path, the nearest precision below the configuration's float64, on the same
``b`` as drawn in float64.

    python3 -m perfbench.calibrate --workload <name> --seeds 101-112 --control-seeds 201-203 \\
        [--requests 2] [--out chiprun_out/calibrate.jsonl]

It drives the timed path (``solve_device`` with the cell's arguments, at the
cell's sizes) without a window, and prints one JSON line a cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch

from perfbench import check, harness

CONTROL_DTYPE = "float32"


def _seeds(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def readings(cell, device, seeds, *, dtype=None, requests=1, test=False, mesh=None, rank=0, world=1) -> list:
    """The compared numbers of ``requests`` requests a seed (rank 0's list;
    every rank must call it)."""
    rows = []
    for seed in seeds:
        client = harness.Client(cell, device, seed, test=test, dtype=dtype, mesh=mesh)
        for _ in range(requests):
            b = client.rhs()
            res, iterations, seconds = client.request(b)
            x = harness.gather_whole(res.x, client.n, world)
            if rank == 0:
                row = check.numbers(cell.config, cell.traffic, client.grid, b, x, iterations)
                rows.append(dict(row, seed=seed, iterations=iterations, seconds=seconds))
        del client
    return rows


def summary(cell, program: list, control: list) -> dict:
    """Per compared number: the program's worst (lower reading), the
    control's least (upper reading), and the cell's limit and verdicts."""
    out = {}
    for name in ("true_rel", "iters_gap", "x_err"):
        lower = max(r[name] for r in program)
        upper = min(r[name] for r in control) if control else None
        out[name] = {"lower": lower, "upper": upper, "limit": cell.checks["limits"].get(name)}
    out["program_ok"] = check.judge(program, cell.checks["limits"], cell.config["tol"])[0]
    out["control_ok"] = check.judge(control, cell.checks["limits"], cell.config["tol"])[0] if control else None
    return out


def _calibrate(cell, device, seeds, control_seeds, requests, test, mesh=None, rank=0, world=1) -> dict:
    program = readings(cell, device, seeds, requests=requests, test=test, mesh=mesh, rank=rank, world=world)
    control = readings(cell, device, control_seeds, dtype=CONTROL_DTYPE, requests=requests, test=test, mesh=mesh,
                       rank=rank, world=world)
    if rank != 0:
        return {}
    return {"workload": cell.workload, "summary": summary(cell, program, control), "program": program,
            "control": control}


def _rank_job(mesh, rank, device, cell_fields, seeds, control_seeds, requests, test, out_dir):
    cell = harness.Cell(**cell_fields)
    out = _calibrate(cell, device, seeds, control_seeds, requests, test, mesh, rank, cell.config["ranks"])
    if rank == 0:
        (Path(out_dir) / "out.json").write_text(json.dumps(out))


def calibrate(workload: str, seeds, control_seeds, *, requests=1, device_type="cuda", test=False,
              root=harness.ROOT) -> dict:
    cell = harness.load_cell(workload, root)
    ranks = cell.config["ranks"]
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if ranks == 1:
        return _calibrate(cell, device, seeds, control_seeds, requests, test)
    from perfbench import world

    if device_type == "cuda":
        from krylov_tpu_torch.kernels import _build

        _build.library()
    with tempfile.TemporaryDirectory() as out_dir:
        world.run_world(_rank_job, ranks, device_type,
                        args=(dataclasses.asdict(cell), seeds, control_seeds, requests, test, out_dir),
                        timeout=3000.0)
        return json.loads((Path(out_dir) / "out.json").read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", default="101-112")
    ap.add_argument("--control-seeds", default="201-203")
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for w in args.workload:
        out = calibrate(w, _seeds(args.seeds), _seeds(args.control_seeds), requests=args.requests)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(out) + "\n")
        print(json.dumps({"workload": w, "summary": out["summary"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
