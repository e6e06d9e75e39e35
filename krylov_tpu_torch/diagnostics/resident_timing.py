"""Time per solve of the whole-solve kernels K2/K3/K5/K6 on one CUDA card,
one JSON line a case.

    python -m krylov_tpu_torch.diagnostics.resident_timing [--trials 7] [--nx 500]
        [--system laplace2d|laplace3d] [--tol 1e-5] [--maxiter 3000] [--cases LABEL,...]

The system is the main-path 2-D 5-point Laplacian (constant-weight
stencil) with ``nx * nx`` points, or with ``--system laplace3d`` the
constant-weight 7-point ``laplace3d(nx)`` (``nx = 216``: BASELINE row 5,
which streams, with ``--tol 1e-4 --maxiter 4000``), ``b`` from
``default_rng(1)``, tol 1e-5, maxiter 3000, in float64 and float32: MrR
(K2), CG (K3), k-skip MrR k=4 (K5), adaptive k-skip MrR k=8 (K5) and k-skip
CG k=4 (K6), or the cases ``--cases`` names by label, each through its
fused wrapper on the route its plan picks.  Each case is one warm-up
solve, then ``--trials`` solves between CUDA events; a line holds every
trial's ms, their median, the count, the outer iterations, the µs an
(outer) iteration at the median, and the launches by route, and by the
specialisation of the stencil pass where the package counts them.  It reads only what
every version of the package since its fused kernels has, so the file of
one checkout times another's package (run it with the other's root first
on ``PYTHONPATH``), in one call to the card, for a comparison on one card.

    python -m krylov_tpu_torch.diagnostics.resident_timing --against OTHER [--pairs 10]

runs that comparison: ``--pairs`` pairs of processes, one timing the
package at the checkout root OTHER and one this checkout's, in the order
OTHER, this, this, OTHER, OTHER, ... (each pair's first process alternates),
and prints, for each case, both packages' medians pair by pair, the
pairs this checkout's won, those it won by more than the other side's
distance between the quartiles of its medians ("won_beyond_spread"), and
that distance for each side.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from krylov_tpu_torch.kernels import fused, fused_kskip
from krylov_tpu_torch.sparse import fixtures

# (label, kernel, method, k, adaptive)
CASES = (("K2 mrr", "mrr", 0, False), ("K3 cg", "cg", 0, False), ("K5 kskipmrr k=4", "kskipmrr", 4, False),
         ("K5 adaptivekskipmrr k=8", "kskipmrr", 8, True), ("K6 kskipcg k=4", "kskipcg", 4, False))


def run(root: str, args: list) -> dict:
    """The cases' lines of this file run with ``args`` in a process of its
    own with the package at ``root``, by (case, dtype)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH")))))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                          env=env, capture_output=True, text=True, check=True)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return {(line["case"], line["dtype"]): line for line in lines}


def iqr(v) -> float:
    """The distance between the quartiles of ``v``."""
    q = statistics.quantiles(v, n=4)
    return q[2] - q[0]


def pairs(other: str, n: int, args: list) -> None:
    """``n`` pairs of processes, ``other``'s package against this
    checkout's, each run with ``args``, the first of a pair alternating;
    one JSON line a case."""
    here = str(Path(__file__).resolve().parents[2])
    runs = {other: [], here: []}
    for i in range(n):
        for root in (other, here) if i % 2 == 0 else (here, other):
            runs[root].append(run(root, args))
    for key in runs[here][0]:
        mine, theirs = [r[key]["ms"] for r in runs[here]], [r[key]["ms"] for r in runs[other]]
        counts = {(r[key]["iterations"], r[key]["outer"]) for r in runs[here] + runs[other]}
        print(json.dumps({
            "case": key[0], "dtype": key[1], "pairs": n, "won": sum(a < b for a, b in zip(mine, theirs)),
            "won_beyond_spread": sum(b - a > iqr(theirs) for a, b in zip(mine, theirs)),
            "ms": mine, "against_ms": theirs, "median_ms": statistics.median(mine),
            "against_median_ms": statistics.median(theirs),
            "change": statistics.median(mine) / statistics.median(theirs) - 1, "iqr_ms": iqr(mine),
            "against_iqr_ms": iqr(theirs), "same_counts": len(counts) == 1,
            "launches": runs[here][0][key]["launches"], "card": runs[here][0][key]["card"],
        }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=7)
    ap.add_argument("--nx", type=int, default=500)
    ap.add_argument("--system", default="laplace2d", choices=("laplace2d", "laplace3d"))
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=3000)
    ap.add_argument("--cases", default="", help="labels of CASES to run, comma-separated (default: all)")
    ap.add_argument("--against", default=None, help="root of another checkout to time in alternating processes")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if args.against:
        pairs(os.path.abspath(args.against), args.pairs,
              ["--trials", str(args.trials), "--nx", str(args.nx), "--system", args.system, "--tol", str(args.tol),
               "--maxiter", str(args.maxiter), "--cases", args.cases])
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cases = [c for c in CASES if not args.cases or c[0] in args.cases.split(",")]
    for dtype in (torch.float64, torch.float32):
        A = getattr(fixtures, args.system)(args.nx, dtype=dtype, constant=True, device="cuda")
        coef2, st2, g2, sub = A.collapse_to_2d()
        b = torch.from_numpy(np.random.default_rng(1).standard_normal(A.shape[0])).to("cuda", dtype)
        b_norm = torch.linalg.vector_norm(b)
        kw = dict(stencil=st2, grid=g2, maxiter=args.maxiter, sub=sub)
        for label, method, k, adaptive in cases:
            if method in ("mrr", "cg"):
                fn = getattr(fused, f"fused_{method}_solve_2d")

                def solve():
                    return fn(coef2, b, args.tol, b_norm, **kw)
            else:
                fn = getattr(fused_kskip, f"fused_{method}_solve_2d")
                extra = dict(adaptive=True) if adaptive else {}

                def solve():
                    return fn(coef2, b, args.tol, b_norm, k, k_max=k, **kw, **extra)
            solve()  # warm-up
            counts = {name: getattr(fn, name) for name in dir(fn) if name.startswith("launches_")}
            times = []
            for _ in range(args.trials):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                out = solve()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            if method in ("mrr", "cg"):
                iters, outer = int(out[2]), int(out[2])
            else:
                iters, outer = (int(out[3]), int(out[5])) if method == "kskipcg" else (int(out[4]), int(out[6]))
            ms = statistics.median(times)
            print(json.dumps({
                "case": label, "dtype": str(dtype).removeprefix("torch."), "ms": ms, "trials_ms": times,
                "iterations": iters, "outer": outer, "us_per_outer": ms / outer * 1e3,
                "launches": {name: getattr(fn, name) - v for name, v in counts.items()}, "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
