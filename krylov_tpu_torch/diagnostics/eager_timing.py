"""Milliseconds an iteration of the eager loops on one CUDA card.

    python -m krylov_tpu_torch.diagnostics.eager_timing [--nx 500] [--maxiter 600] [--reps 3]

The system is the 2-D 5-point Laplacian (constant-weight stencil) with
``nx * nx`` points, ``b`` from ``default_rng(0)``, tol 1e-5.  Each case of
``CASES`` runs through :func:`krylov_tpu_torch.solve` on the eager loops
(``fused=False``), once to warm up and then ``--reps`` times, each solve
timed on the host clock between synchronisations; the CA solves get Lanczos
bounds computed once before.  Prints the card's name and power limit, then
one JSON line a case: iterations, ms an iteration of each rep and K1
launches an iteration.

To compare two checkouts on one card in one call, run this file from one
of them with the other's root first on ``PYTHONPATH``: the package is
imported from there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import krylov_tpu_torch
from krylov_tpu_torch import precond
from krylov_tpu_torch.kernels import stencil
from krylov_tpu_torch.sparse import fixtures

# (method, k, dtype, scalar dtype): pcg as the control; the k-skip loops
# (float32: their Gram is a float32 matrix product); the CA solves in
# float64 and float32 (the float32 ones roll back on this system)
CASES = (
    ("pcg", 0, torch.float64, None),
    ("kskipcg", 4, torch.float64, None),
    ("kskipmrr", 4, torch.float64, None),
    ("adaptivekskipmrr", 8, torch.float64, None),
    ("kskipcg", 4, torch.float32, None),
    ("kskipmrr", 4, torch.float32, None),
    ("cacg", 4, torch.float64, None),
    ("cacg", 8, torch.float64, None),
    ("camrr", 4, torch.float64, None),
    ("camrr", 8, torch.float64, None),
    ("cacg", 8, torch.float32, None),
    ("camrr", 8, torch.float32, None),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=500)
    ap.add_argument("--maxiter", type=int, default=600)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("eager_timing: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(f"card: {smi.stdout.strip() or 'nvidia-smi unavailable'}; package from {krylov_tpu_torch.__file__}")
    b_host = np.random.default_rng(0).standard_normal(args.nx * args.nx)
    ops, bounds = {}, {}
    for method, k, dt, sdt in CASES:
        if dt not in ops:
            ops[dt] = fixtures.laplace2d(args.nx, dtype=dt, constant=True)
            bounds[dt] = precond.lanczos_bounds(ops[dt])
        A = ops[dt]
        b = torch.as_tensor(b_host, dtype=dt, device=A.device)
        kw = dict(method=method, k=k, tol=1e-5, maxiter=args.maxiter, fused=False, scalar_dtype=sdt)
        if method in ("cacg", "camrr"):
            kw["spectral_bounds"] = bounds[dt]
        krylov_tpu_torch.solve(A, b, **kw)  # warm-up
        ms, launches = [], 0
        for _ in range(args.reps):
            before = stencil.stencil_matvec_2d.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = krylov_tpu_torch.solve(A, b, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / max(info["iterations"], 1))
            launches = stencil.stencil_matvec_2d.launches - before
        print(json.dumps({"method": method, "k": k, "dtype": str(dt).removeprefix("torch."),
                          "iterations": int(info["iterations"]), "ms_an_iteration": [round(t, 6) for t in ms],
                          "k1_launches_an_iteration": round(launches / max(info["iterations"], 1), 3)}))


if __name__ == "__main__":
    main()
