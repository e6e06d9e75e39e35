"""Time per solve of the fused kernels K2/K3/K5/K6 against the size of their
cooperative grid, on one CUDA card.

    python -m krylov_tpu_torch.diagnostics.grid_sweep [--blocks 66,132,264,396,528,0]
                                                     [--k 1,2,4,8] [--nx 500]

The system is the 2-D 5-point Laplacian (constant-weight stencil) with
``nx * nx`` points in float64, ``b`` from ``default_rng(1)``, tol 1e-5 and
maxiter 3000.  The grid is capped through ``kernels.fused.MAX_BLOCKS``
(0: the occupancy limit, the kernels' default); a cap above that limit
changes nothing.  Each time is the median of 3 solves between CUDA events.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from krylov_tpu_torch.kernels import fused, fused_kskip
from krylov_tpu_torch.sparse import fixtures


def median_ms(fn):
    """Median of 3 calls of ``fn`` between CUDA events, in ms, and what the
    last call returned."""
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default="66,132,264,396,528,0")
    ap.add_argument("--k", default="1,2,4,8")
    ap.add_argument("--nx", type=int, default=500)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    n = args.nx * args.nx
    A = fixtures.laplace2d(args.nx, constant=True, device="cuda")
    coef2, st2, g2, sub = A.collapse_to_2d()
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).cuda()
    b_norm = torch.linalg.vector_norm(b)
    kw = dict(stencil=st2, grid=g2, maxiter=3000, sub=sub)
    for cap in (int(v) for v in args.blocks.split(",")):
        fused.MAX_BLOCKS = cap
        for m, fn in (("mrr", fused.fused_mrr_solve_2d), ("cg", fused.fused_cg_solve_2d)):
            blocks = fused.workspace(m, torch.float64, n)[0]
            t, (_, _, iters, _) = median_ms(lambda: fn(coef2, b, 1e-5, b_norm, **kw))
            print(f"K{'2' if m == 'mrr' else '3'} {m} blocks {blocks}: {t:.3f} ms, {int(iters)} iters, "
                  f"{t / int(iters) * 1e3:.3f} us/iter", flush=True)
        for k in (int(v) for v in args.k.split(",")):
            for m, fn in (("kskipcg", fused_kskip.fused_kskipcg_solve_2d),
                          ("kskipmrr", fused_kskip.fused_kskipmrr_solve_2d)):
                blocks = fused_kskip.workspace(m, torch.float64, n, k)[0]
                t, out = median_ms(lambda: fn(coef2, b, 1e-5, b_norm, k, k_max=k, **kw))
                iters, outer = (out[3], out[5]) if m == "kskipcg" else (out[4], out[6])
                print(f"{'K6' if m == 'kskipcg' else 'K5'} {m} k={k} blocks {blocks}: {t:.3f} ms, "
                      f"{int(iters)} iters, {int(outer)} outer, {t / int(outer) * 1e3:.3f} us/outer", flush=True)
    fused.MAX_BLOCKS = 0


if __name__ == "__main__":
    main()
