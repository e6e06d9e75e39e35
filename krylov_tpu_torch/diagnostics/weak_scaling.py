"""Weak scaling of the row-partitioned solve: nnz/s as ranks and N grow
together (BASELINE.md rows 4-5), the counterpart of
``benchmarks/weak_scaling.py``.

    python -m krylov_tpu_torch.diagnostics.weak_scaling [--ranks 1 2 4] [--rows-per-rank 65536]
        [--method kskipmrr] [--k 4] [--iters 50] [--device cuda|cpu]

For each world size in ``--ranks`` it starts a world (gloo on ``--device
cpu``, NCCL with one card a rank on ``cuda``) and solves the 2-D 5-point
Laplacian (grid form) of 1024 points a row and ``--rows-per-rank`` points
a rank, sliced along its leading axis, at tol 0 for ``--iters`` iterations:
once to warm up, then timed (``info["time"]``: after a barrier, between
device synchronisations).  Each rank prints one JSON line: N, the
iterations and outer iterations, its seconds, nnz/s in all and a rank,
the halo and all-gather bytes it received an SpMV, and the all-reduces an
outer iteration (the timed solve's all-reduces and outer iterations less
those of the warm-up, a solve of half as many: their set-up and exit
cancel), all counted
(:func:`krylov_tpu_torch.dist.spmv.sharded_matvec`,
:func:`krylov_tpu_torch.context.all_reduce`).  On the CPU the times are
the host's and say nothing of a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch.distributed as dist

import krylov_tpu_torch
from krylov_tpu_torch.context import all_reduce
from krylov_tpu_torch.dist.spmv import sharded_matvec
from krylov_tpu_torch.sparse import fixtures

G1 = 1024  # points a grid row


def weak_scaling_rank(mesh, rows_per_rank: int, method: str, k: int, iters: int) -> dict:
    """This rank's share of a world's run, and its JSON record."""
    P = dist.get_world_size(mesh.get_group())
    g0 = P * max(1, rows_per_rank // G1)
    A = fixtures.laplace2d(G1, g0)  # grid (g0, 1024)
    b = np.ones(A.shape[0])
    kw = dict(method=method, k=k, tol=0.0, mesh=mesh)
    before = all_reduce.calls
    # warm-up (the K1 build on a card, the gather buffers), half as long
    _, half = krylov_tpu_torch.solve(A, b, maxiter=iters // 2, **kw)
    fixed, outer0 = all_reduce.calls - before, len(half["residual"]) - 1
    counts = (sharded_matvec.calls, sharded_matvec.halo_bytes, sharded_matvec.gather_bytes, all_reduce.calls)
    _, info = krylov_tpu_torch.solve(A, b, maxiter=iters, **kw)
    spmvs, halo, gathered, reduces = (now - then for now, then in zip(
        (sharded_matvec.calls, sharded_matvec.halo_bytes, sharded_matvec.gather_bytes, all_reduce.calls), counts))
    outer = len(info["residual"]) - 1
    nnz_s = A.nnz * max(info["iterations"], 1) / info["time"]
    return dict(ranks=P, rank=dist.get_rank(mesh.get_group()), n=A.shape[0], device=str(A.device.type),
                method=method, k=k, iterations=info["iterations"], outer=outer, seconds=info["time"],
                nnz_per_s=nnz_s, nnz_per_s_per_rank=nnz_s / P, halo_bytes_per_spmv=halo / spmvs,
                gather_bytes_per_spmv=gathered / spmvs, all_reduces_per_outer=(reduces - fixed) / max(outer - outer0, 1))


def _print_record(mesh, *args) -> None:
    # one write a line: the ranks share the stream, and a short write is
    # not split by another rank's
    sys.stdout.write(json.dumps(weak_scaling_rank(mesh, *args)) + "\n")
    sys.stdout.flush()


def main() -> None:
    from krylov_tpu_torch.diagnostics.world import run_world

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--rows-per-rank", type=int, default=65536)
    ap.add_argument("--method", default="kskipmrr")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    for P in args.ranks:
        run_world(_print_record, P, args.device, (args.rows_per_rank, args.method, args.k, args.iters),
                  timeout=args.timeout)


if __name__ == "__main__":
    main()
