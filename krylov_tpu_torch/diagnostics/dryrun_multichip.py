"""A multi-rank dry run of the row-partitioned solve, the counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m krylov_tpu_torch.diagnostics.dryrun_multichip [--ranks 4] [--device cuda|cpu] [--nx 500]

:func:`dryrun_multichip` runs on one rank of a world, given its mesh, the
same small solves at the same sizes as the JAX package's dry run, each
through ``solve(..., mesh=mesh)`` and beside the same solve on the rank
alone (no mesh): adaptive k-skip MrR k=2 on ``laplace2d(8, 2P)`` (the
stencil halo), CG on an ELL operator and k-skip MrR k=2 on a HYB one (the
all-gather), Jacobi and Chebyshev pcg (the preconditioner sharded with the
operator) and cacg/camrr at k=4 with explicit bounds, all float32.  It
raises on a non-finite ``x`` and returns, per solve, the sharded and the
single-rank iteration counts.  :func:`main_path` runs the main-path
system at full size, ``laplace2d(nx, constant=True)`` in float64 (tol
1e-5, ``b`` from ``default_rng(0)``), sharded over the world against the
eager solve on the rank alone.  :func:`row5` runs BASELINE row 5 weak-scaled
over the world (one ``216**3`` slab a rank) through ``solve_device(mesh=)``
with the adaptive loop's steps replayed as CUDA graphs against the same
solves with every step eager.  Run as a module, it starts a world of
``--ranks`` ranks (gloo on ``--device cpu``, NCCL with one card a rank on
``cuda``) and rank 0 prints one JSON line of the dry run, with ``--nx`` one
of the main path, and on a world of four cards one of row 5.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

import krylov_tpu_torch
from krylov_tpu_torch import precond, tracing
from krylov_tpu_torch.context import all_reduce
from krylov_tpu_torch.dist.spmv import sharded_matvec
from krylov_tpu_torch.sparse import convert, fixtures
from krylov_tpu_torch.sparse.formats import to_device

# the main path's solves: (method, k, preconditioner)
MAIN_PATH = (("cg", 0, None), ("kskipmrr", 4, None), ("adaptivekskipmrr", 8, None), ("pcg", 0, "jacobi"),
             ("cacg", 4, None))


def dryrun_multichip(mesh) -> dict:
    """The dry run on this rank of ``mesh``'s world: ``{solve: {"sharded":
    iterations, "single": iterations, "k": k}}``, the same on every rank."""
    P = dist.get_world_size(mesh.get_group())
    f32 = np.float32
    # nx = 8 rows a plane, 2 planes a rank: the stencil halo
    A = fixtures.laplace2d(8, 2 * P, dtype=f32)
    b = np.ones(A.shape[0], dtype=f32)
    E = fixtures.random_spd_ell(16 * P, row_nnz=6, seed=0, dtype=f32)
    H = convert.to_hyb(fixtures.powerlaw_spd(48 * P, seed=1, max_deg=64, dtype=f32), dtype=f32)
    solves = {
        "adaptivekskipmrr": (A, b, dict(method="adaptivekskipmrr", k=2, maxiter=24)),
        "ell cg": (E, np.ones(E.shape[0], dtype=f32), dict(method="cg", maxiter=16)),
        "hyb kskipmrr": (H, np.ones(H.shape[0], dtype=f32), dict(method="kskipmrr", k=2, maxiter=16)),
        "pcg jacobi": (A, b, dict(method="pcg", M=precond.jacobi(A), maxiter=16)),
        "pcg chebyshev": (A, b, dict(method="pcg", M=precond.chebyshev(A, degree=3, bounds="gershgorin"),
                                     maxiter=16)),
        "cacg": (A, b, dict(method="cacg", k=4, maxiter=16, spectral_bounds=(0.05, 8.0))),
        "camrr": (A, b, dict(method="camrr", k=4, maxiter=16, spectral_bounds=(0.05, 8.0))),
    }
    out = {}
    for name, (op, rhs, kw) in solves.items():
        x, info = krylov_tpu_torch.solve(op, rhs, tol=1e-4, mesh=mesh, **kw)
        if x.shape != (op.shape[0],) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"dry run {name}: x of shape {tuple(x.shape)}, finite {bool(torch.isfinite(x).all())}")
        _, solo = krylov_tpu_torch.solve(op, rhs, tol=1e-4, fused=False, **kw)
        out[name] = {"sharded": info["iterations"], "single": solo["iterations"], "k": kw.get("k", 0)}
    return out


def main_path(mesh, nx: int) -> dict:
    """The main-path solves of MAIN_PATH on ``laplace2d(nx, constant=True)``
    sharded over ``mesh``'s world, each against the eager solve on this
    rank alone: counts (within k + 1, else it raises), the largest entry of
    ``|x - x_eager|`` over that of ``x_eager``, the host float64 true
    residual (below tol, else it raises), ms an iteration of both (host
    clock; for CG paired eager, sharded, sharded, eager), and, on every
    rank, K1 launches, all-reduces and halo bytes received an iteration."""
    group = mesh.get_group()
    A = fixtures.laplace2d(nx, constant=True)
    A_host = to_device(A, "cpu")
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    bounds = precond.lanczos_bounds(A)
    out = {}
    for m, k, p in MAIN_PATH:
        kw = dict(method=m, k=k, tol=1e-5, maxiter=3000)
        if p == "jacobi":
            kw["M"] = precond.jacobi(A)
        if m == "cacg":
            kw["spectral_bounds"] = bounds
        runs = ("eager", "sharded", "sharded", "eager") if m == "cg" else ("eager", "sharded")
        ms = {"eager": [], "sharded": []}
        for route in runs:
            if route == "sharded":
                counts = (tracing.totals.stencil_matvec_2d.launches, all_reduce.calls, sharded_matvec.halo_bytes)
                x, info = krylov_tpu_torch.solve(A, b, mesh=mesh, **kw)
                k1, reduces, halo = (now - then for now, then in zip(
                    (tracing.totals.stencil_matvec_2d.launches, all_reduce.calls, sharded_matvec.halo_bytes), counts))
                sharded = info
            else:
                x_e, eager = krylov_tpu_torch.solve(A, b, fused=False, **kw)
            ms[route].append((info if route == "sharded" else eager)["time"] * 1e3
                             / (info if route == "sharded" else eager)["iterations"])
        per_rank = [None] * dist.get_world_size(group)
        its = sharded["iterations"]
        dist.all_gather_object(per_rank, (k1 / its, reduces / its, halo / its), group=group)
        true_res = float(np.linalg.norm(b - convert.host_matvec64(A_host, x)) / np.linalg.norm(b))
        name = f"{m}{f' k={k}' if k else ''}{f' M={p}' if p else ''}"
        out[name] = {"sharded": its, "eager": eager["iterations"], "x_rel": float((x - x_e).abs().max()
                                                                                  / x_e.abs().max()),
                     "true_res": true_res, "ms_an_iteration": ms,
                     "k1_allreduces_halo_bytes_an_iteration_by_rank": per_rank}
        if abs(its - eager["iterations"]) > k + 1 or not (sharded["converged"] and true_res < 1e-5):
            raise AssertionError(f"main path {name}: {its} iterations (eager {eager['iterations']}), "
                                 f"true res {true_res:.3e}")
    return out


ROW5 = dict(method="adaptivekskipmrr", k=8, tol=1e-4, maxiter=4000, restarts=1)  # BASELINE row 5's solve


def row5(mesh, requests: int = 3) -> dict:
    """BASELINE row 5 weak-scaled over ``mesh``'s world of cards:
    ``laplace3d(216, 216, 216 P, constant=True)`` in float64, one
    ``216**3`` slab a rank, through ``solve_device(mesh=)`` with ROW5 on a
    standard normal ``b`` drawn on the card from seed 0 (the same on every
    rank).  Two routes, ``requests`` requests each after a warm-up request:
    ``graph`` (the adaptive loop's steps replayed as CUDA graphs, their
    all-reduces and halo exchanges captured) and ``eager`` (every step
    launched from Python).  For each route: ms a request (host clock between
    synchronisations of the card), host µs an outer iteration (the
    ``eager_loop`` spans less their host reads, over the bodies they ran),
    the outer iterations a request and those replayed, all-reduces a
    request; and whether both routes gave the same ``x``, traces and true
    residual bit for bit.  It raises where they differ or a request is not
    converged."""
    import time

    from krylov_tpu_torch.solvers import _common

    P = dist.get_world_size(mesh.get_group())
    device = torch.device("cuda", torch.cuda.current_device())
    A = fixtures.laplace3d(216, 216, 216 * P, constant=True, device=device)
    b = torch.randn(A.shape[0], dtype=torch.float64, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    t = tracing.totals
    out, results = {}, {}
    for route in ("graph", "eager"):
        route_of = _common.step_route
        if route == "eager":
            _common.step_route = lambda state: False
        try:
            krylov_tpu_torch.solve_device(A, b, mesh=mesh, **ROW5)  # warm-up: K1's cache, a graph's capture
            before = (t.eager_loop.total_ns, t.eager_loop.read_ns, t.eager_bodies.calls, t.eager_graph.bodies,
                      all_reduce.calls)
            ms = []
            for _ in range(requests):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                res = krylov_tpu_torch.solve_device(A, b, mesh=mesh, **ROW5)
                torch.cuda.synchronize(device)
                ms.append((time.perf_counter() - t0) * 1e3)
            loop_ns, read_ns, bodies, replayed, reduces = (
                now - then for now, then in zip((t.eager_loop.total_ns, t.eager_loop.read_ns, t.eager_bodies.calls,
                                                 t.eager_graph.bodies, all_reduce.calls), before))
        finally:
            _common.step_route = route_of
        if not bool(res.converged):
            raise AssertionError(f"row 5 over {P} ranks, {route}: not converged (true res {float(res.true_residual)})")
        results[route] = res
        out[route] = {"ms_a_request": ms, "host_us_an_outer_iteration": (loop_ns - read_ns) * 1e-3 / bodies,
                      "outer_a_request": bodies / requests, "replayed_a_request": replayed / requests,
                      "allreduces_a_request": reduces / requests, "iterations": int(res.iterations),
                      "true_residual": float(res.true_residual)}
    g, e = results["graph"], results["eager"]
    out["bitwise"] = all(torch.equal(getattr(g, f), getattr(e, f)) for f in
                         ("x", "residual_trace", "nosl_trace", "k_trace", "iterations", "true_residual"))
    if not out["bitwise"]:
        raise AssertionError("row 5: the graph route's x, traces or true residual differ from the eager route's")
    return out


def _print_dryrun(mesh, nx) -> None:
    out = dryrun_multichip(mesh)
    if dist.get_rank() == 0:
        print(json.dumps({"dryrun_multichip": out, "ranks": dist.get_world_size()}), flush=True)
    if nx:
        out = main_path(mesh, nx)
        if dist.get_rank() == 0:
            print(json.dumps({"main_path": out, "nx": nx, "ranks": dist.get_world_size()}), flush=True)
    if mesh.device_type == "cuda" and dist.get_world_size() == 4:
        out = row5(mesh)
        if dist.get_rank() == 0:
            print(json.dumps({"row5": out, "ranks": 4, "card": torch.cuda.get_device_name()}), flush=True)


def main() -> None:
    from krylov_tpu_torch.diagnostics.world import run_world

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--nx", type=int, default=0, help="also run the main path on laplace2d(nx, constant=True)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    run_world(_print_dryrun, args.ranks, args.device, (args.nx,), timeout=args.timeout)


if __name__ == "__main__":
    main()
