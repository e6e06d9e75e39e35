"""krylov_tpu_torch's row-partitioned solve (mesh=) in gloo worlds of 2 and 4
ranks on the CPU, against krylov_tpu's sharded solve on as many of the 8
virtual CPU devices of tests/conftest.py, in float64.

Each world is one set of processes, started once for the module (this file
run as a script, one process a rank, a file:// store under tmp_path): every
rank runs every case of its world size and writes what it saw; the tests
then hold the ranks' records case by case.  The worlds get RUN_TIMEOUT
seconds; past it their processes are killed and the tests fail.

For each solve case:
- against the JAX package's sharded solve at the same number of ranks:
  equal iteration counts for cg, mrr and pcg, within k + 1 for the k-skip
  family and the CA methods, equal khistory, x within rtol 1e-8 (atol
  1e-10), residual histories within rtol 1e-6 over their common length;
- against the port's single-device solve: tests/test_dist.py::_compare's
  tolerances (counts within k + 1, x rtol 1e-6 atol 1e-9, histories rtol
  1e-4);
- histories with atol 1e-13 beside their rtol: a CG run that ends by
  finite termination (poisson1d) records a last residual at rounding level,
  ~1e-15, which carries no digits (tests/test_torch_solve.py does the
  same).  The float32 case with refine= holds its float64 x and true
  residual, not its history: float32 sums in another order from the
  single-device solve's and XLA's, and so do the iterates below float32's
  rounding;
- every rank's info the same, bitwise (the loops' host branches read it);
- all-reduces an (outer) iteration equal to the reductions of the JAX
  loop body (ALLREDUCES), read from two solves at tol 0 that differ only in
  maxiter.
``restarts=`` under ``mesh=`` is held against the port's single-device
``restarts=`` (RESTARTS); the sharded operator's cache against its
promises; and the adaptive loop's steps through an emulation of their CUDA
graph route (``_step_graphs``) against the eager mesh loop, bit for bit and
count for count (STEP_CASES).
The sharded matvec of each container is held against the dense product
(rtol 1e-12), and each rank's shard_operator bitwise against the JAX
package's, cut by from_jax_operator.  Each world also runs the port's dry
run (krylov_tpu_torch.diagnostics.dryrun_multichip), and the weak-scaling
diagnostic runs as a user runs it, on worlds of 1 and 2 gloo ranks.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import krylov_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 120  # seconds for both worlds, from their start
PROBE_MAXITER = (12, 24)  # the two tol-0 solves that count all-reduces an iteration

# all-reduces an iteration (an outer iteration for the k-skip and CA
# methods): the reductions of the JAX loop body, one psum each
ALLREDUCES = {
    "cg": 2,  # krylov_tpu/solvers/cg.py:69, :73
    "mrr": 2,  # krylov_tpu/solvers/mrr.py:86, :93 (two bundles)
    "kskipcg": 1,  # krylov_tpu/solvers/kskip_cg.py:147 (the Gram)
    "kskipmrr": 1,  # krylov_tpu/solvers/kskip_mrr.py:194 (the Gram)
    "adaptivekskipmrr": 2,  # krylov_tpu/solvers/adaptive_kskip_mrr.py:163 (the guard), :256 (the Gram)
    "pcg": 3,  # krylov_tpu/solvers/pipelined.py:88, :94, :99
    "cacg": 1,  # krylov_tpu/solvers/cacg.py:232 (the Gram)
    "camrr": 1,  # krylov_tpu/solvers/cacg.py:456 (the Gram)
}


def _dia012(fx, cv):
    """A DIA operator with the asymmetric offsets (0, 1, 2)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    n = 64
    return cv.to_dia(sp.diags([rng.standard_normal(n - o) for o in (0, 1, 2)], [0, 1, 2], shape=(n, n)))


# name -> the function that makes the system from a package's fixtures
# and convert modules (the same arrays in both packages)
SYSTEMS = {
    "lap2d": lambda fx, cv: fx.laplace2d(16),
    "lap2d-const": lambda fx, cv: fx.laplace2d(16, constant=True),
    "lap3d": lambda fx, cv: fx.laplace3d(8),
    "lap3d-const": lambda fx, cv: fx.laplace3d(8, constant=True),
    "lap2d-16x18": lambda fx, cv: fx.laplace2d(16, 18),  # grid (18, 16): 18 % 4 != 0, the DIA fallback at 4
    "poisson1d": lambda fx, cv: fx.poisson1d(102),  # pads to 104 at 4 ranks
    "dia012": _dia012,
    "ell": lambda fx, cv: fx.random_spd_ell(128, row_nnz=8, seed=2),
    "hyb": lambda fx, cv: cv.to_hyb(fx.powerlaw_spd(192, seed=1, max_deg=64)),
    "dense": lambda fx, cv: cv.to_dense(fx.powerlaw_spd(64, seed=3)),
    "lap2d-f32": lambda fx, cv: fx.laplace2d(16, dtype=np.float32),
}


def _case(P, system, method="cg", k=0, kind="solve", precond=None, nrhs=0, tol=1e-9, refine=0, maxiter=2000):
    return dict(P=P, system=system, method=method, k=k, kind=kind, precond=precond, nrhs=nrhs, tol=tol,
                refine=refine, maxiter=maxiter)


CASES = {}
for _P in (2, 4):
    for _s in ("lap2d", "lap2d-const"):
        for _m in ("cg", "mrr"):
            CASES[f"{_m}-{_s}-P{_P}"] = _case(_P, _s, _m)
    for _m in ("kskipcg", "kskipmrr", "adaptivekskipmrr"):
        CASES[f"{_m}2-lap2d-P{_P}"] = _case(_P, "lap2d", _m, 2)
CASES.update({
    "cg-lap3d-P4": _case(4, "lap3d"),
    "mrr-lap3d-const-P2": _case(2, "lap3d-const", "mrr"),
    "cg-lap2d-16x18-P4": _case(4, "lap2d-16x18"),
    "cg-poisson1d-P4": _case(4, "poisson1d", maxiter=500),
    "pcg-jacobi-poisson1d-P4": _case(4, "poisson1d", "pcg", precond="jacobi", maxiter=500),
    "pcg-chebyshev-poisson1d-P4": _case(4, "poisson1d", "pcg", precond="chebyshev", maxiter=500),
    "pcg-chebyshev-lap2d-P2": _case(2, "lap2d", "pcg", precond="chebyshev"),
    "cg-ell-P4": _case(4, "ell", tol=1e-10, maxiter=1000),
    "cg-hyb-P2": _case(2, "hyb", tol=1e-10, maxiter=1000),
    "kskipmrr2-hyb-P4": _case(4, "hyb", "kskipmrr", 2, tol=1e-10, maxiter=1000),
    "cg-dense-P2": _case(2, "dense", tol=1e-10, maxiter=1000),
    "cacg4-lap2d-P4": _case(4, "lap2d", "cacg", 4),
    "camrr4-lap2d-P4": _case(4, "lap2d", "camrr", 4),
    "batched3-cg-lap2d-P2": _case(2, "lap2d", kind="batched", nrhs=3, maxiter=1000),
    "batched3-kskipmrr2-lap2d-P4": _case(4, "lap2d", "kskipmrr", 2, kind="batched", nrhs=3, maxiter=1000),
    "batched2-cg-poisson1d-P4": _case(4, "poisson1d", kind="batched", nrhs=2, maxiter=500),
    "batched2-pcg-jacobi-poisson1d-P2": _case(2, "poisson1d", "pcg", precond="jacobi", kind="batched", nrhs=2,
                                              maxiter=500),
    "batched3-pcg-jacobi-lap2d-P2": _case(2, "lap2d", "pcg", precond="jacobi", kind="batched", nrhs=3, maxiter=1000),
    "batched3-cacg4-lap2d-P2": _case(2, "lap2d", "cacg", 4, kind="batched", nrhs=3, maxiter=1000),
    "refine2-cg-lap2d-f32-P2": _case(2, "lap2d-f32", tol=1e-11, refine=2, maxiter=None),
    "device-cg-poisson1d-P4": _case(4, "poisson1d", kind="device", maxiter=500),
})
SOLVES = sorted(c for c, v in CASES.items() if v["kind"] != "device")
PROBED = sorted(c for c in SOLVES if CASES[c]["refine"] == 0)
MATVECS = [(s, P) for P in (2, 4) for s in ("lap2d", "lap2d-const", "lap3d", "lap3d-const", "dia012", "ell",
                                             "hyb", "dense")] + [("lap2d-16x18", 4)]
ERRORS = {
    "chunk_iters": (ValueError, "chunk_iters= is single-device only"),
    "fused": (ValueError, "fused= and mesh= are mutually exclusive"),
    "batched-fused": (ValueError, "fused= and mesh= are mutually exclusive"),
    "not-divisible": (ValueError, "not divisible by n_devices"),
}
# restarts=1 under mesh= against the port's single-device restarts=1: the
# first solve stops at maxiter, short of RESTARTS_TOL, so the defect solve
# runs and brings the true residual below it
RESTARTS = {
    "adaptivekskipmrr2-lap2d-const": ("lap2d-const", "adaptivekskipmrr", 2, 40),
    "adaptivekskipmrr2-lap3d-const": ("lap3d-const", "adaptivekskipmrr", 2, 24),
}
RESTARTS_TOL = 1e-8
# the adaptive loop's steps through the emulated graph route: (system, k);
# on the advection stencil the guard rolls back
STEP_CASES = {"adaptivekskipmrr2-lap2d-const": ("lap2d-const", 2), "adaptivekskipmrr6-advection": ("advection", 6)}
STEP_MAXITER = 40  # both cases stop there; the advection case has rolled back from k = 6 to 3 by then
# the counters a step moves, read before and after each route
STEP_COUNTERS = (("collectives", "calls"), ("sharded_matvec", "calls"), ("sharded_matvec", "halo_bytes"),
                 ("eager_bodies", "calls"), ("host_read", "calls"), ("eager_graph", "captures"),
                 ("eager_graph", "replays"), ("eager_graph", "bodies"))


def _rhs(case, n):
    rng = np.random.default_rng(12)
    return rng.standard_normal((case["nrhs"], n)) if case["nrhs"] else rng.standard_normal(n)


def _precond(precond, package, A):
    """The preconditioner of a case, from ``package`` (either one)."""
    import importlib

    mod = importlib.import_module(package.__name__ + ".precond")
    if precond == "jacobi":
        return mod.jacobi(A)
    if precond == "chebyshev":
        return mod.chebyshev(A, degree=3, bounds="gershgorin")
    return None


def _options(case, M):
    kw = dict(method=case["method"], k=case["k"], tol=case["tol"], maxiter=case["maxiter"])
    if M is not None:
        kw["M"] = M
    if case["refine"]:
        kw["refine"] = case["refine"]
    return kw


# --- one rank of a world (this file run as a script) ---------------------


def _record(info: dict) -> dict:
    """The info dict without its clock readings."""
    return {key: v for key, v in info.items() if key not in ("time", "compile_time")}


def _result(res) -> dict:
    """A SolveResult as numpy arrays."""
    import dataclasses

    return {f.name: getattr(res, f.name).numpy() for f in dataclasses.fields(res)
            if isinstance(getattr(res, f.name), torch.Tensor)}


def _run_case(case, mesh, fx, cv):
    from krylov_tpu_torch.context import all_reduce

    A = SYSTEMS[case["system"]](fx, cv)
    M = _precond(case["precond"], krylov_tpu_torch, A)
    b = _rhs(case, A.shape[0])
    kw = _options(case, M)
    calls = all_reduce.calls
    out = {}
    if case["kind"] == "solve":
        x, info = krylov_tpu_torch.solve(A, b, mesh=mesh, **kw)
        out.update(x=x.numpy(), info=_record(info))
    elif case["kind"] == "batched":
        out["result"] = _result(krylov_tpu_torch.solve_batched(A, b, mesh=mesh, **kw))
    else:  # solve_device: this rank's rows, and the whole x from solve
        out["x_local"] = krylov_tpu_torch.solve_device(A, b, mesh=mesh, **kw).x.numpy()
        out["x"] = krylov_tpu_torch.solve(A, b, mesh=mesh, **kw)[0].numpy()
    out["all_reduces"] = all_reduce.calls - calls
    if case["kind"] != "device" and not case["refine"]:
        probe = []
        for maxiter in PROBE_MAXITER:
            before = all_reduce.calls
            fn = krylov_tpu_torch.solve_batched if case["nrhs"] else krylov_tpu_torch.solve_device
            res = fn(A, b, mesh=mesh, **dict(kw, tol=0.0, maxiter=maxiter))
            probe.append((all_reduce.calls - before, res.index.reshape(-1)[0].item()))
        out["probe"] = probe
    return out


def _run_matvec(system, mesh, fx, cv):
    from krylov_tpu_torch.context import Context
    from krylov_tpu_torch.dist import shard_operator

    A = SYSTEMS[system](fx, cv)
    op = shard_operator(A, mesh)
    group = mesh.get_group()
    ctx = Context(axis="rows", group=group)
    n, rank = op.local_n, op.rank
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(A.shape[0]))
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((2, A.shape[0])))
    return dict(
        y=op.matvec(x[rank * n: (rank + 1) * n].contiguous(), ctx).numpy(),
        Y=op.matvec(X[:, rank * n: (rank + 1) * n].contiguous(), ctx).numpy(),
        arrays=[a.numpy() for a in op.arrays],
        meta=(op.kind, op.offsets, op.shape, op.n_devices, op.strategy, op.rank, op.grid),
    )


def _errors(mesh, fx):
    """The mesh= errors, raised on every rank before any collective."""
    from krylov_tpu_torch.dist import shard_operator

    A = fx.laplace2d(8)
    b = np.ones(64)
    calls = {
        "chunk_iters": lambda: krylov_tpu_torch.solve(A, b, mesh=mesh, chunk_iters=5),
        "fused": lambda: krylov_tpu_torch.solve(A, b, mesh=mesh, fused=True),
        "batched-fused": lambda: krylov_tpu_torch.solve_batched(A, np.ones((2, 64)), mesh=mesh, fused=True),
        "not-divisible": lambda: shard_operator(fx.poisson1d(101), mesh),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, TypeError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# b = 0 under mesh= (scipy's rule at the port's front door): each method
# with its k, on SYSTEMS["lap2d"]; and a CG batch of three whose member 1
# is zero, beside the batch without it
DEGENERATE_METHODS = {"cg": 0, "kskipmrr": 2, "chronopoulos_gear": 0}
DEGENERATE_TOL, DEGENERATE_MAXITER = 1e-9, 200


def _degenerate(mesh, fx, cv):
    """The zero-b cases of DEGENERATE_METHODS (solve from x0 = 1, and
    solve_device) and the batch with a zero member, as this rank saw them;
    every rank takes the same branch from the all-reduced norm, or the
    others would wait in a collective."""
    from krylov_tpu_torch.context import all_reduce

    A = SYSTEMS["lap2d"](fx, cv)
    n = A.shape[0]
    out = {}
    for method, k in DEGENERATE_METHODS.items():
        kw = dict(method=method, k=k, tol=DEGENERATE_TOL, maxiter=DEGENERATE_MAXITER, mesh=mesh)
        calls = all_reduce.calls
        x, info = krylov_tpu_torch.solve(A, np.zeros(n), x0=np.ones(n), **kw)
        out[method] = dict(x=x.numpy(), info=_record(info), all_reduces=all_reduce.calls - calls,
                           device=_result(krylov_tpu_torch.solve_device(A, torch.zeros(n, dtype=torch.float64),
                                                                         **kw)))
    B = np.random.default_rng(5).standard_normal((3, n))
    B[1] = 0
    kw = dict(method="cg", tol=DEGENERATE_TOL, maxiter=DEGENERATE_MAXITER, mesh=mesh)
    out["batch"] = _result(krylov_tpu_torch.solve_batched(A, B, **kw))
    out["batch_without"] = _result(krylov_tpu_torch.solve_batched(A, B[[0, 2]], **kw))
    return out


def _restarts(mesh, fx, cv):
    """The RESTARTS cases as this rank saw them: solve_device with
    ``restarts=1`` under the mesh (this rank's rows), the single-device
    solve_device of the same system with and without the defect pass."""
    out = {}
    for name, (system, method, k, maxiter) in RESTARTS.items():
        A = SYSTEMS[system](fx, cv)
        b = torch.from_numpy(np.random.default_rng(12).standard_normal(A.shape[0]))
        kw = dict(method=method, k=k, tol=RESTARTS_TOL, maxiter=maxiter, restarts=1, fused=False)
        out[name] = dict(local=_result(krylov_tpu_torch.solve_device(A, b, mesh=mesh, **kw)),
                         single=_result(krylov_tpu_torch.solve_device(A, b, **kw)),
                         first=int(krylov_tpu_torch.solve_device(A, b, **dict(kw, restarts=0)).iterations))
    return out


def _operator_cache(mesh, fx):
    """The sharded operator's cache: the same object for the same operator
    (a solve between included), another for another operator, a new one
    once the operator's coefficients change in place (and the solve
    follows the change), and gone once its operator is."""
    import gc
    import weakref

    from krylov_tpu_torch.dist.solve import sharded_operator

    A, B = fx.laplace2d(8), fx.laplace2d(8, constant=True)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    kw = dict(method="cg", tol=1e-12)
    op, _ = sharded_operator(A, mesh, b)
    before = krylov_tpu_torch.solve_device(A, b, mesh=mesh, **kw).x
    out = dict(same=sharded_operator(A, mesh, b)[0] is op, other=sharded_operator(B, mesh, b)[0] is not op)
    A.coef[2].mul_(1.5)  # the diagonal, in place: a new system
    after = krylov_tpu_torch.solve_device(A, b, mesh=mesh, **kw).x
    rows = slice(mesh.get_local_rank() * after.shape[0], (mesh.get_local_rank() + 1) * after.shape[0])
    want = krylov_tpu_torch.solve_device(A, b, **kw).x[rows]  # a mesh solve returns the rank's rows
    new = sharded_operator(A, mesh, b)[0]
    out["changed"] = new is not op and sharded_operator(A, mesh, b)[0] is new
    out["follows"] = bool(torch.linalg.norm(after - want) <= 1e-9 * torch.linalg.norm(want)
                          and torch.linalg.norm(after - before) > 0.1 * torch.linalg.norm(before))
    gone = weakref.ref(new)
    del A, op, new
    gc.collect()
    out["dropped"] = gone() is None
    return out


class _Stream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _step_graphs():
    """``replay_step``'s graph route on CPU tensors, counted as on the card
    (tests/test_torch_graph.py emulates the block runner's the same way):
    the rule engaged, streams and devices no-ops, an empty cache of keys.
    A "capture" runs the step once with the stream taken as capturing, so
    its counts land in ``tracing.recorded``; a replay runs it again the
    same way, so that its counts reach ``tracing.totals`` only through
    ``tracing.credit`` of what the capture recorded, as a CUDA graph's
    replay counts nothing itself."""
    from krylov_tpu_torch import tracing
    from krylov_tpu_torch.solvers import _common

    capturing = [False]

    def as_captured(fn):
        capturing[0] = True
        try:
            fn()
        finally:
            capturing[0] = False

    def record(fn, device, pool=None):
        as_captured(fn)
        return lambda: as_captured(fn)

    patches = {
        (_common, "step_route"): lambda state: True, (_common, "_record"): record,
        (_common, "_side_stream"): lambda device: _Stream(), (_common, "_BLOCKS"): collections.OrderedDict(),
        (tracing, "_capturing"): lambda: capturing[0], (torch.cuda, "current_stream"): lambda *a: _Stream(),
        (torch.cuda, "stream"): lambda s: contextlib.nullcontext(),
        (torch.cuda, "device"): lambda d: contextlib.nullcontext(),
    }
    saved = {key: getattr(*key) for key in patches}
    for (mod, attr), value in patches.items():
        setattr(mod, attr, value)
    try:
        yield
    finally:
        for (mod, attr), value in saved.items():
            setattr(mod, attr, value)


def _advection():
    """The non-normal 16x16 advection-like stencil of tests/test_kernels.py
    (grid-coefficient form): the adaptive guard rolls back on it."""
    from krylov_tpu_torch.sparse import StencilMatrix

    g, eps = (16, 16), 0.5
    iy, ix = np.arange(g[0])[:, None], np.arange(g[1])[None, :]
    coef = np.stack([-(1 + eps) * np.broadcast_to(iy > 0, g), -(1 + eps) * np.broadcast_to(ix > 0, g),
                     np.full(g, 4.5), -(1 - eps) * np.broadcast_to(ix < g[1] - 1, g),
                     -(1 - eps) * np.broadcast_to(iy < g[0] - 1, g)]).astype(np.float64)
    return StencilMatrix(torch.from_numpy(coef), ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), g)


def _emulated_steps(mesh, fx, cv):
    """Each STEP_CASE's solve_device under the mesh on two right-hand
    sides (one operator: the second request replays the first's graphs),
    eagerly and through ``_step_graphs``: the results and what the
    counters of STEP_COUNTERS moved, by route."""
    from krylov_tpu_torch import tracing

    def reading():
        return [getattr(getattr(tracing.totals, group), field) for group, field in STEP_COUNTERS]

    out = {}
    for name, (system, k) in STEP_CASES.items():
        A = _advection() if system == "advection" else SYSTEMS[system](fx, cv)
        bs = [torch.from_numpy(np.random.default_rng(seed).standard_normal(A.shape[0])) for seed in (1, 2)]
        kw = dict(method="adaptivekskipmrr", k=k, tol=1e-10, maxiter=STEP_MAXITER, mesh=mesh)
        out[name] = {}
        for route in ("eager", "graph"):
            with _step_graphs() if route == "graph" else contextlib.nullcontext():
                before = reading()
                results = [_result(krylov_tpu_torch.solve_device(A, b, **kw)) for b in bs]
                out[name][route] = dict(results=results, counts=[a - c for a, c in zip(reading(), before)])
    return out


def _rank_main(world: int, rank: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist

    from krylov_tpu_torch.diagnostics.dryrun_multichip import dryrun_multichip
    from krylov_tpu_torch.dist import make_mesh
    from krylov_tpu_torch.sparse import convert, fixtures

    torch.set_num_threads(1)
    krylov_tpu_torch.set_default_device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_mesh()
        record = {"cases": {}, "matvecs": {}, "errors": _errors(mesh, fixtures)}
        for name, case in CASES.items():
            if case["P"] == world:
                record["cases"][name] = _run_case(case, mesh, fixtures, convert)
        for system, P in MATVECS:
            if P == world:
                record["matvecs"][system] = _run_matvec(system, mesh, fixtures, convert)
        record["degenerate"] = _degenerate(mesh, fixtures, convert)
        record["restarts"] = _restarts(mesh, fixtures, convert)
        record["cache"] = _operator_cache(mesh, fixtures)
        record["steps"] = _emulated_steps(mesh, fixtures, convert)
        record["dryrun"] = dryrun_multichip(mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(record, f)


# --- the worlds -------------------------------------------------------------


WEAK_SCALING = ["--device", "cpu", "--ranks", "1", "2", "--rows-per-rank", "2048", "--iters", "20", "--method",
                "cg", "--timeout", str(RUN_TIMEOUT)]


class Worlds:
    """The gloo worlds of 2 and 4 ranks and the weak-scaling run, started
    together; :meth:`ranks` waits for a world (within RUN_TIMEOUT of the
    start, else every process is killed) and returns its ranks' records."""

    def __init__(self, root):
        self.t0 = time.monotonic()
        self.procs, self.dirs, self.records = {}, {}, {}
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
        self.weak = subprocess.Popen([sys.executable, "-m", "krylov_tpu_torch.diagnostics.weak_scaling", *WEAK_SCALING],
                                     env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for P in (2, 4):
            d = self.dirs[P] = root / f"world{P}"
            d.mkdir()
            self.procs[P] = [
                subprocess.Popen([sys.executable, os.path.abspath(__file__), "--world", str(P), "--rank", str(r),
                                  "--store", str(d / "store"), "--out", str(d)], env=env, cwd=REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(P)
            ]

    def ranks(self, P: int) -> list:
        if P not in self.records:
            logs = []
            for proc in self.procs[P]:
                try:
                    logs.append(proc.communicate(timeout=max(1.0, RUN_TIMEOUT - (time.monotonic() - self.t0)))[0])
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"the world of {P} gloo ranks did not finish within {RUN_TIMEOUT} s")
            if any(p.returncode for p in self.procs[P]):
                pytest.fail(f"a rank of the world of {P} failed:\n" + "\n".join(log[-3000:] for log in logs))
            self.records[P] = []
            for r in range(P):
                with open(self.dirs[P] / f"rank{r}.pkl", "rb") as f:
                    self.records[P].append(pickle.load(f))  # written by the ranks above
        return self.records[P]

    def weak_scaling(self) -> list:
        """The weak-scaling run's JSON lines."""
        try:
            out, err = self.weak.communicate(timeout=max(1.0, RUN_TIMEOUT - (time.monotonic() - self.t0)))
        except subprocess.TimeoutExpired:
            self.kill()
            pytest.fail(f"the weak-scaling run did not finish within {RUN_TIMEOUT} s")
        assert self.weak.returncode == 0, err[-3000:]
        return [json.loads(line) for line in out.splitlines()]

    def kill(self) -> None:
        for procs in [*self.procs.values(), [self.weak]]:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("gloo"))
    yield w
    w.kill()


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


def _jax_solve(case):
    """The JAX package's sharded solve of ``case`` on as many virtual CPU
    devices: ``(x, info)`` or, batched, the host SolveResult."""
    import jax

    import krylov_tpu
    from krylov_tpu.dist import make_mesh
    from krylov_tpu.sparse import convert, fixtures

    A = SYSTEMS[case["system"]](fixtures, convert)
    mesh = make_mesh(jax.devices()[: case["P"]])
    kw = _options(case, _precond(case["precond"], krylov_tpu, A))
    b = _rhs(case, A.shape[0])
    if case["kind"] == "batched":
        return jax.device_get(krylov_tpu.api.solve_batched(A, b, mesh=mesh, **kw))
    return krylov_tpu.solve(A, b, mesh=mesh, **kw)


def _port_solve(case):
    """The port's single-device solve of ``case``."""
    from krylov_tpu_torch.sparse import convert, fixtures

    A = SYSTEMS[case["system"]](fixtures, convert)
    kw = _options(case, _precond(case["precond"], krylov_tpu_torch, A))
    b = _rhs(case, A.shape[0])
    if case["kind"] == "batched":
        return krylov_tpu_torch.solve_batched(A, b, **kw)
    return krylov_tpu_torch.solve(A, b, **kw)


@pytest.fixture(scope="module")
def references(worlds):
    """The JAX package's sharded solve and the port's single-device solve
    of every solve case, computed while the worlds run."""
    return {name: (_jax_solve(CASES[name]), _port_solve(CASES[name])) for name in SOLVES}


def _exact_count(case) -> bool:
    """Counts equal to the JAX package's: float64 cg, mrr and pcg."""
    return case["method"] in ("cg", "mrr", "pcg") and case["system"] != "lap2d-f32"


@pytest.mark.parametrize("name", SOLVES)
def test_sharded_solve_matches_jax(worlds, references, name):
    case = CASES[name]
    want = references[name][0]
    got = worlds.ranks(case["P"])[0]["cases"][name]
    slack = 0 if _exact_count(case) else case["k"] + 1
    if case["kind"] == "batched":
        res = got["result"]
        np.testing.assert_array_equal(res["converged"], np.asarray(want.converged))
        assert np.all(np.abs(res["iterations"] - np.asarray(want.iterations)) <= slack)
        np.testing.assert_allclose(res["x"], np.asarray(want.x), rtol=1e-8, atol=1e-10)
        return
    x_ref, info_ref = want
    info = got["info"]
    assert info["converged"] and info_ref["converged"]
    assert abs(info["iterations"] - info_ref["iterations"]) <= slack
    if "khistory" in info_ref:
        np.testing.assert_array_equal(info["khistory"], info_ref["khistory"])
    if case["refine"]:
        # float32 solves sum in another order than XLA: the count is not
        # held, the refined float64 x and true residual are
        assert info["true_residual"] < case["tol"] and info_ref["true_residual"] < case["tol"]
    else:
        m = min(len(info["residual"]), len(info_ref["residual"]))
        np.testing.assert_allclose(info["residual"][:m], info_ref["residual"][:m], rtol=1e-6, atol=1e-13)
    assert got["x"].shape == x_ref.shape
    np.testing.assert_allclose(got["x"], x_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", SOLVES)
def test_sharded_solve_matches_single_device(worlds, references, name):
    """tests/test_dist.py::_compare's tolerances, against the port's own
    single-device solve."""
    case = CASES[name]
    want = references[name][1]
    got = worlds.ranks(case["P"])[0]["cases"][name]
    slack = case["k"] + 1
    if case["kind"] == "batched":
        res = got["result"]
        assert res["converged"].all() and bool(want.converged.all())
        assert np.all(np.abs(res["iterations"] - want.iterations.numpy()) <= slack)
        np.testing.assert_allclose(res["x"], want.x.numpy(), rtol=1e-6, atol=1e-9)
        return
    x1, i1 = want
    info = got["info"]
    assert i1["converged"] and info["converged"]
    assert abs(i1["iterations"] - info["iterations"]) <= slack
    np.testing.assert_allclose(got["x"], x1.numpy(), rtol=1e-6, atol=1e-9)
    if case["refine"]:
        assert info["true_residual"] < case["tol"] and i1["true_residual"] < case["tol"]
        return
    m = min(len(i1["residual"]), len(info["residual"]))
    np.testing.assert_allclose(info["residual"][:m], i1["residual"][:m], rtol=1e-4, atol=1e-13)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_reports_the_same(worlds, name):
    """Every rank's info (counts and traces bitwise) and x are the same:
    the host branches of the loops read them, and a rank that branched
    alone would leave the others in a collective."""
    case = CASES[name]
    ranks = [r["cases"][name] for r in worlds.ranks(case["P"])]
    first = ranks[0]
    for other in ranks[1:]:
        assert other["all_reduces"] == first["all_reduces"]
        for key in ("info", "result"):
            if key in first:
                assert set(other[key]) == set(first[key])
                for field, v in first[key].items():
                    np.testing.assert_array_equal(other[key][field], v, err_msg=f"{key}[{field!r}]")
        np.testing.assert_array_equal(other.get("x"), first.get("x"))
    if case["kind"] == "device":
        # solve_device: this rank's rows of the unpadded x
        np.testing.assert_array_equal(np.concatenate([r["x_local"] for r in ranks]), first["x"])


@pytest.mark.parametrize("name", PROBED)
def test_all_reduces_an_iteration(worlds, name):
    """One all-reduce per psum of the JAX loop body, an (outer) iteration;
    a batch, which runs as one (batch, n_local) loop for every method as
    the JAX package's vmap does, makes no more than one system: each
    reduction sums the whole batch's products in one all-reduce."""
    case = CASES[name]
    (c1, i1), (c2, i2) = worlds.ranks(case["P"])[0]["cases"][name]["probe"]
    assert i2 > i1
    assert (c2 - c1) == ALLREDUCES[case["method"]] * (i2 - i1), (c1, i1, c2, i2)


@pytest.mark.parametrize("P", (2, 4))
@pytest.mark.parametrize("method", sorted(DEGENERATE_METHODS))
def test_zero_rhs_under_mesh(worlds, method, P):
    """b = 0 returns x = 0 (whatever x0), 0 iterations, converged and a
    trace of one 0 on every rank, through solve and solve_device, after the
    same all-reduces on every rank."""
    ranks = [r["degenerate"][method] for r in worlds.ranks(P)]
    n = ranks[0]["x"].shape[0]
    for got in ranks:
        assert got["all_reduces"] == ranks[0]["all_reduces"]
        assert got["x"].shape == (n,) and not got["x"].any()
        info = got["info"]
        assert info["converged"] is True and info["iterations"] == 0
        np.testing.assert_array_equal(info["residual"], [0.0])
        dev = got["device"]
        assert dev["x"].shape == (n // P,) and not dev["x"].any()
        assert dev["converged"].all() and not dev["iterations"].any() and not dev["index"].any()
        assert not dev["residual_trace"][..., 0].any()


@pytest.mark.parametrize("P", (2, 4))
def test_batch_with_a_zero_member_under_mesh(worlds, P):
    """The zero member of a batch gets x = 0 after 0 iterations, converged;
    the others are bitwise the batch without it, on every rank."""
    for r in worlds.ranks(P):
        res, alone = r["degenerate"]["batch"], r["degenerate"]["batch_without"]
        assert not res["x"][1].any() and res["iterations"][1] == 0 and res["converged"][1]
        assert not res["residual_trace"][1, 0]
        for field in ("x", "iterations", "converged", "residual_trace", "index"):
            np.testing.assert_array_equal(res[field][[0, 2]], alone[field], err_msg=field)
        assert alone["iterations"].min() > 0


@pytest.mark.parametrize("system, P", MATVECS)
def test_sharded_matvec_matches_dense(worlds, system, P):
    from krylov_tpu_torch.sparse import convert, fixtures

    dense = SYSTEMS[system](fixtures, convert).todense()
    x = np.random.default_rng(1).standard_normal(dense.shape[0])
    X = np.random.default_rng(2).standard_normal((2, dense.shape[0]))
    ranks = [r["matvecs"][system] for r in worlds.ranks(P)]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), dense @ x, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.concatenate([r["Y"] for r in ranks], axis=1), X @ dense.T, rtol=1e-12,
                               atol=1e-13)
    kinds = {r["meta"][0] for r in ranks}
    if system.startswith("lap") and system != "lap2d-16x18":
        assert kinds == {"stencil"}
    if system == "lap2d-16x18":
        assert kinds == {"dia"} and ranks[0]["meta"][4] == "halo"


@pytest.mark.parametrize("system, P", MATVECS)
def test_shard_operator_matches_jax(worlds, system, P):
    """Each rank's block, strategy and geometry equal the JAX package's
    shard_operator cut by from_jax_operator, bitwise (the HYB tail's
    regrouped rows, data and indices included)."""
    from krylov_tpu.dist import shard_operator
    from krylov_tpu.sparse import convert, fixtures

    from krylov_tpu_torch.sparse.convert import from_jax_operator

    jop, _ = shard_operator(SYSTEMS[system](fixtures, convert), P)
    for rank, r in enumerate(worlds.ranks(P)):
        mine = r["matvecs"][system]
        ref = from_jax_operator(jop, device="cpu", rank=rank)
        assert mine["meta"] == (ref.kind, ref.offsets, ref.shape, ref.n_devices, ref.strategy, ref.rank, ref.grid)
        assert len(mine["arrays"]) == len(ref.arrays)
        for a, t in zip(mine["arrays"], ref.arrays):
            assert a.dtype == t.numpy().dtype
            np.testing.assert_array_equal(a, t.numpy())
    if system == "hyb":
        assert np.asarray(jop.arrays[3]).any(), "the HYB fixture must have a tail"


@pytest.mark.parametrize("name", sorted(ERRORS))
@pytest.mark.parametrize("P", [2, 4])
def test_mesh_errors(worlds, name, P):
    kind, match = ERRORS[name]
    for r in worlds.ranks(P):
        got = r["errors"][name]
        assert got is not None and got[0] == kind.__name__ and match in got[1], got


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", sorted(RESTARTS))
def test_mesh_restarts_equal_single_device(worlds, name, P):
    """``restarts=1`` under the mesh: the defect solve runs (the first
    solve stops short of tol at maxiter), and solve_device gives the
    single-device solve's count and a true residual below tol on every
    rank, the same traces on every rank, and its rows, put together, are
    x within 1e-10 of its largest entry."""
    ranks = [r["restarts"][name] for r in worlds.ranks(P)]
    for got in ranks:
        one, local = got["single"], got["local"]
        assert got["first"] < one["iterations"] == local["iterations"]
        assert local["true_residual"] < RESTARTS_TOL and local["converged"] and one["converged"]
        for field in ("iterations", "residual_trace", "nosl_trace", "k_trace", "true_residual"):
            np.testing.assert_array_equal(local[field], ranks[0]["local"][field], err_msg=field)
    x, one = np.concatenate([got["local"]["x"] for got in ranks]), ranks[0]["single"]["x"]
    assert np.abs(x - one).max() <= 1e-10 * np.abs(one).max()


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_operator_cache(worlds, P):
    """One sharded operator for each (A, mesh) while A lives and is not
    changed: a request that comes back finds it, another A gets its own,
    an A changed in place is sharded anew and solved as changed, and
    dropping A drops it."""
    for r in worlds.ranks(P):
        assert r["cache"] == dict(same=True, other=True, changed=True, follows=True, dropped=True)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_emulated_step_graphs_equal_the_eager_mesh_loop(worlds, name, P):
    """The adaptive loop under the mesh, two requests on one operator,
    through the emulated graph route of its steps against the eager route:
    every field of each result bitwise, and the same all-reduces, sharded
    SpMVs, halo bytes, bodies and host reads, the replayed steps' counted
    through what their capture recorded; the graph route captures and
    replays, one body a replay.  On the advection stencil the guard rolls
    back (k falls), and the rollbacks run eagerly between replays."""
    for r in worlds.ranks(P):
        runs = r["steps"][name]
        eager, graph = runs["eager"], runs["graph"]
        for g, e in zip(graph["results"], eager["results"]):
            assert set(g) == set(e)
            for field in e:
                np.testing.assert_array_equal(g[field], e[field], err_msg=field)
        assert graph["counts"][:5] == eager["counts"][:5] and eager["counts"][5:] == [0, 0, 0]
        captures, replays, bodies = graph["counts"][5:]
        assert captures >= 1 and replays >= 1 and bodies == replays
        if name.endswith("advection"):
            k = STEP_CASES[name][1]
            assert all(e["final_k"] < k for e in eager["results"])


@pytest.mark.parametrize("P", [2, 4])
def test_dryrun_multichip(worlds, P):
    """The port's dry run: every solve finite (it raises otherwise), its
    count within k + 1 of the same solve on one rank, and the same on
    every rank."""
    ranks = [r["dryrun"] for r in worlds.ranks(P)]
    assert all(r == ranks[0] for r in ranks)
    assert len(ranks[0]) == 7
    for name, r in ranks[0].items():
        assert abs(r["sharded"] - r["single"]) <= r["k"] + 1, (name, r)


def test_weak_scaling_counts(worlds):
    """krylov_tpu_torch.diagnostics.weak_scaling on worlds of 1 and 2 gloo
    ranks, one line a rank: 20 CG iterations each, 2 all-reduces an
    iteration, and at 2 ranks one plane of 1024 float64 entries received
    by each rank an SpMV (none at 1); nothing gathered."""
    lines = sorted(worlds.weak_scaling(), key=lambda r: (r["ranks"], r["rank"]))
    assert [(r["ranks"], r["rank"]) for r in lines] == [(1, 0), (2, 0), (2, 1)]
    for r in lines:
        assert r["iterations"] == 20 and r["all_reduces_per_outer"] == 2.0 and r["gather_bytes_per_spmv"] == 0
        assert r["n"] == 2048 * r["ranks"] and r["nnz_per_s"] > 0
    assert [r["halo_bytes_per_spmv"] for r in lines] == [0.0, 1024 * 8, 1024 * 8]


def _one_sided(fx, cv):
    """A grid-form stencil that reaches two planes back and none forward
    along the leading axis (lo0 = 2, hi0 = 0)."""
    from krylov_tpu_torch.sparse import StencilMatrix

    coef = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 16, 12)))
    return StencilMatrix(coef, ((0, 0), (-1, 0), (-2, 0), (0, 1)), (16, 12))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("system", ["lap2d", "lap2d-const", "lap3d", "lap3d-const", "one-sided"])
def test_stencil_bulk_and_boundary_planes_match_the_whole_grid(system, P):
    """Each rank's rows from the slab's bulk and the boundary planes
    recomputed from the true halo planes, against the rows of the whole
    grid's product, bitwise (both sum each point's terms in stencil order;
    no world needed)."""
    from krylov_tpu_torch.dist.spmv import ShardedOperator, local_block, partition, stencil_boundary, stencil_bulk
    from krylov_tpu_torch.sparse import convert, fixtures

    A = _one_sided(fixtures, convert) if system == "one-sided" else SYSTEMS[system](fixtures, convert)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, A.shape[0])))
    want = A.matvec(x)
    kind, arrays, offsets, strategy, grid = partition(A, P)
    assert (kind, strategy) == ("stencil", "halo")
    n = A.shape[0] // P
    for rank in range(P):
        op = ShardedOperator(kind=kind, arrays=local_block(kind, arrays, P, rank), offsets=offsets, shape=A.shape,
                             n_devices=P, strategy=strategy, rank=rank, grid=grid)
        lo, hi = op.aux["lo0"] * op.aux["plane"], op.aux["hi0"] * op.aux["plane"]
        start = rank * n
        x_l = x[:, start: start + n].contiguous()
        top = x[:, start - lo: start].contiguous() if rank > 0 and lo else None
        bottom = x[:, start + n: start + n + hi].contiguous() if rank < P - 1 and hi else None
        got = stencil_boundary(op, x_l, stencil_bulk(op, x_l), top, bottom)
        np.testing.assert_array_equal(got.numpy(), want[:, start: start + n].numpy())


def test_mesh_must_be_a_device_mesh():
    A = krylov_tpu_torch.sparse.fixtures.laplace2d(6)
    for call in (lambda: krylov_tpu_torch.solve(A, np.ones(36), mesh=object()),
                 lambda: krylov_tpu_torch.solve_device(A, np.ones(36), mesh="rows"),
                 lambda: krylov_tpu_torch.solve_batched(A, np.ones((2, 36)), mesh=object())):
        with pytest.raises(TypeError, match="one-dimensional torch.distributed DeviceMesh"):
            call()


def test_context_axis_needs_its_group():
    from krylov_tpu_torch.context import Context

    with pytest.raises(ValueError, match="axis= and group= together"):
        Context(axis="rows")


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    from krylov_tpu_torch.dist import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh("cpu")


def test_dist_imports_no_jax():
    code = "import sys, krylov_tpu_torch.dist; sys.exit('jax' in sys.modules or 'krylov_tpu' in sys.modules)"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of a gloo world of the tests above")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    _rank_main(args.world, args.rank, args.store, args.out)
