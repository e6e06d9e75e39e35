"""The port's bench: the stages of the JAX package's ``bench.py`` on the
port's main path, with their checks held.

    python -m krylov_tpu_torch.bench [--method mrr] [--k 4] [--dtype float64]
        [--nx 500] [--tol 1e-5] [--maxiter 3000] [--nrhs 8] [--seed 0]
        [--stages all] [--budget 420] [--device cuda]

With no arguments it runs ``bench.py``'s configuration on the card: MrR on
the 2-D 5-point Laplacian in the constant-weight stencil form,
``laplace2d(500, constant=True)`` (N = 250,000), tol 1e-5, in float64.
The stages, in ``bench.py``'s order (``--stages`` picks some of them, as a
comma list of their names):

1. ``baseline``: the host prelude.  An independent scipy CSR build of the
   same matrix in float64, and the NumPy baseline on ``b`` drawn first from
   ``default_rng(seed)``: MrR for the MrR family, CG for cg and kskipcg.
2. ``headline``: the kernel build (``build_s``), then a checked first
   ``solve`` of the baseline's own ``b`` (``first_call_s``), then three
   fresh right-hand sides of ``solve_device`` between CUDA events, each
   window ending with a host read of the iteration count.
3. ``fidelity``: ``solve(restarts=2)`` and ``solve(refine=3)`` on fresh
   right-hand sides, their true residuals.
4. ``spmv``: K1 (``StencilMatrix.matvec``) on a copy of A scaled by 1/8:
   the slope between eager loops of 200 and 5200 calls, and the replay of
   a CUDA graph of 200 calls.
5. ``amortized``: ``solve_batched`` of ``--nrhs`` fresh right-hand sides.
6. ``api``: ``solve`` from a numpy ``b`` to a numpy ``x``, host transfers
   included.

The last line of standard output is one strict JSON object,
``{"metric", "value", "unit", "vs_baseline", "extra"}``; progress goes to
standard error.  The checks: in float64, the checked count of cg and mrr
equals the NumPy baseline's and a k-skip count lies within max(1%, 2) + k
iterations of its base method's (the k-skip methods test convergence once
an outer iteration of up to k + 1 steps), and every solve's host-float64
true residual is below tol; ``refine=3`` reaches tol in any dtype; on the
card each timed fused solve is one launch on the route the plan picks, and
the graph's result equals the eager loop's.  A failed check, a stage that
raises or a run past ``--budget`` seconds exits 1, with the JSON line
still printed and the failure in ``extra``.  A missing card is torch's
error and exit 1.  On the CPU (``--device cpu``) time is the host clock,
the route counts are 0 (the plain versions run) and the graph rate is
skipped.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import signal
import statistics
import subprocess
import sys
import time

import numpy as np

METHODS = ("cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr")
STAGES = ("baseline", "headline", "fidelity", "spmv", "amortized", "api")
BUDGET_S = 420.0
TRIALS = 3  # fresh right-hand sides of the headline
SPMV_LOOPS = (200, 5200)  # the eager loops whose time difference gives the call rate
GRAPH_CALLS = 200  # K1 calls captured in the CUDA graph
GRAPH_REPLAYS = 10
# published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): float64
# and float32 outside the tensor cores, and HBM bandwidth
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

_T_START = time.perf_counter()


def _stage(msg: str) -> None:
    print(f"[bench] {time.strftime('%H:%M:%S')} (+{time.perf_counter() - _T_START:5.1f}s) {msg}",
          file=sys.stderr, flush=True)


class _Budget(BaseException):
    """The run passed its budget (a BaseException: no stage catches it)."""


def _alarm(signum, frame):
    raise _Budget()


def _finite(obj):
    """Strict-JSON sanitizer: NaN/inf floats become strings."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


def laplace2d_csr_f64(nx: int):
    """Plain scipy 2-D 5-point Dirichlet Laplacian on an nx*nx grid,
    row-major, A = I (x) T + T (x) I with T = tridiag(-1, 2, -1), in
    float64: the matrix of ``laplace2d(nx)``, built without the port."""
    import scipy.sparse as sp

    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx), dtype=np.float64)
    I = sp.identity(nx, dtype=np.float64, format="csr")
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def numpy_mrr(A, b, tol: float, maxiter: int):
    """MrR in NumPy, float64 with scipy SpMV; returns (seconds, iterations,
    final relative residual)."""
    t0 = time.perf_counter()
    b_norm = np.linalg.norm(b)
    r = b.copy()
    Ar = A @ r
    zeta = r.dot(Ar) / Ar.dot(Ar)
    y, z = zeta * Ar, -zeta * r
    r = r - y
    i = 1
    while i < maxiter:
        if np.linalg.norm(r) / b_norm < tol:
            break
        Ar = A @ r
        gamma = y.dot(Ar) / y.dot(y)
        s = Ar - gamma * y
        zeta = r.dot(s) / s.dot(s)
        eta = -zeta * gamma
        y = eta * y + zeta * Ar
        z = eta * z - zeta * r
        r = r - y
        i += 1
    return time.perf_counter() - t0, i, float(np.linalg.norm(r) / b_norm)


def numpy_cg(A, b, tol: float, maxiter: int):
    """CG in NumPy, float64 with scipy SpMV; returns (seconds, iterations,
    final relative residual)."""
    t0 = time.perf_counter()
    b_norm = np.linalg.norm(b)
    r = b.copy()
    p = r.copy()
    gamma = r.dot(r)
    i = 0
    while i < maxiter and np.sqrt(gamma) / b_norm >= tol:
        v = A @ p
        alpha = gamma / p.dot(v)
        r = r - alpha * v
        gamma_new = r.dot(r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        i += 1
    return time.perf_counter() - t0, i, float(np.sqrt(gamma) / b_norm)


def bound(flops: float, nbytes: float, dtype: str):
    """``(seconds, "operations" or "bytes")``: the least time the card could
    take for ``flops`` operations in ``dtype`` and ``nbytes`` moved."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def device_info(dev):
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[dev.index or 0]
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": power}


class Bench:
    """One run: the system, the rng and what the stages report."""

    def __init__(self, args):
        self.args = args
        self.extra = {k: getattr(args, k) for k in ("method", "k", "dtype", "nx", "tol", "maxiter", "nrhs", "seed")}
        self.extra["n"] = args.nx * args.nx
        self.failures = []
        self.baseline_s = None
        self.time_to_solution_s = None

    def check(self, name: str, ok: bool, detail: str) -> None:
        if not ok:
            self.failures.append(f"{name}: {detail}")
            _stage(f"CHECK FAILED {name}: {detail}")

    def setup(self) -> None:
        """The device (torch raises where it is missing), the rng, the
        baseline's ``b`` and the system on the device."""
        import torch

        import krylov_tpu_torch
        from krylov_tpu_torch.sparse import fixtures

        a = self.args
        self.dev = torch.device(a.device)
        torch.empty(0, device=self.dev)  # no card: torch's own error
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.on_cuda = self.dev.type == "cuda"
        krylov_tpu_torch.set_default_device(self.dev)
        self.extra["device"] = device_info(self.dev)
        self.extra["timer"] = "cuda events" if self.on_cuda else "host clock"
        self.dtype = getattr(torch, a.dtype)
        self.np_dtype = np.dtype(a.dtype)
        self.n = a.nx * a.nx
        self.rng = np.random.default_rng(a.seed)
        self.b_base = self.rng.standard_normal(self.n)
        _stage(f"system laplace2d({a.nx}, constant=True) {a.dtype} on {self.dev}")
        self.A = fixtures.laplace2d(a.nx, dtype=self.dtype, constant=True, device=self.dev)
        self.kw = dict(method=a.method, k=a.k if a.method.startswith(("kskip", "adaptive")) else 0,
                       tol=a.tol, maxiter=a.maxiter)
        self.extra["k"] = self.kw["k"]
        self._csr = None

    # helpers

    @property
    def csr(self):
        if self._csr is None:
            self._csr = laplace2d_csr_f64(self.args.nx)
        return self._csr

    def true_rel(self, b, x) -> float:
        """||b - A x|| / ||b|| in float64 on the host, with the scipy matrix."""
        b64 = np.asarray(b, dtype=np.float64)
        x64 = np.asarray(x.double().cpu().numpy() if hasattr(x, "cpu") else x, dtype=np.float64)
        return float(np.linalg.norm(b64 - self.csr @ x64) / np.linalg.norm(b64))

    def fresh(self, shape):
        """Fresh right-hand sides from the rng, on the device in the dtype."""
        import torch

        return torch.from_numpy(self.rng.standard_normal(shape)).to(self.dev, self.dtype)

    def timed(self, fn):
        """``(seconds, host seconds, fn())``: seconds between CUDA events on
        the card (the host clock on the CPU); ``fn`` ends with a host read."""
        import torch

        if not self.on_cuda:
            t0 = time.perf_counter()
            out = fn()
            host = time.perf_counter() - t0
            return host, host, out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.dev)
        start.record()
        t0 = time.perf_counter()
        out = fn()
        end.record()
        end.synchronize()
        host = time.perf_counter() - t0
        return start.elapsed_time(end) / 1e3, host, out

    def hold_true(self, name: str, true: float) -> None:
        """In float64 every solve's true residual is below tol."""
        if self.args.dtype == "float64":
            self.check(name, true < self.args.tol, f"true residual {true:.6e}, tol {self.args.tol:g}")

    def wrapper(self):
        """The fused kernel's wrapper the method launches."""
        from krylov_tpu_torch.kernels import fused, fused_kskip

        return {"cg": fused.fused_cg_solve_2d, "mrr": fused.fused_mrr_solve_2d,
                "kskipcg": fused_kskip.fused_kskipcg_solve_2d, "kskipmrr": fused_kskip.fused_kskipmrr_solve_2d,
                "adaptivekskipmrr": fused_kskip.fused_kskipmrr_solve_2d}[self.args.method]

    def planned_route(self) -> str:
        from krylov_tpu_torch.kernels import fused, fused_kskip

        A, m = self.A, self.args.method
        if m in ("cg", "mrr"):
            return fused.device_plan(m, A.grid, A.stencil, self.dtype, self.dev).route
        return fused_kskip.device_plan(m.removeprefix("adaptive"), A.grid, A.stencil, self.dtype,
                                       max(self.kw["k"], 1), self.dev).route

    # stages

    def baseline(self) -> None:
        """1. The scipy check matrix and the NumPy baseline on the
        baseline's ``b``."""
        a = self.args
        base = "cg" if a.method in ("cg", "kskipcg") else "mrr"
        _stage(f"baseline: scipy check matrix, NumPy {base} (float64)")
        A_csr = self.csr  # built outside the timed baseline
        secs, iters, res = (numpy_cg if base == "cg" else numpy_mrr)(A_csr, self.b_base, a.tol, a.maxiter)
        self.baseline_s = secs
        self.extra.update(baseline_method=base, baseline_s=secs, baseline_iterations=iters,
                          baseline_residual=res)

    def headline(self) -> None:
        """2. The build, the checked first solve of the baseline's ``b``,
        then the timed fresh right-hand sides."""
        import krylov_tpu_torch
        from krylov_tpu_torch import tracing
        from krylov_tpu_torch.kernels import _build

        a, e = self.args, self.extra
        if self.on_cuda:
            _stage("headline: kernel build")
            _build.library()
        e["build_s"] = _build.build_seconds
        _stage("headline: checked first solve of the baseline's b")
        t0 = time.perf_counter()
        x, info = krylov_tpu_torch.solve(self.A, self.b_base, **self.kw)
        e["first_call_s"] = time.perf_counter() - t0
        e["info_time_s"] = info["time"]
        e["checked_iterations"] = info["iterations"]
        e["checked_converged"] = info["converged"]
        e["checked_residual_true"] = true = self.true_rel(self.b_base, x)
        self.hold_true("headline checked solve", true)
        base = e.get("baseline_iterations")
        if base is None:
            e["count_check"] = "skipped: the baseline stage did not run"
        elif a.dtype == "float64":
            got = info["iterations"]
            if a.method in ("cg", "mrr"):
                self.check("headline count", got == base, f"{got} iterations, the NumPy baseline {base}")
            else:
                slack = max(0.01 * base, 2) + self.kw["k"]
                self.check("headline count", abs(got - base) <= slack,
                           f"{got} iterations, the NumPy {e['baseline_method']} baseline {base} (within {slack:g})")

        _stage(f"headline: {TRIALS} fresh right-hand sides of solve_device")
        launched = getattr(tracing.totals, self.wrapper().__name__)
        before = launched.resident, launched.streaming
        trials = []
        for _ in range(TRIALS):
            b = self.fresh(self.n)

            def one():
                res = krylov_tpu_torch.solve_device(self.A, b, **self.kw)
                return res, int(res.iterations)  # the host read ends the window

            secs, host, (res, iters) = self.timed(one)
            trials.append((secs, host, res, iters, b))
        route = {"resident": launched.resident - before[0], "streaming": launched.streaming - before[1]}
        trials.sort(key=lambda t: t[0])
        secs, host, res, iters, b = trials[TRIALS // 2]
        self.time_to_solution_s = secs
        e.update(time_to_solution_s=secs, trials_s=[t[0] for t in trials], host_wall_s=host,
                 host_wall_trials_s=[t[1] for t in trials], iterations=iters,
                 trials_iterations=[t[3] for t in trials], converged=bool(res.converged),
                 residual_recurred=float(res.residual_trace[int(res.index)]),
                 residual_true=self.true_rel(b.cpu().numpy(), res.x), route=route)
        for j, t in enumerate(trials):
            self.hold_true(f"headline trial {j}", self.true_rel(t[4].cpu().numpy(), t[2].x))
        if self.on_cuda:
            planned = self.planned_route()
            e["route_planned"] = planned
            self.check("headline route", route[planned] == TRIALS and sum(route.values()) == TRIALS,
                       f"launches {route}, {TRIALS} {planned} expected")

    def fidelity(self) -> None:
        """3. ``restarts=2`` and ``refine=3`` on fresh right-hand sides."""
        import krylov_tpu_torch

        for key, opt in (("fidelity", dict(restarts=2)), ("fidelity_refine", dict(refine=3))):
            name, value = next(iter(opt.items()))
            _stage(f"fidelity: {name}={value}")
            b = self.rng.standard_normal(self.n).astype(self.np_dtype)
            t0 = time.perf_counter()
            x, info = krylov_tpu_torch.solve(self.A, b, **self.kw, **opt)
            wall = time.perf_counter() - t0
            true = self.true_rel(b, x)
            self.extra[key] = {"path": f"{name}={value}", "true_residual": true,
                               "solver_true_residual": float(info["true_residual"]),
                               "iterations": info["iterations"], "time_s": info["time"], "wall_s": wall}
            if "refinements" in info:
                self.extra[key]["refinements"] = info["refinements"]
            if name == "refine":
                self.check("fidelity refine=3", true < self.args.tol,
                           f"true residual {true:.6e}, tol {self.args.tol:g}")
            else:
                self.hold_true("fidelity restarts=2", true)

    def spmv(self) -> None:
        """4. K1's rate on A / 8: the slope of eager loops, and a CUDA
        graph's replay."""
        import torch

        from krylov_tpu_torch.sparse.formats import StencilMatrix

        e, A = self.extra, self.A
        _stage("spmv: eager loops of K1")
        A8 = StencilMatrix(A.coef / 8.0, A.stencil, A.grid)  # its own tensor: one weight struct
        v = self.fresh(self.n)

        def loop(reps):
            u = v
            for _ in range(reps):
                u = A8.matvec(u)
            return u

        A8.matvec(v)  # warm: the weights' one device-to-host copy
        best = {r: min(self.timed(lambda: loop(r))[0] for _ in range(3)) for r in SPMV_LOOPS}
        e["spmv_loops_s"] = {str(r): t for r, t in best.items()}
        e["spmv_us_call"] = (best[SPMV_LOOPS[1]] - best[SPMV_LOOPS[0]]) / (SPMV_LOOPS[1] - SPMV_LOOPS[0]) * 1e6
        e["spmv_nnz"] = A.nnz
        t_bound, by = bound(2 * A.nnz, 2 * self.n * self.dtype.itemsize, self.args.dtype)
        e.update(spmv_bound_us=t_bound * 1e6, spmv_bound_by=by)
        if not self.on_cuda:
            e.update(spmv_us_device=None, spmv_gnnz_per_s=None, spmv_gflops=None,
                     spmv_graph="skipped: no CUDA graph off the card")
            return
        _stage(f"spmv: CUDA graph of {GRAPH_CALLS} K1 calls")
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.dev)
        with torch.cuda.graph(graph):
            out = loop(GRAPH_CALLS)
        graph.replay()
        self.check("spmv graph", torch.equal(out, loop(GRAPH_CALLS)),
                   f"the replay of {GRAPH_CALLS} captured K1 calls differs from the eager loop")
        per_call = statistics.median(self.timed(graph.replay)[0] for _ in range(GRAPH_REPLAYS)) / GRAPH_CALLS
        e.update(spmv_us_device=per_call * 1e6, spmv_gnnz_per_s=A.nnz / per_call / 1e9,
                 spmv_gflops=2 * A.nnz / per_call / 1e9, spmv_graph=f"{GRAPH_CALLS} calls a replay, "
                 f"median of {GRAPH_REPLAYS} replays")

    def amortized(self) -> None:
        """5. ``solve_batched`` of ``--nrhs`` fresh right-hand sides, two
        batches, the faster reported."""
        import krylov_tpu_torch

        a, e = self.args, self.extra
        _stage(f"amortized: solve_batched of {a.nrhs} right-hand sides")
        per_solve, worst = [], 0.0
        for _ in range(2):
            B = self.fresh((a.nrhs, self.n))

            def batch():
                res = krylov_tpu_torch.solve_batched(self.A, B, **self.kw)
                return res, res.iterations.cpu()  # the host read ends the window

            secs, _, (res, iters) = self.timed(batch)
            per_solve.append(secs / a.nrhs)
            B_np = B.cpu().numpy()
            for j in range(a.nrhs):
                true = self.true_rel(B_np[j], res.x[j])
                worst = max(worst, true)
                self.hold_true(f"amortized member {j}", true)
        e.update(amortized_per_solve_s=min(per_solve), amortized_trials_s=per_solve, nrhs_amortized_over=a.nrhs,
                 iterations_all_rhs=[int(i) for i in iters], amortized_residual_true_max=worst)
        if self.baseline_s:
            e["amortized_vs_baseline"] = self.baseline_s / min(per_solve)

    def api(self) -> None:
        """6. ``solve`` from a numpy ``b`` to a numpy ``x``, after one warm
        call."""
        import krylov_tpu_torch

        _stage("api: solve() with host transfers")
        krylov_tpu_torch.solve(self.A, self.rng.standard_normal(self.n).astype(self.np_dtype), **self.kw)
        b = self.rng.standard_normal(self.n).astype(self.np_dtype)
        t0 = time.perf_counter()
        x = krylov_tpu_torch.solve(self.A, b, **self.kw)[0].cpu().numpy()
        self.extra["solve_api_incl_host_transfer_s"] = time.perf_counter() - t0
        self.hold_true("api solve", self.true_rel(b, x))

    def run(self, stages, budget: float) -> None:
        """Every chosen stage in order; a stage that raises is recorded as
        ``<stage>_error`` and the next runs."""
        self.setup()
        for name in stages:
            if time.perf_counter() - _T_START > budget:
                raise _Budget()
            try:
                getattr(self, name)()
            except Exception as exc:
                self.extra[f"{name}_error"] = f"{type(exc).__name__}: {exc}"
                self.failures.append(f"{name} raised {type(exc).__name__}")
                _stage(f"STAGE FAILED {name}: {type(exc).__name__}: {exc}")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="mrr", choices=METHODS)
    ap.add_argument("--k", type=int, default=4, help="k of the k-skip methods (default 4)")
    ap.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    ap.add_argument("--nx", type=int, default=500, help="grid side; N = nx * nx (default 500)")
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=3000)
    ap.add_argument("--nrhs", type=int, default=8, help="right-hand sides of the amortized stage (default 8)")
    ap.add_argument("--seed", type=int, default=0, help="seed of every right-hand side (default 0)")
    ap.add_argument("--stages", default="all", help=f"'all' or a comma list of {', '.join(STAGES)}")
    ap.add_argument("--budget", type=float, default=BUDGET_S, help=f"seconds the run may take (default {BUDGET_S:g})")
    ap.add_argument("--device", default="cuda", help="the torch device (default cuda)")
    args = ap.parse_args(argv)
    stages = STAGES if args.stages == "all" else tuple(s.strip() for s in args.stages.split(","))
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        ap.error(f"unknown stages {unknown}; choose from {STAGES}")
    args.stages = [s for s in STAGES if s in stages]
    return args


def main(argv=None) -> int:
    """Run the bench; print its JSON line last; 0 when every stage ran and
    every check held, else 1."""
    args = parse(argv)
    bench = Bench(args)
    bench.extra["stages"] = args.stages
    signal.signal(signal.SIGALRM, _alarm)
    signal.setitimer(signal.ITIMER_REAL, args.budget)
    try:
        bench.run(args.stages, args.budget)
    except _Budget:
        bench.extra["budget_exceeded_s"] = args.budget
        bench.failures.append(f"over the budget of {args.budget:g} s")
    except Exception as exc:
        bench.extra["fatal_error"] = f"{type(exc).__name__}: {exc}"
        bench.failures.append(f"fatal {type(exc).__name__}")
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
    e = bench.extra
    e["total_s"] = time.perf_counter() - _T_START
    e["failed_checks"] = bench.failures
    value, base = bench.time_to_solution_s, bench.baseline_s
    result = {
        "metric": f"{args.method}_laplace2d_n{args.nx * args.nx}_{args.dtype}_time_to_solution",
        "value": value,
        "unit": "s",
        "vs_baseline": base / value if (value and base) else None,
        "extra": _finite(e),
    }
    print(json.dumps(result, allow_nan=False), flush=True)
    return 1 if bench.failures else 0


if __name__ == "__main__":
    sys.exit(main())
