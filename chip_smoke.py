"""Smoke run of the PyTorch/CUDA port (krylov_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card (K4, the resident stencil
pass inside K2/K3/K5/K6, alone through its probe: the pass specialised on
the term count bitwise the masked one, phase 3b; each resident launch
counted by the specialisation it took), then drives two paths of
``krylov_tpu_torch.solve`` on the 2-D 5-point Laplacian at N = 250,000
(constant-weight stencil form) in float64 and float32: MrR and CG (and a
float64 MrR warm-started from the float32 answer), which run K2/K3 on their
resident route, then k-skip CG (k=4), k-skip MrR (k=4) and adaptive k-skip
MrR (k=8), which run K5/K6 on theirs, each printing a SHA-256 digest of
its x and trace (``python3 chip_smoke.py --digests`` prints those lines
alone, for a checkout of another commit to compare); then degenerate
systems, an exact warm start and b = 0, for every method and both fused
routes, and batches with a zero member (phase 5c).  K2/K3's streaming route is held
against its plain version on ``laplace2d(1500)`` (N = 2.25M), above the
resident route's capacity, and solves BASELINE row 5's system,
``laplace3d(216)`` (N = 10.08M), with cg and mrr through ``solve_device``
and ``solve`` (phase 6f, ``--k23`` runs it and 6c alone); K5/K6's streaming route is forced at N = 250k,
held beside the resident one against the same plain run (of the first
seed) and driven through the k-skip path.  K1 is timed beside its one-call yardstick,
``torch.nn.functional.conv2d``.
It checks the float64 solves against float64 references (scipy/numpy MrR and CG; the JAX
package's counts for the k-skip family) with the true residual below tol,
holds the fused kernels against their plain versions at that size while it
times them with CUDA events.  Then it drives the paths that reuse the
kernels: ``restarts=``/``refine=`` on the same system, ``solve_batched`` of
8 right-hand sides (fused MrR; eager CG on a HYB operator), the HYB
operator of ``powerlaw_spd(2**20)`` (matvec against scipy, CG against
numpy, Matrix Market IO), the ill-conditioned row-4b system of
RESULTS.md, printed only (CG, the k-skip family, Jacobi-preconditioned CG
and the Chebyshev CA solvers); last, the preconditioned, pipelined and CA
solves of the main-path system on the eager loops, whose every SpMV is K1,
float64 held to the JAX package's counts and K1 timed on that path beside
the same loop over K1's plain version; the Chebyshev step held bit for bit
against the loop it replaces at that size and timed beside it (phase 11b,
``--cheb`` runs it alone after the build); the four kernels of pcg's eager
body held against the same steps on torch's passes and timed beside them
(phase 11c, ``--pcg``).  Then the paths of chunked solves
on the main-path system: ``solve(chunk_iters=)`` of the seven carry
methods held against their unbroken eager solves, and ``fused=True``
chunks (one K2/K3/K5 launch a chunk); a checkpoint of a first chunk saved,
loaded and resumed; ``solve_batched`` of 8 right-hand sides on the eager
k-skip loops, each member held against its solo solve; and the
``condition.json`` driver, ``python -m krylov_tpu_torch solve``, in a
subprocess (phase 15, started after the build beside the untimed checks
of phases 3-4b and read before phase 5, as are the five examples of
``krylov_tpu_torch.examples``, phase 19); ``solve_batched`` of 8
right-hand sides on the batched pipelined and CA loops, each member held
bitwise against its solo solve (phase 17); ``solve(mesh=)`` and
``solve_batched(mesh=)`` in an NCCL world of one (phase 16); last, in a
process of its own, the profiler's traces of the main path and
``phase_times`` (phase 18); last, the port's bench, ``python -m
krylov_tpu_torch.bench``, in a subprocess, with its defaults (float64 MrR)
and with k-skip MrR k=4 (phase 20).  It prints a JSON line of the kernels
and last a JSON line with the device.

Imports no JAX.  Any failed check raises, so the exit code is nonzero; with
no CUDA device it exits 1 before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

NX = 500  # N = 250,000: the main-path system
TOL = 1e-5
MAXITER = 3000
# fused kernel against its plain version: the sums run in another order
# (per-block partials), so the recurrences drift apart by rounding over
# ~1000 iterations.  The float32 limits sit about 10x above the largest
# differences read on an H100 (700 W) at N = 250k: trace 7.8e-6 relative,
# x 9.9e-5 absolute with max |x| ~ 76 for the streaming kernels, trace
# 7.1e-6, x 9.9e-5 for the resident ones, whose sums run in another order
# again (PERF.md); a wrong kernel misses them by orders.  The float64
# limits are those of tests/test_torch_cuda.py; the largest float64
# readings, on either route, are trace 9.3e-15 relative and x 2.0e-13
# absolute.
TOLS = {
    "float64": dict(trace_rtol=1e-9, x_rtol=1e-8, x_atol=1e-12),
    "float32": dict(trace_rtol=1e-4, x_rtol=1e-4, x_atol=1e-3),
}


# fused k-skip kernel (K5/K6) against its plain version, the eager loop on
# the same stencil: equal counts, nosl, ktrace and final k, the residual
# trace within trace_rtol entry by entry and max |x - x_plain| / max
# |x_plain| within x_rel.  Each limit sits 10x above the largest reading on
# an H100 (700 W) over the seeds of its phase and both routes (beside it;
# PERF.md).
# The k-step recurrences amplify the rounding of the inner products, by
# about 1e6 at k = 4 and 1e12 at k = 8 (the float64 readings over eps), so
# the float64 limits grow with k.  In float32 that leaves no reproducible
# trajectory at k >= 4: there a kernel is held over its first outer
# iteration at k = 4 against the plain version in float64 on the same
# inputs (its float32 rounding, amplified); at k = 8 not a digit of float32
# is left, so those solves are printed, not held.  Whole float32 solves are
# held at k = 1 and 2 and in the rollback case.
KSKIP_SMALL_TOLS = {  # whole solves; ("float32", 4): the first outer iteration
    ("float64", 1): dict(trace_rtol=2.3e-13, x_rel=2.1e-14),  # 2.207e-14, 2.005e-15
    ("float64", 2): dict(trace_rtol=6.2e-14, x_rel=3.6e-13),  # 6.184e-15, 3.585e-14
    ("float64", 4): dict(trace_rtol=3e-8, x_rel=2.6e-10),  # 2.938e-09, 2.536e-11
    ("float64", "rollback"): dict(trace_rtol=6.2e-6, x_rel=4.1e-15),  # 6.149e-07, 4.034e-16
    ("float32", 1): dict(trace_rtol=6.9e-4, x_rel=1.5e-5),  # 6.841e-05, 1.480e-06
    ("float32", 2): dict(trace_rtol=4.3e-2, x_rel=1.4e-4),  # 4.287e-03, 1.339e-05
    ("float32", 4): dict(trace_rtol=0.35, x_rel=0.23),  # 3.477e-02, 2.251e-02
    ("float32", "rollback"): dict(trace_rtol=0.18, x_rel=3.3e-6),  # 1.794e-02, 3.249e-07
}
KSKIP_FULL = {  # (method, k, dtype): limits at N = 250k over SEEDS (streaming: SEEDS[0])
    ("kskipcg", 4, "float64"): dict(trace_rtol=1.1e-8, x_rel=3.1e-10),  # 1.091e-09, 3.018e-11
    ("kskipmrr", 4, "float64"): dict(trace_rtol=3.1e-14, x_rel=3.1e-9),  # 3.077e-15, 3.075e-10
    ("kskipmrr", 8, "float64"): dict(trace_rtol=1.8e-2, x_rel=2.1e-3),  # 1.762e-03, 2.033e-04
    ("adaptivekskipmrr", 8, "float64"): dict(trace_rtol=1.8e-2, x_rel=2.1e-3),  # the same
    ("kskipcg", 1, "float32"): dict(trace_rtol=4.9e-3, x_rel=1.4e-4),  # 4.900e-04, 1.337e-05
    ("kskipmrr", 2, "float32"): dict(trace_rtol=7.2e-2, x_rel=5.7e-3),  # 7.171e-03, 5.663e-04
    # the first outer iteration, against the float64 plain version
    ("kskipcg", 4, "float32"): dict(trace_rtol=0.33, x_rel=8.8e-2),  # 3.266e-02, 8.711e-03
    ("kskipmrr", 4, "float32"): dict(trace_rtol=6.5e-3, x_rel=0.12),  # 6.490e-04, 1.134e-02
    ("adaptivekskipmrr", 4, "float32"): dict(trace_rtol=6.5e-3, x_rel=0.12),  # as static k=4: no rollback yet
}
# The k-skip main path, with the counts of krylov_tpu.solve (the JAX
# package) on the CPU with x64 on the same system, b, tol and maxiter:
# (iterations, outer iterations = len(residual) - 1) in float64; in float32
# it gave 1460, 3001 (not converged) and 1083 (final k 3), not held here.
KSKIP_RUNS = {"kskipcg": 4, "kskipmrr": 4, "adaptivekskipmrr": 8}
# the main-path fused solves whose x and trace digests phases 5 and 5b
# print (and chip_smoke.py --digests alone): (method, k)
DIGEST_RUNS = (("mrr", 0), ("cg", 0), *KSKIP_RUNS.items())
# K4, the resident stencil pass: its specialisations (the NS of
# kernels/csrc/resident.cuh, 0 the masked pass), and the systems of phase
# 3b on which the specialised pass is held bitwise against the masked one
K4_PASSES = (0, 5, 7)
K4_SYSTEMS = {"laplace2d(500)": ("laplace2d", (NX,)), "laplace3d(16)": ("laplace3d", (16,)),
              "laplace3d(64)": ("laplace3d", (64,)), "laplace2d(503, 493)": ("laplace2d", (NX + 3, NX - 7))}
# Phase 5c, degenerate systems on the main-path system in float64: the
# methods and their k (s for cacg/camrr)
DEGENERATE_RUNS = {"cg": 0, "mrr": 0, "kskipcg": 4, "kskipmrr": 4, "adaptivekskipmrr": 8, "cacg": 4, "camrr": 4,
                   "pcg": 0, "chronopoulos_gear": 0, "gropp": 0, "pipelined_cg": 0}
KSKIP_F64 = {"kskipcg": (1055, 211), "kskipmrr": (936, 188), "adaptivekskipmrr": (937, 105)}
# Phase 11, the preconditioned, pipelined and CA solves on the eager loops:
# (method, preconditioner, k) and, in float64, (iterations, outer
# iterations = len(residual) - 1) of krylov_tpu.solve (the JAX package) on
# the CPU with x64 on the same laplace2d(NX, constant=True), b, tol and
# maxiter, with M = None, krylov_tpu.precond.jacobi(A) or
# krylov_tpu.precond.chebyshev(A, degree=6) (bounds "auto": Lanczos,
# [0.04192096913891128, 8.354414605129453]) and, for cacg/camrr, s = k and
# the bounds of krylov_tpu.precond.lanczos_bounds(A).  Jacobi on the
# constant-diagonal Laplacian scales by 1/4 and keeps CG's count.
PRECOND_RUNS = [("pcg", "none", 0), ("pcg", "jacobi", 0), ("pcg", "chebyshev6", 0),
                ("chronopoulos_gear", "jacobi", 0), ("gropp", "jacobi", 0), ("pipelined_cg", "jacobi", 0),
                ("cacg", "none", 4), ("cacg", "none", 8), ("camrr", "none", 4), ("camrr", "none", 8)]
PRECOND_F64 = dict(zip(PRECOND_RUNS, [(1053, 1053), (1053, 1053), (190, 190), (1053, 1053), (1053, 1053),
                                      (1053, 1053), (1056, 264), (1056, 132), (937, 235), (937, 118)]))
# Phase 12, chunked exact continuation on the main-path system in float64:
# (method, k) and the iterations of the unbroken solve (the f64 counts of
# phases 5, 5b and 11), which every chunked solve must take
CHUNK_RUNS = {("cg", 0): 1053, ("mrr", 0): 934, ("kskipcg", 4): 1055, ("kskipmrr", 4): 936,
              ("adaptivekskipmrr", 8): 937, ("cacg", 4): 1056, ("camrr", 4): 937}
CHUNK_ITERS = 250
# Phase 16, the row-partitioned path (solve(mesh=)) in an NCCL world of one
# on the main-path system in float64: (method, k, preconditioner) and the
# counts of the eager solves (PERF.md section 2), which the sharded solves
# must take, with x bitwise equal to the eager solve's
SHARDED_RUNS = {("cg", 0, None): 1053, ("mrr", 0, None): 934, ("kskipcg", 4, None): 1055,
                ("kskipmrr", 4, None): 936, ("adaptivekskipmrr", 8, None): 937, ("pcg", 0, "jacobi"): 1053,
                ("cacg", 4, None): 1056}
SHARDED_TIMED = (("cg", 0), ("kskipmrr", 4))  # sharded against eager, paired: eager, sharded, sharded, eager
SHARDED_BATCHED = (("pcg", 0, "jacobi"), ("cacg", 4, None))  # 16b: solve_batched(mesh=) of 4 RHS
# Phase 17, solve_batched of NRHS right-hand sides (seed 21, float64) on the
# batched eager loops of the main-path system: (method, preconditioner, k),
# PRECOND_RUNS' configurations; each member held bitwise against its solo
# solve
BATCHED_RUNS = [("pcg", "none", 0), ("pcg", "jacobi", 0), ("pcg", "chebyshev6", 0),
                ("chronopoulos_gear", "jacobi", 0), ("gropp", "jacobi", 0), ("pipelined_cg", "jacobi", 0),
                ("cacg", "none", 4), ("camrr", "none", 4)]
# Phase 19, the examples of krylov_tpu_torch.examples as subprocesses on the
# card: their time limit in seconds, and the lines tests/test_examples.py
# asserts for their JAX twins, as (text, count; None: at least once)
EXAMPLE_TIMEOUT = 300
PROFILING_TIMEOUT = 300  # phase 18's process, in seconds
CHEB_BATCH = 3  # phase 11b: the block's members
CHEB_REPS = 200  # phase 11b: applications a timing
# Phase 11c, the four kernels of pcg's eager body (kernels.pcg): the vectors
# of n points each step's kernel moves (step_alpha reads s, p; step_xr reads
# x, p, r, s and writes x, r; step_ru reads r, u; step_p reads u, p and
# writes p), calls a timing, the tol of step_alpha's inputs (member 1 of
# the block converged, 0 and 2 not) and the limit of an inner product's
# error, a share of the sum of its terms' magnitudes: a partial lost or
# summed twice moves it by some 1e-4
PCG_STEP_VECTORS = {"alpha": 2, "xr": 6, "ru": 2, "p": 3}
PCG_STEP_REPS = 200
PCG_STEP_TOL = 1e-3
PCG_STEP_REL = {"torch.float64": 1e-12, "torch.float32": 1e-5}
EXAMPLE_MARKERS = {
    "basic_solve": (("converged", 5),),
    "preconditioned": (("converged=True", 12),),
    "multi_rhs_solve": (("converged=True", 8),),
    "production_long_solve": (("matches unbroken solve", None), ("resumed: converged=True", None)),
    "distributed_solve": (("true relative residual", None),),
}
# Phase 20, the port's bench (python -m krylov_tpu_torch.bench) as a
# subprocess: its arguments and the checked count of its float64 solve
# (PERF.md section 2), its time limit and its own budget, in seconds
BENCH_RUNS = {(): 934, ("--method", "kskipmrr", "--k", "4"): 936}
BENCH_TIMEOUT = 300
BENCH_BUDGET = 240
# runs one example as its own module's __main__, then prints the launch
# counts of the hand kernels in its process as a last line
EXAMPLE_RUNNER = """
import json, runpy, sys
from krylov_tpu_torch import tracing
name = sys.argv[1]
sys.argv = [name, "--device", "cuda"]
runpy.run_module("krylov_tpu_torch.examples." + name, run_name="__main__", alter_sys=True)
t = tracing.totals
counts = {"stencil_matvec_2d": t.stencil_matvec_2d.launches, "chebyshev_apply": t.chebyshev_apply.launches}
counts["pcg_launches"] = [getattr(t.pcg_launches, step) for step in ("alpha", "xr", "ru", "p")]
for fn in ("fused_cg_solve_2d", "fused_mrr_solve_2d", "fused_kskipcg_solve_2d", "fused_kskipmrr_solve_2d"):
    counts[fn] = [getattr(t, fn).resident, getattr(t, fn).streaming]
print("launches " + json.dumps(counts), flush=True)
"""
# chunked against unbroken eager solves: the same loop bodies on the same
# values, but a chunk's last residual is its final ||r||, where the
# unbroken solve records the recurred one
CHUNK_RTOL = 1e-10
SEEDS = (1, 2, 3)  # fresh b of the timed comparisons
KSKIP_ROUTES = ("resident", "streaming")  # K5/K6's routes, each held against the same plain run
T0 = time.perf_counter()
NX_STREAM = 1500  # N = 2.25M: above the resident route's capacity in float64
MAXITER_STREAM = 300  # the streaming phase's fixed iteration count
# Phase 6e, BASELINE row 5 (benchmarks/baseline_configs.py): adaptive k-skip
# MrR k = 8 on laplace3d(216, constant=True), N = 10,077,696, through
# solve_device and solve with these arguments and b =
# default_rng(0).standard_normal(N); far above the resident route's
# capacity, so K5 streams.  ROW5_JAX: the JAX package's float64
# (iterations, outer iterations, final k) on that b, from
# krylov_tpu.solve_device(laplace3d(216, constant=True), b, **ROW5) on the
# CPU with x64 (JAX_PLATFORMS=cpu, its eager loop there; 69 s on 8 cores):
# true residual 9.4686e-05, so the restarts= pass did not run; the last
# recurred residuals 1.1408e-04, 9.4686e-05
ROW5_NX = 216
ROW5 = dict(method="adaptivekskipmrr", k=8, tol=1e-4, restarts=1, maxiter=4000)
ROW5_JAX = (271, 31, 8)
# Phase 6f: row 5's system and b with cg and mrr, through solve_device and
# solve (float32 also restarts=1): far above the resident route's capacity,
# so K3/K2 stream.  ROW5_K23_JAX: the JAX package's float64 iterations on
# that b, from krylov_tpu.solve_device(laplace3d(216, constant=True), b,
# method=m, **ROW5_K23) on the CPU with x64 (JAX_PLATFORMS=cpu,
# jax_enable_x64; 68 s for cg, 82 s for mrr on 8 cores): host f64 true
# residuals 9.9092e-05 (cg) and 9.8683e-05 (mrr); the last recurred
# residuals 1.0105e-04, 9.9092e-05 (cg) and 1.0075e-04, 9.8683e-05 (mrr)
ROW5_K23 = dict(tol=1e-4, maxiter=4000)
ROW5_K23_JAX = {"cg": 350, "mrr": 269}
# laplace3d(ROW5_MID), N = 1M, streams in both dtypes: K5/K6's streaming
# route held against its plain version there (float64 whole solves of
# ROW5_MID_RUNS under KSKIP_FULL's limits; float32 first outer iterations
# at k = 4 against the float64 plain version)
ROW5_MID = 100
ROW5_MID_RUNS = (("adaptivekskipmrr", 8), ("kskipcg", 4))
# published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): float64 and
# float32 outside the tensor cores, and HBM bandwidth
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# shared-memory bytes an H100 SM serves a clock: K4's bound, whose operands
# are on chip (the mirror in shared memory, the weights in the arguments)
SMEM_BYTES_PER_CLOCK = 128
NRHS = 8  # right-hand sides of the batched phase (bench.py's amortised stage)
# batched eager CG on the HYB against solo solves: the dot products and the
# matvec's row sums reduce in other kernels on a (batch, n) block than on
# one vector, so x may differ by rounding only
X_REL_EAGER = 1e-12


def first_outer(method, k, outer):
    """maxiter that stops a k-skip solve after ``outer`` outer iterations
    (k-skip MrR spends one iteration on its init half-step)."""
    return outer * (k + 1) + (method != "kskipcg")


def phase(msg: str) -> None:
    print(msg, flush=True)


def mark(name: str) -> None:
    """Print the seconds since the start, as a phase begins."""
    phase(f"-- {name} at {time.perf_counter() - T0:.1f} s")


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def bound(flops: float, nbytes: float, dtype: str):
    """``(ms, "operations" or "bytes")``: the least time the card could take
    for ``flops`` operations in ``dtype`` and ``nbytes`` moved, the larger of
    the two over the published peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def fused_flops(method: str, nnz: int, n: int, iters: int) -> float:
    """Operations of a K2 (MrR) or K3 (CG) solve of ``iters`` iterations: a
    stencil (2 nnz) and the pointwise work, 20 n for MrR (six products or
    sums, the y, z, x and r updates) and 10 n for CG (sigma, gamma, the x, r
    and p updates), an iteration."""
    return iters * (2 * nnz + (20 if method == "mrr" else 10) * n)


def kskip_flops(method: str, k: int, nnz: int, n: int, outer: int) -> float:
    """Operations of a K5/K6 solve of ``outer`` outer iterations at k: 3k + 2
    stencils (the two basis streams and the steps), 6k + 6 products of the
    bundle and k + 1 vector steps (CG: x, r, p; MrR: y, z, x, r), each
    outer iteration."""
    step = 6 if method == "kskipcg" else 10
    return outer * ((3 * k + 2) * 2 * nnz + (6 * k + 6) * 2 * n + (k + 1) * step * n)


def numpy_mrr(A, b, tol, maxiter, x0=None):
    """Float64 MrR with scipy SpMV; returns (iterations, residual history)."""
    import numpy as np

    b_norm = np.linalg.norm(b)
    r = b.copy() if x0 is None else b - A @ x0
    hist = [np.linalg.norm(r) / b_norm]
    Ar = A @ r
    zeta = r.dot(Ar) / Ar.dot(Ar)
    y, z = zeta * Ar, -zeta * r
    r = r - y
    i = 1
    while i < maxiter:
        hist.append(np.linalg.norm(r) / b_norm)
        if hist[-1] < tol:
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
    return i, hist


def numpy_cg(A, b, tol, maxiter):
    """Float64 CG with scipy SpMV; returns (iterations, residual history)."""
    import numpy as np

    b_norm = np.linalg.norm(b)
    r = b.copy()
    p = r.copy()
    gamma = r.dot(r)
    hist = []
    i = 0
    while i < maxiter:
        hist.append(np.sqrt(gamma) / b_norm)
        if hist[-1] < tol:
            break
        v = A @ p
        alpha = gamma / p.dot(v)
        r = r - alpha * v
        gamma_new = r.dot(r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        i += 1
    return i, hist


def torch_cg(A, b, tol, maxiter):
    """Float64 CG with torch's sparse CSR SpMV (a library call, used nowhere
    in the port) on ``A``'s device; returns (iterations, residual history)."""
    b_norm = float(b.norm())
    r = b.clone()
    p = r.clone()
    gamma = r.dot(r)
    hist = []
    i = 0
    while i < maxiter:
        hist.append(float(gamma.sqrt()) / b_norm)
        if hist[-1] < tol:
            break
        v = A @ p
        alpha = gamma / p.dot(v)
        r = r - alpha * v
        gamma_new = r.dot(r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        i += 1
    return i, hist


def cuda_ms(fn, reps=1):
    """Mean milliseconds of ``fn()`` on the card, between CUDA events, and
    what the last call returned."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def compare_solves(label, got, want, trace_rtol, x_rtol, x_atol):
    """Hold a fused kernel's ``(x, trace, iters, conv)`` against its plain
    version's: equal iterations and convergence, the residual traces within
    ``trace_rtol`` entry by entry, and x within ``x_rtol``/``x_atol``.
    Prints the errors first; returns max |x - x_plain|."""
    import torch

    (x, t, i, c), (xr, tr, ir, cr) = got, want
    i, ir = int(i), int(ir)
    m = min(i, ir) + 1
    t_err = float(((t[:m] - tr[:m]).abs() / tr[:m].abs()).max())
    x_err = float((x - xr).abs().max())
    phase(f"  {label}: iters {i} (plain {ir}), conv {bool(c)} (plain {bool(cr)}), "
          f"trace max rel err {t_err:.3e} (tol {trace_rtol:g}), x max abs err {x_err:.3e} "
          f"= {x_err / float(xr.abs().max()):.3e} of max |x| (rtol {x_rtol:g}, atol {x_atol:g})")
    if i != ir or bool(c) != bool(cr):
        raise AssertionError(f"{label}: {i} iterations (conv {bool(c)}), the plain version {ir} ({bool(cr)})")
    torch.testing.assert_close(t[:m], tr[:m], rtol=trace_rtol, atol=0)
    torch.testing.assert_close(x, xr, rtol=x_rtol, atol=x_atol)
    return x_err


def advection(device):
    """The non-normal 16x16 advection-like stencil of tests/test_kernels.py,
    grid-coefficient form: adaptive k-skip MrR rolls back on it."""
    import numpy as np
    import torch

    from krylov_tpu_torch.sparse import StencilMatrix

    g, eps = (16, 16), 0.5
    iy, ix = np.arange(g[0])[:, None], np.arange(g[1])[None, :]
    coef = np.stack([
        -(1 + eps) * np.broadcast_to(iy > 0, g).astype(float),
        -(1 + eps) * np.broadcast_to(ix > 0, g).astype(float),
        np.full(g, 4.5),
        -(1 - eps) * np.broadcast_to(ix < g[1] - 1, g).astype(float),
        -(1 - eps) * np.broadcast_to(iy < g[0] - 1, g).astype(float),
    ])
    return StencilMatrix(torch.from_numpy(coef).to(device), ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), g)


def kskip_call(method, k, A, b, tol, maxiter, plain=False, plain64=False):
    """The fused k-skip kernel (or its plain version; ``plain64``: the plain
    version in float64 on the same values) for ``method`` on ``A x = b``
    from x0 = 0, in K5's output layout ``(x, trace, nosl, ktrace, iters,
    conv, index, final_k)`` (K6 gives None for ktrace and final_k)."""
    import torch

    from krylov_tpu_torch.kernels import fused_kskip as fk

    if plain64:
        A, b, plain = type(A)(A.coef.double(), A.stencil, A.grid), b.double(), True
    coef2, st2, g2, sub = A.collapse_to_2d()
    b_norm = torch.linalg.vector_norm(b)
    kw = dict(stencil=st2, grid=g2, maxiter=maxiter, k_max=max(k, 1), sub=sub)
    if method == "kskipcg":
        fn = fk.fused_kskipcg_solve_2d_reference if plain else fk.fused_kskipcg_solve_2d
        x, t, n, i, c, idx = fn(coef2, b, tol, b_norm, k, **kw)
        return x, t, n, None, i, c, idx, None
    fn = fk.fused_kskipmrr_solve_2d_reference if plain else fk.fused_kskipmrr_solve_2d
    return fn(coef2, b, tol, b_norm, k, adaptive=method == "adaptivekskipmrr", **kw)


def kskip_routes(method, k, A, b, tol, maxiter, routes=KSKIP_ROUTES) -> dict:
    """:func:`kskip_call` of the kernel on each of ``routes``, forced
    through ``kernels.fused.ROUTE`` (a forced resident route that does not
    fit raises), timed between CUDA events: ``{route: (ms, output)}``."""
    from krylov_tpu_torch.kernels import fused

    out = {}
    for route in routes:
        fused.ROUTE = route
        try:
            out[route] = cuda_ms(lambda: kskip_call(method, k, A, b, tol, maxiter))
        finally:
            fused.ROUTE = None
    return out


def held(failures: list, check, *args, **kw):
    """``check(*args, **kw)``; an AssertionError is printed and joins
    ``failures`` (the phase raises them together once every reading is
    printed) and gives None."""
    try:
        return check(*args, **kw)
    except AssertionError as e:
        phase(f"  FAILED: {e}")
        failures.append(str(e).splitlines()[0])
        return None


def raise_failures(name: str, failures: list) -> None:
    if failures:
        raise AssertionError(f"{name}: {len(failures)} check(s) failed: " + "; ".join(failures))


def compare_kskip(label, got, want, trace_rtol, x_rel):
    """Hold a fused k-skip kernel's output against its plain version's (in
    float64, whatever the dtypes): equal iterations, outer iterations,
    convergence, nosl and (K5) ktrace and final k; traces within
    ``trace_rtol`` entry by entry, max |x - x_plain| / max |x_plain| within
    ``x_rel``.  Prints the errors first; returns max |x - x_plain|."""
    import torch

    (x, t, n, kt, i, c, idx, f), (xr, tr, nr, ktr, ir, cr, idr, fr) = got, want
    x, t, xr, tr = x.double(), t.double(), xr.double(), tr.double()
    m = min(int(idx), int(idr)) + 1
    t_err = float(((t[:m] - tr[:m]).abs() / tr[:m].abs()).max())
    x_err = float((x - xr).abs().max())
    x_rel_err = x_err / float(xr.abs().max())
    fk = "" if f is None else f", final k {int(f)} (plain {int(fr)})"
    phase(f"  {label}: iters {int(i)} (plain {int(ir)}), outer {int(idx)} (plain {int(idr)}), "
          f"conv {bool(c)} (plain {bool(cr)}){fk}, trace max rel err {t_err:.3e} (tol {trace_rtol:g}), "
          f"x max abs err {x_err:.3e} = {x_rel_err:.3e} of max |x| (tol {x_rel:g})")
    if (int(i), int(idx), bool(c)) != (int(ir), int(idr), bool(cr)):
        raise AssertionError(f"{label}: counts differ from the plain version")
    if not torch.equal(n[:m], nr[:m]) or (kt is not None and (not torch.equal(kt[:m], ktr[:m]) or int(f) != int(fr))):
        raise AssertionError(f"{label}: nosl, ktrace or final k differ from the plain version")
    torch.testing.assert_close(t[:m], tr[:m], rtol=trace_rtol, atol=0)
    if not x_rel_err <= x_rel:
        raise AssertionError(f"{label}: x differs from the plain version by {x_rel_err:.3e} of max |x|")
    return x_err


def device_us(fn, kernel: str, reps: int):
    """Mean device time in microseconds of the CUDA kernel whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls; None when the
    profiler recorded no device time for it in three tries (a profile of
    one long cooperative launch has come back without its kernel record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            total = getattr(evt, "device_time_total", 0) or getattr(evt, "cuda_time_total", 0)
            if kernel in evt.key and total and evt.count:
                return total / evt.count
    return None


def host_us(fn, reps: int = 1000) -> float:
    """Microseconds of host time a call of ``fn`` (enqueue only: the card
    keeps up with the queue), over ``reps`` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def us_text(us) -> str:
    return "not measured" if us is None else f"{us:.3f} us"


def kernels_us(fn, reps: int):
    """Mean device time in microseconds of all CUDA kernels that one call of
    ``fn`` launches, from torch.profiler over ``reps`` calls; None when the
    profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(evt.device_time_total for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA)
    return total / reps if total else None


def conv2d_yardstick(A, x, reps: int = 200, profile_reps: int = 50):
    """The one-call yardstick of K1 and K4, timed here and called nowhere in
    the port: ``torch.nn.functional.conv2d`` (``conv3d`` for a 3-D grid) of
    the constant stencil as a 3x3 (3x3x3) weight with padding=1 (cuDNN's
    TF32 off) on the same ``x``.  Returns (ms a call by CUDA events over
    ``reps`` calls, device us a call from the profiler over
    ``profile_reps`` (None for 0), max |y_conv - y_K1| / max |y_K1|)."""
    import torch

    from krylov_tpu_torch.kernels import stencil

    dims = len(A.grid)
    w = torch.zeros((1, 1) + (3,) * dims, dtype=A.dtype, device=x.device)
    for d, c in zip(A.stencil, A.coef):
        w[(0, 0, *(1 + di for di in d))] = c
    xi = x.reshape(1, 1, *A.grid)
    torch.backends.cudnn.allow_tf32 = False
    op = torch.nn.functional.conv2d if dims == 2 else torch.nn.functional.conv3d

    def conv():
        return op(xi, w, padding=1)

    conv()  # warm-up: cuDNN picks its algorithm
    ms, y = cuda_ms(conv, reps=reps)
    y_k1 = stencil.stencil_matvec_2d(A.coef, x, stencil=A.stencil, grid=A.grid)
    return ms, kernels_us(conv, profile_reps) if profile_reps else None, rel_err(y.reshape(-1), y_k1)


def true_rel(A_csr, b, x) -> float:
    """||b - A x|| / ||b|| in float64 on the host, with the scipy matrix."""
    import numpy as np

    b64, x64 = np.asarray(b, dtype=np.float64), x.double().cpu().numpy()
    return float(np.linalg.norm(b64 - A_csr @ x64) / np.linalg.norm(b64))


def launched(fn):
    """The launch counts of the hand kernel ``fn``: ``tracing.totals.<its name>``."""
    from krylov_tpu_torch import tracing
    return getattr(tracing.totals, fn.__name__)


def reset(fns) -> None:
    for fn in fns:
        vars(launched(fn)).update(dict.fromkeys(vars(launched(fn)), 0))


def pass_counts(fns) -> dict:
    """``{name: {ns: resident launches}}`` of the K2/K3/K5/K6 wrappers, by
    the specialisation of K4 each resident launch took."""
    return {fn.__name__: {ns: getattr(launched(fn), f"resident_ns{ns}") for ns in K4_PASSES} for fn in fns}


def check_passes(label: str, fns, before: dict, want: int) -> dict:
    """Every resident launch of ``fns`` since ``before`` (pass_counts) took
    K4's specialisation ``want``; returns the launches by specialisation."""
    now = pass_counts(fns)
    delta = {name: {ns: now[name][ns] - before[name][ns] for ns in K4_PASSES} for name in now}
    phase(f"{label}: resident launches by K4 specialisation NS {delta}")
    for fn in fns:
        d = delta[fn.__name__]
        if sum(d.values()) < 1 or d[want] != sum(d.values()):
            raise AssertionError(f"{label}: {fn.__name__} launched K4's specialisations {d}, not NS = {want} alone")
    return delta


def digest_line(label: str, x, info) -> str:
    """SHA-256 of the bytes of x and of the residual trace of a solve."""
    import hashlib

    x_hash = hashlib.sha256(x.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    t_hash = hashlib.sha256(info["residual"].tobytes()).hexdigest()
    return f"digest {label}: x sha256 {x_hash}, trace sha256 {t_hash}"


def main_path_digests() -> int:
    """``chip_smoke.py --digests``: the main-path fused solves of phases 5
    and 5b alone (the same systems, b, tol and maxiter) and their digest
    lines, so that a checkout of another commit, whose package this file
    then imports, prints lines to hold against the full run's."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch.sparse import fixtures

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    b_np = np.random.default_rng(0).standard_normal(NX * NX)
    for dt in (torch.float64, torch.float32):
        A = fixtures.laplace2d(NX, dtype=dt, constant=True, device="cuda")
        for m, k in DIGEST_RUNS:
            phase(digest_line(f"{m} {dt}", *krylov_tpu_torch.solve(A, b_np, method=m, k=k, tol=TOL, maxiter=MAXITER)))
    return 0


def route_counts(fns) -> dict:
    """``{name: (resident, streaming)}`` launches of the K2/K3 or K5/K6
    wrappers."""
    return {fn.__name__: (launched(fn).resident, launched(fn).streaming) for fn in fns}


def check_launched(path: str, fns) -> dict:
    """The launch counts of ``fns`` since :func:`reset`; raises when one of
    them never launched."""
    counts = {fn.__name__: launched(fn).launches for fn in fns}
    phase(f"{path} launches: {counts}")
    for name, count in counts.items():
        if count < 1:
            raise AssertionError(f"the {path} never launched {name}")
    return counts


def kskip_streaming(ops, b_np, A_csr, fused, fused_kskip) -> dict:
    """6d. The k-skip path of phase 5b in float64 with K5/K6 forced onto
    their streaming route (``kernels.fused.ROUTE``), counters from this run
    only: every launch streams, the counts stay ``KSKIP_F64`` and the true
    residuals below tol.  Returns the launches of each wrapper."""
    import numpy as np

    import krylov_tpu_torch

    counted = (fused_kskip.fused_kskipcg_solve_2d, fused_kskip.fused_kskipmrr_solve_2d)
    reset(counted)
    fused.ROUTE = "streaming"
    try:
        out = {m: krylov_tpu_torch.solve(ops, b_np, method=m, k=k, tol=TOL, maxiter=MAXITER)
               for m, k in KSKIP_RUNS.items()}
    finally:
        fused.ROUTE = None
    check_launched("k-skip path, streaming route", counted)
    routes = route_counts(counted)
    phase(f"k-skip path K5/K6 launches by route (resident, streaming), streaming forced: {routes}")
    if any(res or stream < 1 for res, stream in routes.values()):
        raise AssertionError(f"the forced streaming k-skip path did not run K5/K6 on the streaming route: {routes}")
    for m, (x, info) in out.items():
        outer = len(info["residual"]) - 1
        true_res = float(np.linalg.norm(b_np - A_csr @ x.cpu().numpy()) / np.linalg.norm(b_np))
        phase(f"solve {m} float64, K5/K6 streaming: iters {info['iterations']}, outer {outer}, converged "
              f"{info['converged']}, true res {true_res:.6e}, solve() wall {info['time'] * 1e3:.3f} ms")
        if (info["iterations"], outer) != KSKIP_F64[m] or not (info["converged"] and true_res < TOL):
            raise AssertionError(f"{m} f64 streaming: {info['iterations']} iterations, {outer} outer, true res "
                                 f"{true_res:.3e}; the JAX package gives {KSKIP_F64[m]}")
    return {name: stream for name, (_, stream) in routes.items()}


def kskip_sweep_words(method: str, k: int, adaptive: bool) -> int:
    """Words a point that one outer iteration of K5 (``"kskipmrr"``) or K6
    (``"kskipcg"``) at ``k`` moves on the streaming route, where every sweep
    goes to device memory (``csrc/fused_kskip.cu``; a stencil's neighbours
    count as cache hits): k stream stages reading 3 vectors and writing 2,
    the last reading 3; k + 1 steps (MrR: r, y, z, x read and y, z, r, x
    written, step 0 also reading A r and, adaptive, writing pre_x; CG: p, x,
    r read and x, r, p written, step 0 also reading A p); one pass forming
    the carried A r (A p)."""
    stream = 5 * k + 3
    if method == "kskipcg":
        return stream + 6 * (k + 1) + 1 + 2
    return stream + 8 * (k + 1) + 1 + int(adaptive) + 2


def laplace3d_rel(b, x, n: int) -> float:
    """||b - A x|| / ||b|| in float64 on the host for the constant 7-point
    ``laplace3d(n)`` (6 on the diagonal, -1 to each of the six neighbours,
    Dirichlet boundaries), with numpy slices instead of a scipy matrix of
    70M entries."""
    import numpy as np

    x3 = x.double().cpu().numpy().reshape(n, n, n)
    y = 6.0 * x3
    for ax in range(3):
        lo, hi = [slice(None)] * 3, [slice(None)] * 3
        lo[ax], hi[ax] = slice(1, None), slice(None, -1)
        y[tuple(lo)] -= x3[tuple(hi)]
        y[tuple(hi)] -= x3[tuple(lo)]
    b64 = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b64 - y.reshape(-1)) / np.linalg.norm(b64))


def row5_phase(dev, fused_kskip, stencil) -> dict:
    """6e. BASELINE row 5 on the card (ROW5): ``solve_device`` and ``solve``
    of ``laplace3d(ROW5_NX, constant=True)`` in float64 and float32, K5
    counters from this run only.  Holds: every K5 launch on the streaming
    route; converged with the host-f64 true residual below tol; in float64
    the count, nosl, khistory and final k of the eager loop (``fused=False``,
    which the CPU tests hold to the JAX package) and ROW5_JAX's.  Times
    ``solve_device`` (CUDA events, median of 3 fresh b after a warm-up) on
    both routes, with the outer iterations and the bytes model of the
    streaming sweeps (:func:`kskip_sweep_words`), and K1 once at this N
    against its plain version.  Then K5/K6's streaming route against its
    plain version on ``laplace3d(ROW5_MID)``.  A failed check is printed
    and the phase raises once all its readings are out.  Returns the main
    path's K5 launches, by route, the mid-size readings of the ``kernels``
    line, ``{(method, k): (err, ms, plain ms, outer, nnz, n)}``, and the
    streaming pass's float64 readings at row 5 (max |err|, ms, plain ms,
    bound, conv3d ms)."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch.sparse import fixtures

    k5 = fused_kskip.fused_kskipmrr_solve_2d
    n3 = ROW5_NX
    n = n3 ** 3
    b_np = np.random.default_rng(0).standard_normal(n)
    failures, launches, launches_ns7 = [], [0, 0], 0
    for dt in (torch.float64, torch.float32):
        name = str(dt).removeprefix("torch.")
        A = fixtures.laplace3d(n3, dtype=dt, constant=True, device=dev)
        coef2, st2, g2, sub = A.collapse_to_2d()
        p = fused_kskip.device_plan("kskipmrr", g2, st2, dt, ROW5["k"])
        reset((k5, stencil.stencil_matvec_2d))
        res = krylov_tpu_torch.solve_device(A, b_np, **ROW5)
        x, info = krylov_tpu_torch.solve(A, b_np, **ROW5)
        routes = (launched(k5).resident, launched(k5).streaming)
        launches = [a + b for a, b in zip(launches, routes)]
        launches_ns7 += launched(k5).streaming_ns7
        if launched(k5).streaming_ns7 != routes[1]:
            failures.append(f"row 5 {name}: {routes[1] - launched(k5).streaming_ns7} streaming launches did not take "
                            f"the pass specialised on 7 terms")
        idx = int(res.index)
        got_dev = (int(res.iterations), idx, res.nosl_trace[:idx + 1].tolist(), res.k_trace[:idx + 1].tolist(),
                   int(res.final_k))
        got = (info["iterations"], len(info["residual"]) - 1, info["nosl"].tolist(), info["khistory"].tolist(),
               info["final_k"])
        rel_dev, rel = laplace3d_rel(b_np, res.x, n3), laplace3d_rel(b_np, x, n3)
        phase(f"row 5 {name} N={n}: plan {p.route}, {p.blocks} blocks of {p.threads}; K5 launches (resident, "
              f"streaming) {routes}, K1 {launched(stencil.stencil_matvec_2d).launches}; solve: iters {got[0]}, "
              f"outer {got[1]}, final k {got[4]}, converged {info['converged']}, recurred res "
              f"{info['residual'][-1]:.6e}, device true res {info['true_residual']:.6e}, host f64 true res {rel:.6e}, "
              f"solve() wall {info['time'] * 1e3:.3f} ms; solve_device: iters {got_dev[0]}, outer {got_dev[1]}, host "
              f"f64 true res {rel_dev:.6e}; khistory {got[3]}")
        if routes[0] or routes[1] < 2:
            failures.append(f"row 5 {name}: K5 launches by route {routes}, not streaming alone")
        if got_dev != got:
            failures.append(f"row 5 {name}: solve_device and solve disagree ({got_dev[:2]} against {got[:2]})")
        if not (info["converged"] and rel < ROW5["tol"] and rel_dev < ROW5["tol"] and x.shape == (n,)):
            failures.append(f"row 5 {name}: not converged to the host f64 true residual ({rel:.3e}, {rel_dev:.3e})")
        xe, ie = krylov_tpu_torch.solve(A, b_np, **ROW5, fused=False)
        eager = (ie["iterations"], len(ie["residual"]) - 1, ie["nosl"].tolist(), ie["khistory"].tolist(),
                 ie["final_k"])
        rel_e = laplace3d_rel(b_np, xe, n3)
        phase(f"row 5 {name} eager loop (fused=False): iters {eager[0]}, outer {eager[1]}, final k {eager[4]}, "
              f"converged {ie['converged']}, host f64 true res {rel_e:.6e}, solve() wall {ie['time'] * 1e3:.3f} ms; "
              f"the same count, nosl, khistory and final k as the fused solve: {eager == got}")
        if dt == torch.float64:
            if eager != got:
                failures.append(f"row 5 float64: fused {got[:2]} final k {got[4]}, eager {eager[:2]} final k "
                                f"{eager[4]} (or nosl/khistory differ)")
            if (got[0], got[1], got[4]) != ROW5_JAX:
                failures.append(f"row 5 float64: {(got[0], got[1], got[4])}, the JAX package {ROW5_JAX}")
        # time to solution on each route, fresh b
        b_dev = {s: torch.from_numpy(np.random.default_rng(s).standard_normal(n)).to(dev, dt) for s in SEEDS}
        for label, kw in (("fused (K5 streaming)", {}), ("eager (K1)", dict(fused=False))):
            krylov_tpu_torch.solve_device(A, b_dev[SEEDS[0]], **ROW5, **kw)  # warm-up
            runs = []
            for s in SEEDS:
                before = launched(k5).launches
                t, r = cuda_ms(lambda: krylov_tpu_torch.solve_device(A, b_dev[s], **ROW5, **kw))
                runs.append((t, int(r.index), int(r.iterations), r.k_trace[:int(r.index) + 1].tolist(),
                             launched(k5).launches - before))
            runs.sort()
            t, outer, iters, kh, k5_calls = runs[1]
            words = sum(kskip_sweep_words("kskipmrr", kk, True) for kk in kh[1:])
            nbytes = words * n * dt.itemsize
            phase(f"row 5 {name} time to solution, {label}: {t:.3f} ms a solve (median of seeds {SEEDS}, CUDA events "
                  f"around solve_device; all {[round(r[0], 3) for r in runs]}), {iters} iterations, {outer} outer, "
                  f"{t / outer * 1e3:.1f} us an outer iteration, K5 launches {k5_calls}; bytes model of the streaming "
                  f"sweeps {nbytes / 1e9:.3f} GB ({words} words a point over the outer iterations), "
                  f"{nbytes / (t * 1e-3) / 1e9:.1f} GB/s, {nbytes / PEAK_BYTES * 1e3 / t:.3f} of {PEAK_BYTES / 1e12} "
                  f"TB/s (bound {nbytes / PEAK_BYTES * 1e3:.3f} ms)")
        # K1 once at this N: the restarts= defect's SpMV
        xk = torch.from_numpy(np.random.default_rng(13).standard_normal(n)).to(dev, dt)
        kw = dict(stencil=st2, grid=g2, sub=sub)
        y = stencil.stencil_matvec_2d(coef2, xk, **kw)
        err = rel_err(y, stencil.stencil_matvec_2d_reference(coef2, xk, **kw))
        t_k = cuda_ms(lambda: stencil.stencil_matvec_2d(coef2, xk, **kw), reps=50)[0]
        us = device_us(lambda: stencil.stencil_matvec_2d(coef2, xk, **kw), "stencil2d_kernel", 20)
        bnd = bound(2 * A.nnz, 2 * n * dt.itemsize, name)
        phase(f"row 5 K1 NS 7 {name} N={n}, nnz {A.nnz}: max rel err {err:.3e} against its plain version; "
              f"{t_k * 1e3:.3f} us a call (CUDA events over 50 calls, {A.nnz / (t_k * 1e-3) / 1e9:.3f} Gnnz/s), "
              f"device {us_text(us)}" + ("" if us is None else f" ({A.nnz / (us * 1e-6) / 1e9:.3f} Gnnz/s)")
              + f"; bound {bnd[0] * 1e3:.3f} us ({bnd[1]})")
        if not err <= (1e-12 if dt == torch.float64 else 1e-5):
            failures.append(f"row 5 K1 {name}: disagrees with its plain version ({err:.3e})")
        # K5's streaming stencil pass alone (fused_kskip.sweep_probe): the pass
        # specialised on 7 terms bitwise the masked one, each against the
        # plain stencil; µs a pass (22 passes less 2, a grid sync after each,
        # median of 3: a call also copies the probe's 11 work vectors)
        y_ref = stencil.stencil_matvec_2d_reference(coef2, xk, **kw)
        ys = {ns: fused_kskip.sweep_probe(coef2, xk, "pass", 1, ns_pass=ns, **kw)[1] for ns in (7, 0)}
        same = torch.equal(ys[7], ys[0])
        us_pass = {}
        for ns in (7, 0):
            few, many = ([cuda_ms(lambda: fused_kskip.sweep_probe(coef2, xk, "pass", 1, ns_pass=ns, reps=r, **kw))[0]
                          for _ in range(3)] for r in (2, 22))
            us_pass[ns] = (statistics.median(many) - statistics.median(few)) / 20 * 1e3
        t_plain = cuda_ms(lambda: stencil.stencil_matvec_2d_reference(coef2, xk, **kw), reps=3)[0]
        pass_err = float((ys[7] - y_ref).abs().max())
        conv_ms = conv2d_yardstick(A, xk, reps=3, profile_reps=0)[0]
        phase(f"row 5 streaming pass (K4's streaming form in K5/K6) {name}: NS 7 bitwise the masked pass {same}, "
              f"max rel err {rel_err(ys[7], y_ref):.3e} against the plain stencil; {us_pass[7]:.3f} us a pass "
              f"(NS 0, the masked pass: {us_pass[0]:.3f} us; probe, 22 passes less 2); plain {t_plain * 1e3:.3f} us; "
              f"conv3d {conv_ms * 1e3:.3f} us a call (CUDA events over 3 calls, cuDNN TF32 off); bound "
              f"{bnd[0] * 1e3:.3f} us ({bnd[1]})")
        if not (same and rel_err(ys[7], y_ref) <= (1e-12 if dt == torch.float64 else 1e-5)):
            failures.append(f"row 5 streaming pass {name}: NS 7 not bitwise the masked pass, or off the plain stencil")
        if dt == torch.float64:
            stream_pass = (pass_err, us_pass[7] * 1e-3, t_plain, bnd, conv_ms)
        del A, coef2, x, xe, res, b_dev, xk, y, y_ref, ys
        torch.cuda.empty_cache()

    # the streaming route against its plain version at N = 1M
    mid = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).removeprefix("torch.")
        A = fixtures.laplace3d(ROW5_MID, dtype=dt, constant=True, device=dev)
        b = torch.from_numpy(np.random.default_rng(SEEDS[0]).standard_normal(A.shape[0])).to(dev, dt)
        runs = ROW5_MID_RUNS if dt == torch.float64 else (("adaptivekskipmrr", 4), ("kskipcg", 4))
        for m, k in runs:
            first = dt == torch.float32
            maxiter = first_outer(m, k, 1) if first else ROW5["maxiter"]
            fn = k5 if m != "kskipcg" else fused_kskip.fused_kskipcg_solve_2d
            tp, want = cuda_ms(lambda: kskip_call(m, k, A, b, ROW5["tol"], maxiter, plain=True, plain64=first))
            before = (launched(fn).resident, launched(fn).streaming)
            t_runs = [cuda_ms(lambda: kskip_call(m, k, A, b, ROW5["tol"], maxiter)) for _ in range(3)]
            tk, got = sorted(t_runs, key=lambda r: r[0])[1][0], t_runs[-1][1]
            routed = (launched(fn).resident - before[0], launched(fn).streaming - before[1])
            label = (f"{'K6' if m == 'kskipcg' else 'K5'} streaming {m} k={k} laplace3d({ROW5_MID}, constant) {name}"
                     + (f", maxiter {maxiter} against float64" if first else ""))
            err = held(failures, compare_kskip, label, got, want, **KSKIP_FULL[m, k, name])
            outer = int(got[6])
            words = kskip_sweep_words(m.removeprefix("adaptive"), k, m == "adaptivekskipmrr")
            model = outer * words * A.shape[0] * dt.itemsize / PEAK_BYTES * 1e3
            phase(f"  {label}: kernel {tk:.3f} ms (median of 3, CUDA events), plain {tp:.3f} ms; {outer} outer; "
                  f"launches (resident, streaming) {routed}; bytes model of the sweeps {model:.3f} ms")
            if routed != (0, 3):
                failures.append(f"{label}: launches by route {routed}, not streaming alone")
            if not first and err is not None:
                mid[m, k] = (err, tk, tp, outer, A.nnz, A.shape[0])
        del A, b
    raise_failures("phase 6e", failures)
    return {"launches": launches, "launches_ns7": launches_ns7, "mid": mid, "pass": stream_pass}


def row5_only() -> int:
    """``chip_smoke.py --row5``: the device line, the build and phase 6e
    alone."""
    import torch

    from krylov_tpu_torch.kernels import _build, fused_kskip, stencil

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    mark("2 build")
    _build.library()
    mark("6e row 5")
    row5_phase(torch.device("cuda"), fused_kskip, stencil)
    mark("done")
    return 0


def phase_alone(flag: str) -> int:
    """``chip_smoke.py --cheb`` or ``--pcg``: the device line, the build and
    phase 11b (the Chebyshev step) or 11c (pcg's step kernels) alone."""
    import torch

    from krylov_tpu_torch.kernels import _build, stencil
    from krylov_tpu_torch.sparse import fixtures

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    mark("2 build")
    _build.library()
    dev = torch.device("cuda")
    ops = {dt: fixtures.laplace2d(NX, dtype=dt, constant=True, device=dev) for dt in (torch.float64, torch.float32)}
    if flag == "--cheb":
        mark("11b Chebyshev step")
        print(json.dumps({"chebyshev step": chebyshev_step_phase(ops, stencil)}), flush=True)
    else:
        mark("11c pcg steps")
        print(json.dumps({"pcg steps": pcg_steps_phase(ops)}), flush=True)
    mark("done")
    return 0


def stream_pass_alone(fused, stencil, m, coef, v, st, grid, sub, ns, name) -> None:
    """The first pass of the streaming K3 (``m="cg"``) or K2 instance's
    form alone (``fused.stream_probe`` on its walk: v = A p, or p = r +
    beta q formed where read with A p stored; MrR's A r stored), specialised
    on ``ns`` terms and masked, on the same weights: bitwise equal, and
    within K1's tolerance of the plain stencil."""
    import torch

    form = fused.stream_shape(m, ns, v.dtype)[0]
    pass_name = fused.FORM_PASSES[m, form][0]
    rows = (2, 3) if pass_name == "form-store" else (3,)  # the work vectors it writes
    probe = {n: fused.stream_probe(coef, v, m, pass_name, ns_pass=n, stencil=st, grid=grid, sub=sub)
             for n in (ns, 0)}
    same = all(torch.equal(probe[ns][r], probe[0][r]) for r in rows)
    src = torch.addcmul(v, torch.full_like(v, 0.5), v) if pass_name == "form-store" else v  # p = r + 0.5 q
    pass_err = rel_err(probe[ns][3], stencil.stencil_matvec_2d_reference(coef, src, stencil=st, grid=grid, sub=sub))
    phase(f"  {m} streaming pass alone ({pass_name} on {fused.stream_shape(m, ns, v.dtype)[1]}) {name}: NS {ns} "
          f"bitwise the masked pass {same}, max rel err {pass_err:.3e} against the plain stencil")
    if not (same and pass_err <= (1e-12 if v.dtype == torch.float64 else 1e-5)):
        raise AssertionError(f"streaming {m} {name} NS {ns}: the pass alone is not bitwise the masked pass, or off "
                             f"the plain stencil ({pass_err:.3e})")


def streaming(dev, fused, stencil) -> dict:
    """6c. K2/K3's streaming route against its plain version on
    laplace2d(NX_STREAM, constant) (N = 2.25M, above the resident route's
    capacity), MAXITER_STREAM iterations with tol 0, b from seed 14, in
    float64 and float32; launch counters from this run only.  Each launch
    takes the pass specialised on 5 terms; x and trace within TOLS and the
    count the plain version's (the tiled walk sums in another order than
    the grid form's masked pass, so the solve is not bitwise that of the
    grid form).  The first pass of the form alone (``stream_pass_alone``)
    is bitwise the masked pass.  Returns, by method, the float64 (launches,
    max |x - x_plain|, kernel ms, plain ms, bound, bytes model's ms)."""
    import numpy as np
    import torch

    from krylov_tpu_torch.sparse import fixtures

    k23 = (fused.fused_cg_solve_2d, fused.fused_mrr_solve_2d)
    out = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).removeprefix("torch.")
        A = fixtures.laplace2d(NX_STREAM, dtype=dt, constant=True, device=dev)
        n = A.shape[0]
        b = torch.from_numpy(np.random.default_rng(14).standard_normal(n)).to(dev, dt)
        b_norm = torch.linalg.vector_norm(b)
        kw = dict(stencil=A.stencil, grid=A.grid, maxiter=MAXITER_STREAM)
        for m, kern, plain in (("mrr", fused.fused_mrr_solve_2d, fused.fused_mrr_solve_2d_reference),
                               ("cg", fused.fused_cg_solve_2d, fused.fused_cg_solve_2d_reference)):
            p = fused.device_plan(m, A.grid, A.stencil, dt)
            if p.route != "streaming":
                raise AssertionError(f"laplace2d({NX_STREAM}) {name} planned {p.route} for {m}, not streaming")
            kern(A.coef, b, 0.0, b_norm, **kw)  # warm-up
            reset(k23)
            tk, got = cuda_ms(lambda: kern(A.coef, b, 0.0, b_norm, **kw))
            routes = route_counts(k23)
            tp, want = cuda_ms(lambda: plain(A.coef, b, 0.0, b_norm, **kw))
            form, walk = fused.stream_shape(m, 5, dt)
            err = compare_solves(f"K{'3' if m == 'cg' else '2'} {m} streaming ({form}, {walk}) laplace2d({NX_STREAM}, "
                                 f"constant) {name}, maxiter {MAXITER_STREAM}, {p.blocks} blocks", got, want,
                                 **TOLS[name])
            launches = routes[kern.__name__][1]
            if launches != 1 or routes[kern.__name__][0] or launched(kern).streaming_ns5 != 1:
                raise AssertionError(f"the streaming phase did not launch {m} on the streaming route with the pass "
                                     f"specialised on 5 terms: {routes}, NS 5 {launched(kern).streaming_ns5}")
            stream_pass_alone(fused, stencil, m, A.coef, b, A.stencil, A.grid, None, 5, name)
            iters = int(got[2])
            words = fused.stream_words(m, form)
            sweep_ms = words * n * dt.itemsize * iters / PEAK_BYTES * 1e3
            bnd = bound(fused_flops(m, A.nnz, n, iters), 2 * n * dt.itemsize, name)
            if dt == torch.float64:
                out[m] = (launches, err, tk, tp, bnd, sweep_ms)
            phase(f"streaming {m} {name} N={n}: kernel {tk:.3f} ms, plain {tp:.3f} ms for {iters} iterations (CUDA "
                  f"events), {tk / iters * 1e3:.2f} us an iteration; bound {bnd[0]:.3f} ms ({bnd[1]}); bytes model "
                  f"of the form ({form} on {walk}, {words} words a point an iteration) {sweep_ms:.3f} ms, "
                  f"{sweep_ms / tk:.3f} of 3.35 TB/s")
        del A, b
        torch.cuda.empty_cache()
    return out


def row5_k23_phase(dev, fused, stencil) -> dict:
    """6f. BASELINE row 5's system with cg and mrr (ROW5_K23): ``solve_device``
    and ``solve`` of ``laplace3d(ROW5_NX, constant=True)`` in float64 and
    float32 (``restarts=1``), K2/K3 counters from this run only.  Holds:
    every K2/K3 launch streaming with the pass specialised on 7 terms; the
    host-f64 true residual below tol in both dtypes; in float64 the count
    of the eager loop (``fused=False``, K1) on the card and ROW5_K23_JAX's.
    First, in each dtype, each kernel on the collapsed system (its form on
    its tiled walk) against its plain version on the same b, MAXITER_STREAM
    iterations with tol 0: equal counts, x and trace within TOLS; and the
    first pass of its form alone bitwise the masked pass
    (``stream_pass_alone``).  These comparison launches are not counted.
    Prints the time to solution of ``solve_device`` (CUDA events, median of
    seeds 1-3 after a warm-up) fused and eager, beside the bytes model of
    the fused solve's iterations (``fused.stream_words``).  A failed check
    is printed and the phase raises once all its readings are out.
    Returns the streaming launches by method and their NS 7 launches."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch.sparse import fixtures

    k23 = {"cg": fused.fused_cg_solve_2d, "mrr": fused.fused_mrr_solve_2d}
    n3 = ROW5_NX
    n = n3 ** 3
    b_np = np.random.default_rng(0).standard_normal(n)
    failures, launches = [], {"cg": 0, "mrr": 0}
    for dt in (torch.float64, torch.float32):
        name = str(dt).removeprefix("torch.")
        A = fixtures.laplace3d(n3, dtype=dt, constant=True, device=dev)
        coef2, st2, g2, sub = A.collapse_to_2d()
        b0 = torch.from_numpy(b_np).to(dev, dt)
        b0_norm = torch.linalg.vector_norm(b0)
        for m, fn in k23.items():
            plain = getattr(fused, f"fused_{m}_solve_2d_reference")
            kw2 = dict(stencil=st2, grid=g2, maxiter=MAXITER_STREAM, sub=sub)
            got = fn(coef2, b0, 0.0, b0_norm, **kw2)
            want = plain(coef2, b0, 0.0, b0_norm, **kw2)
            shape = "{} on {}".format(*fused.stream_shape(m, 7, dt))
            try:
                compare_solves(f"K{'3' if m == 'cg' else '2'} {m} streaming ({shape}) row 5 {name} against its plain "
                               f"version, maxiter {MAXITER_STREAM}", got, want, **TOLS[name])
                stream_pass_alone(fused, stencil, m, coef2, b0, st2, g2, sub, 7, f"row 5 {name}")
            except AssertionError as e:
                failures.append(str(e))
            del got, want
        del b0
        torch.cuda.empty_cache()
        b_dev = {s: torch.from_numpy(np.random.default_rng(s).standard_normal(n)).to(dev, dt) for s in SEEDS}
        for m, fn in k23.items():
            kw = dict(method=m, **ROW5_K23, **({} if dt == torch.float64 else {"restarts": 1}))
            label = f"row 5 {m} {name}"
            reset((*k23.values(), stencil.stencil_matvec_2d))
            res = krylov_tpu_torch.solve_device(A, b_np, **kw)
            x, info = krylov_tpu_torch.solve(A, b_np, **kw)
            routes = (launched(fn).resident, launched(fn).streaming, launched(fn).streaming_ns7)
            launches[m] += routes[1]
            rel_dev, rel = laplace3d_rel(b_np, res.x, n3), laplace3d_rel(b_np, x, n3)
            xe, ie = krylov_tpu_torch.solve(A, b_np, **kw, fused=False)
            rel_e = laplace3d_rel(b_np, xe, n3)
            phase(f"{label} N={n}: launches (resident, streaming, streaming NS 7) {routes}, K1 "
                  f"{launched(stencil.stencil_matvec_2d).launches}; solve: iters {info['iterations']}, converged "
                  f"{info['converged']}, recurred res {info['residual'][-1]:.6e}, host f64 true res {rel:.6e}; "
                  f"solve_device: iters {int(res.iterations)}, host f64 true res {rel_dev:.6e}; eager loop "
                  f"(fused=False): iters {ie['iterations']}, converged {ie['converged']}, host f64 true res "
                  f"{rel_e:.6e}")
            if routes[0] or routes[1] < 2 or routes[2] != routes[1]:
                failures.append(f"{label}: launches (resident, streaming, streaming NS 7) {routes}, not streaming "
                                f"with the pass specialised on 7 terms alone")
            if int(res.iterations) != info["iterations"]:
                failures.append(f"{label}: solve_device and solve disagree ({int(res.iterations)}, "
                                f"{info['iterations']})")
            if not (info["converged"] and rel < ROW5_K23["tol"] and rel_dev < ROW5_K23["tol"] and x.shape == (n,)):
                failures.append(f"{label}: not converged to the host f64 true residual ({rel:.3e}, {rel_dev:.3e})")
            if dt == torch.float64 and not (info["iterations"] == ie["iterations"] == ROW5_K23_JAX[m]):
                failures.append(f"{label}: fused {info['iterations']}, eager {ie['iterations']}, the JAX package "
                                f"{ROW5_K23_JAX[m]}")
            # time to solution, fresh b, fused against eager
            for way, extra in (("fused (streaming)", {}), ("eager (K1)", dict(fused=False))):
                krylov_tpu_torch.solve_device(A, b_dev[SEEDS[0]], **kw, **extra)  # warm-up
                runs = sorted((cuda_ms(lambda: krylov_tpu_torch.solve_device(A, b_dev[s], **kw, **extra))
                               for s in SEEDS), key=lambda v: v[0])
                t, r = runs[1]
                iters = int(r.iterations)
                form, walk = fused.stream_shape(m, 7, dt)
                model = fused.stream_words(m, form) * n * dt.itemsize * iters / PEAK_BYTES * 1e3
                phase(f"{label} time to solution, {way}: {t:.3f} ms a solve (median of seeds {SEEDS}, CUDA events "
                      f"around solve_device; all {[round(v[0], 3) for v in runs]}), {iters} iterations, "
                      f"{t / iters * 1e3:.1f} us an iteration; bytes model of the streaming form "
                      f"({form} on {walk}, {fused.stream_words(m, form)} words a point) {model:.3f} ms for these "
                      f"iterations, {model / t:.3f} of 3.35 TB/s")
            del res, x, xe
        del A, b_dev
        torch.cuda.empty_cache()
    raise_failures("phase 6f", failures)
    return launches


def k23_only() -> int:
    """``chip_smoke.py --k23``: the device line, the build and phases 6c
    and 6f alone."""
    import torch

    from krylov_tpu_torch.kernels import _build, fused, stencil

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    mark("2 build")
    _build.library()
    mark("6c K2/K3 streaming")
    streaming(torch.device("cuda"), fused, stencil)
    mark("6f row 5 cg/mrr")
    row5_k23_phase(torch.device("cuda"), fused, stencil)
    mark("done")
    return 0


def fidelity(ops, b_np, A_csr, fused, stencil) -> None:
    """7. restarts= and refine= on the main-path system through solve(),
    counters from this run only: the corrections launch K2, the defects
    b - A x K1.  float32 restarts=2 is printed (one ulp of x at max |x| ~ 76
    puts the float32 defect near tol); float32 refine=3 must end below tol
    by the host float64 residual; float64 restarts=1 is the skip case."""
    import torch

    import krylov_tpu_torch

    f64, f32 = torch.float64, torch.float32
    counted = (stencil.stencil_matvec_2d, fused.fused_mrr_solve_2d)
    reset(counted)
    runs = {
        "restarts=2 float32": (ops[f32], dict(restarts=2)),
        "refine=3 float32": (ops[f32], dict(refine=3)),
        "restarts=1 float64": (ops[f64], dict(restarts=1)),
    }
    out = {label: krylov_tpu_torch.solve(A, b_np, method="mrr", tol=TOL, maxiter=MAXITER, **kw)
           for label, (A, kw) in runs.items()}
    check_launched("fidelity path", counted)
    for label, (x, info) in out.items():
        host = true_rel(A_csr, b_np, x)
        phase(f"fidelity mrr {label}: iters {info['iterations']}, converged {info['converged']}, "
              f"true_residual (info) {info['true_residual']:.6e}, host f64 true res {host:.6e}, "
              f"x {x.dtype}, refinements {info.get('refinements', '-')}, solve() time {info['time'] * 1e3:.3f} ms")
        if x.shape != (NX * NX,) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"fidelity {label}: x not finite or of the wrong shape")
    x, info = out["refine=3 float32"]
    if not (x.dtype == f64 and info["converged"] and info["true_residual"] < TOL
            and true_rel(A_csr, b_np, x) < TOL):
        raise AssertionError("fidelity: float32 refine=3 did not end below tol")
    x, info = out["restarts=1 float64"]
    # the float64 base solve already meets tol, so the correction is skipped
    if info["iterations"] != 934 or not (info["converged"] and info["true_residual"] < TOL
                                         and true_rel(A_csr, b_np, x) < TOL):
        raise AssertionError("fidelity: float64 restarts=1 is not the 934-iteration skip case")


def irregular_system(dev):
    """The phase-9 system: powerlaw_spd(2**20) (scipy CSR, float64) and its
    container on the card through as_operator, which must pick HYB."""
    import torch

    from krylov_tpu_torch.sparse import HybMatrix, as_operator, fixtures

    t0 = time.perf_counter()
    P = fixtures.powerlaw_spd(2**20)
    t1 = time.perf_counter()
    H = as_operator(P, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    phase(f"irregular system powerlaw_spd(2**20): nnz {P.nnz}, host build {t1 - t0:.2f} s; as_operator -> "
          f"{type(H).__name__} in {t2 - t1:.2f} s (ELL width {H.width if isinstance(H, HybMatrix) else '-'})")
    if not isinstance(H, HybMatrix):
        raise AssertionError(f"as_operator chose {type(H).__name__} for the power-law system, not HybMatrix")
    phase(f"  HYB: ELL width {H.width}, tail chunks {H.tail_rows.shape[0]} x {H.tail_width}, "
          f"stored entries {H.stored_entries} ({H.stored_entries / P.nnz:.3f} per nonzero)")
    return P, H


def batched(ops, hyb, dev, fused) -> None:
    """8. solve_batched of NRHS right-hand sides, counters from this run
    only.  Fused route (MrR on the main-path stencil, float64 and float32):
    one K2 launch per member, back to back with no host sync in between:
    under torch.cuda.set_sync_debug_mode("warn") the batch makes one
    synchronizing call, the front door's read of which members are zero,
    before its first launch; each member equals
    a solo fused solve of the same b: the same kernel on the same values.
    Eager route (CG on the phase-9 HYB, float64): one batched loop; each
    member against a solo eager solve, whose dot products reduce in another
    kernel: equal counts, x within X_REL_EAGER of max |x|."""
    import numpy as np
    import torch

    import krylov_tpu_torch

    f64, f32 = torch.float64, torch.float32
    reset((fused.fused_mrr_solve_2d,))
    for dt in (f64, f32):
        B = torch.from_numpy(np.random.default_rng(21).standard_normal((NRHS, NX * NX))).to(dev, dt)
        tol = torch.tensor(TOL, dtype=dt, device=dev)

        def run():
            torch.cuda.set_sync_debug_mode("warn")  # each host sync warns
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    res = krylov_tpu_torch.solve_batched(ops[dt], B, method="mrr", tol=tol, maxiter=MAXITER)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
            if len(syncs) != 1:
                raise AssertionError(f"batched mrr {dt}: {len(syncs)} host syncs, not the front door's one: {syncs}")
            return res

        run()  # warm-up
        t_batch, res = cuda_ms(run)
        t_solo, solos = cuda_ms(lambda: [krylov_tpu_torch.solve_device(ops[dt], b, method="mrr", tol=TOL,
                                                                       maxiter=MAXITER) for b in B])
        x_diff = max(float((res.x[j] - s.x).abs().max()) for j, s in enumerate(solos))
        iters = res.iterations.tolist()
        phase(f"batched mrr {dt} fused, {NRHS} RHS: iterations {iters}, converged {res.converged.tolist()}; "
              f"{t_batch / NRHS:.3f} ms per solve (solve_batched, CUDA events), solo solve_device "
              f"{t_solo / NRHS:.3f} ms per solve; max |x - x_solo| {x_diff:.3e}")
        for j, s in enumerate(solos):
            if int(res.iterations[j]) != int(s.iterations) or bool(res.converged[j]) != bool(s.converged):
                raise AssertionError(f"batched mrr {dt} member {j}: counts differ from the solo solve")
            torch.testing.assert_close(res.x[j], s.x, rtol=1e-12, atol=0)
            m = int(s.index) + 1
            torch.testing.assert_close(res.residual_trace[j, :m], s.residual_trace[:m], rtol=1e-12, atol=0)
        if dt == f64 and not bool(res.converged.all()):
            raise AssertionError("batched mrr float64: a member did not converge")
    check_launched("batched fused path", (fused.fused_mrr_solve_2d,))

    P, H = hyb
    B = torch.from_numpy(np.random.default_rng(22).standard_normal((NRHS, H.shape[0]))).to(dev)
    krylov_tpu_torch.solve_batched(H, B[:2], method="cg", tol=TOL, maxiter=MAXITER)  # warm-up
    t_batch, res = cuda_ms(lambda: krylov_tpu_torch.solve_batched(H, B, method="cg", tol=TOL, maxiter=MAXITER))
    t_solo, solos = cuda_ms(lambda: [krylov_tpu_torch.solve_device(H, b, method="cg", tol=TOL, maxiter=MAXITER)
                                     for b in B])
    x_rel = max(rel_err(res.x[j], s.x) for j, s in enumerate(solos))
    true_res = max(true_rel(P, B[j].cpu().numpy(), res.x[j]) for j in range(NRHS))
    phase(f"batched cg float64 eager, HYB powerlaw_spd(2**20), {NRHS} RHS: iterations {res.iterations.tolist()}, "
          f"converged {res.converged.tolist()}; {t_batch / NRHS:.3f} ms per solve (solve_batched, CUDA events), "
          f"solo {t_solo / NRHS:.3f} ms per solve; max |x - x_solo| / max |x_solo| {x_rel:.3e} "
          f"(tol {X_REL_EAGER:g}); max host f64 true res {true_res:.6e}")
    for j, s in enumerate(solos):
        if int(res.iterations[j]) != int(s.iterations) or not bool(res.converged[j]):
            raise AssertionError(f"batched hyb cg member {j}: counts differ from the solo solve or not converged")
    if not (x_rel <= X_REL_EAGER and true_res < TOL):
        raise AssertionError("batched hyb cg: x differs from the solo solves, or the true residual is above tol")


def irregular(hyb, dev) -> None:
    """9. The HYB operator: its matvec against scipy float64 A @ x (and two
    runs bitwise equal: the tail's scatter-add sorts its rows), timed, with
    the ELL gather of an 8-RHS block timed in both batch layouts; CG
    in float64 on the eager loop at the numpy float64 CG count on the same
    CSR; then Matrix Market IO on a small system, reporting which native
    path ran."""
    import os
    import tempfile

    import numpy as np
    import scipy.io
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch import native
    from krylov_tpu_torch.sparse import fixtures, io

    P, H = hyb
    x_np = np.random.default_rng(23).standard_normal(H.shape[0])
    x = torch.from_numpy(x_np).to(dev)
    y = H.matvec(x)
    err = float(np.abs(y.cpu().numpy() - P @ x_np).max() / np.abs(P @ x_np).max())
    t, y2 = cuda_ms(lambda: H.matvec(x), reps=50)
    X = torch.from_numpy(np.random.default_rng(24).standard_normal((NRHS, H.shape[0]))).to(dev)
    tb, Y = cuda_ms(lambda: H.matvec(X), reps=10)
    b_err = max(rel_err(Y[j], H.matvec(X[j])) for j in range(NRHS))
    phase(f"HYB matvec float64 N={H.shape[0]}: max |y - y_scipy| / max |y_scipy| {err:.3e} (tol 1e-12), "
          f"repeat bitwise equal {torch.equal(y, y2)}; {t * 1e3:.3f} us ({P.nnz / (t * 1e-3) / 1e9:.3f} Gnnz/s, "
          f"CUDA events over 50 calls); {NRHS}-RHS block {tb * 1e3:.3f} us ({NRHS * P.nnz / (tb * 1e-3) / 1e9:.3f} "
          f"Gnnz/s), batched vs solo max rel {b_err:.3e} (tol 1e-12)")
    if not (err <= 1e-12 and b_err <= 1e-12 and torch.equal(y, y2)):
        raise AssertionError("HYB matvec disagrees with scipy, with the solo matvec, or between two runs")
    # the layout choice of sparse/formats.py: the block's ELL gather with the
    # batch leading, against the JAX package's row gather of an (n, batch)
    # block
    idx, Xt = H.ell_indices.reshape(-1), X.T.contiguous()
    t_lead, _ = cuda_ms(lambda: X.index_select(-1, idx), reps=10)
    t_rows, _ = cuda_ms(lambda: Xt.index_select(0, idx), reps=10)
    phase(f"  ELL gather of the {NRHS}-RHS block (CUDA events over 10 calls): batch leading {t_lead * 1e3:.3f} us, "
          f"rows of the (n, {NRHS}) block {t_rows * 1e3:.3f} us")

    b_np = np.random.default_rng(25).standard_normal(H.shape[0])
    ref_iters, _ = numpy_cg(P, b_np, TOL, MAXITER)
    x_cg, info = krylov_tpu_torch.solve(H, b_np, method="cg", tol=TOL, maxiter=MAXITER)
    res = true_rel(P, b_np, x_cg)
    phase(f"HYB cg float64 eager: iters {info['iterations']} (numpy f64 CG {ref_iters}), converged "
          f"{info['converged']}, recurred res {info['residual'][-1]:.6e}, host f64 true res {res:.6e}, "
          f"solve() time {info['time'] * 1e3:.3f} ms")
    if info["iterations"] != ref_iters or not (info["converged"] and res < TOL):
        raise AssertionError("HYB cg float64: count differs from numpy or the true residual is above tol")

    small = fixtures.powerlaw_spd(3000, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "powerlaw.mtx")
        scipy.io.mmwrite(path, small)
        A = io.load_mtx(path, device=dev)
    xs = np.random.default_rng(26).standard_normal(3000)
    e = float(np.abs(A.matvec(torch.from_numpy(xs).to(dev)).cpu().numpy() - small @ xs).max())
    lib = "native library" if native.available() else f"numpy/scipy fallback ({native.load_error or 'no library'})"
    phase(f"io.load_mtx powerlaw_spd(3000) -> {type(A).__name__} on {A.device} through the {lib}; "
          f"max |A x - scipy| {e:.3e}")
    if not e <= 1e-12:
        raise AssertionError("io.load_mtx: the loaded operator disagrees with scipy")


def row4b(dev) -> None:
    """10. The ill-conditioned power-law companion (row 4b of RESULTS.md),
    printed, not held: float32 vectors, tol 1e-4, MAXITER, CG, the
    monomial k-skip family with float64 scalars, and the other runs of the
    row: CG preconditioned by Jacobi, CA-CG (s = 8, maxiter 1500) and
    CA-MrR (s = 8, maxiter 4800) with float64 scalars, each with its
    converged flag, count, host float64 true residual and time."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch import precond
    from krylov_tpu_torch.sparse import as_operator, fixtures

    tol = 1e-4
    t0 = time.perf_counter()
    P = fixtures.powerlaw_spd(2**20, shift=1e-3, diag_scale_decades=1.5)
    A = as_operator(P, dtype=torch.float32, device=dev)
    phase(f"row 4b powerlaw_spd(2**20, shift=1e-3, diag_scale_decades=1.5): {type(A).__name__} float32, "
          f"nnz {P.nnz}, set-up {time.perf_counter() - t0:.2f} s")
    b_np = np.random.default_rng(27).standard_normal(P.shape[0]).astype(np.float32)
    t0 = time.perf_counter()
    P64 = torch.sparse_csr_tensor(torch.from_numpy(P.indptr).long(), torch.from_numpy(P.indices).long(),
                                  torch.from_numpy(P.data), P.shape, dtype=torch.float64, device=dev)
    ref_iters, ref_hist = torch_cg(P64, torch.from_numpy(b_np).to(dev, torch.float64), tol, MAXITER)
    phase(f"  float64 CG on the same CSR (torch sparse SpMV): {ref_iters} iterations, residual {ref_hist[-1]:.6e}, "
          f"{time.perf_counter() - t0:.2f} s")
    f64 = dict(scalar_dtype=torch.float64)
    runs = [
        ("cg", 0, {}),
        ("kskipmrr", 4, f64),
        ("adaptivekskipmrr", 8, f64),
        ("adaptivekskipmrr", 8, dict(f64, basis_norm=True)),
        # the other runs of the row (benchmarks/baseline_configs.py:619-637)
        ("pcg", 0, dict(M=precond.jacobi(A))),
        ("cacg", 8, dict(f64, maxiter=1500)),
        ("camrr", 8, dict(f64, maxiter=4800)),
    ]
    for m, k, kw in runs:
        x, info = krylov_tpu_torch.solve(A, b_np, method=m, k=k, tol=tol, **{"maxiter": MAXITER, **kw})
        res = true_rel(P, b_np, x)
        extra = "" if "final_k" not in info else f", final k {info['final_k']}"
        phase(f"  row 4b {m} k={k}{' basis_norm' if kw.get('basis_norm') else ''}"
              f"{' f64 scalars' if 'scalar_dtype' in kw else ''}{' M=jacobi' if 'M' in kw else ''}"
              f"{' maxiter ' + str(kw['maxiter']) if 'maxiter' in kw else ''}: converged {info['converged']}, "
              f"iters {info['iterations']}, recurred res {info['residual'][-1]:.6e}, host f64 true res "
              f"{res:.6e}{extra}, solve() time {info['time']:.3f} s")


class PlainChainOperator:
    """A diagnostic for this script only, used nowhere in the port: the
    main-path stencil with K1's plain version (the chain of shifted windows,
    some 16 torch launches a product) as its matvec, so an eager loop can
    be timed over it beside the same loop over K1."""

    def __init__(self, A):
        self.A = A

    def matvec(self, x):
        from krylov_tpu_torch.kernels import stencil

        return stencil.stencil_matvec_2d_reference(self.A.coef, x, stencil=self.A.stencil, grid=self.A.grid)


def preconditioned(ops, b_np, A_csr, stencil) -> tuple:
    """11. The preconditioned, pipelined and CA solves of PRECOND_RUNS on
    the main-path system through solve(), on the eager loops, in float64
    (held: the JAX package's counts, PRECOND_F64, and the host float64 true
    residual below tol) and float32 (printed).  K1's counter is set to 0
    before each solve and read after it: every solve must launch K1 at
    least once an iteration.  The counters of pcg's four step kernels are
    set to 0 before the first solve and read around each: a pcg solve must
    launch each at least once an iteration, the other methods none.  Then eager preconditioned CG (M = None,
    float64) is timed through K1 against the same loop over K1's plain
    version (PlainChainOperator), in turns.  Returns the K1 launches of the
    phase's solves and its float64 ``(x, info)`` by ``(method, k)``, which
    phase 12 holds its chunked solves against."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch import precond, tracing
    from krylov_tpu_torch.context import Context
    from krylov_tpu_torch.solvers import pcg_kernel

    f64 = torch.float64
    total, failures, solves = 0, [], {}
    pcg_launched = tracing.totals.pcg_launches
    vars(pcg_launched).update(dict.fromkeys(vars(pcg_launched), 0))
    for dt in (f64, torch.float32):
        A = ops[dt]
        t0 = time.perf_counter()
        Ms = {"none": None, "jacobi": precond.jacobi(A), "chebyshev6": precond.chebyshev(A, degree=6)}
        phase(f"preconditioners {dt}: jacobi, chebyshev(degree 6) on [{Ms['chebyshev6'].lmin:.9g}, "
              f"{Ms['chebyshev6'].lmax:.9g}], set-up {time.perf_counter() - t0:.2f} s")
        for run in PRECOND_RUNS:
            m, p, k = run
            launched(stencil.stencil_matvec_2d).launches = 0
            steps_before = dict(vars(pcg_launched))
            x, info = krylov_tpu_torch.solve(A, b_np, method=m, M=Ms[p], k=k, tol=TOL, maxiter=MAXITER)
            launches = launched(stencil.stencil_matvec_2d).launches
            steps = {step: n - steps_before[step] for step, n in vars(pcg_launched).items()}
            total += launches
            if dt == f64 and p == "none":
                solves[m, k] = (x, info)
            outer = len(info["residual"]) - 1
            true_res = true_rel(A_csr, b_np, x)
            phase(f"solve {m} M={p}{f' k={k}' if k else ''} {dt}: iters {info['iterations']}, outer {outer}, "
                  f"converged {info['converged']}, recurred res {info['residual'][-1]:.6e}, host f64 true res "
                  f"{true_res:.6e}, K1 launches {launches}, pcg step kernel launches {steps}, solve() wall {info['time'] * 1e3:.3f} ms "
                  f"({info['time'] * 1e3 / max(info['iterations'], 1):.4f} ms an iteration)")
            if launches < info["iterations"]:
                failures.append(f"{m} M={p} k={k} {dt}: {launches} K1 launches for {info['iterations']} iterations")
            if (min(steps.values()) < info["iterations"]) if m == "pcg" else any(steps.values()):
                failures.append(f"{m} M={p} k={k} {dt}: pcg step kernel launches {steps} for {info['iterations']} "
                                "iterations (pcg launches each once a body, the other methods none)")
            if dt == f64 and not ((info["iterations"], outer) == PRECOND_F64[run] and info["converged"]
                                  and true_res < TOL):
                failures.append(f"{m} M={p} k={k} f64: {info['iterations']} iterations, {outer} outer, true res "
                                f"{true_res:.3e}; the JAX package gives {PRECOND_F64[run]}")
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 11", failures)

    A = ops[f64]
    b = torch.from_numpy(b_np).to(A.device)
    times = {"K1": [], "plain": []}
    for label in ("K1", "plain", "plain", "K1"):
        op = A if label == "K1" else PlainChainOperator(A)
        ms, res = cuda_ms(lambda: pcg_kernel(op, b, torch.zeros_like(b), tol=TOL, maxiter=MAXITER, ctx=Context()))
        times[label].append((ms, int(res.iterations)))
    phase("eager pcg (M = None) float64 N={}: ".format(NX * NX) + "; ".join(
        f"{label} " + ", ".join(f"{ms / it:.4f} ms an iteration ({it} iterations, {ms:.3f} ms)" for ms, it in v)
        for label, v in times.items()) + " (CUDA events; runs in the order K1, plain, plain, K1)")
    if len({it for v in times.values() for _, it in v}) != 1:
        raise AssertionError(f"eager pcg through K1 and through its plain version took other counts: {times}")
    return total, solves


def cheb_step_bytes(steps: int, n: int, itemsize: int) -> int:
    """Bytes a Chebyshev step application of ``steps`` rounds moves for a
    member of ``n`` points: a round reads ``d``, ``r`` and ``z`` and writes
    the three anew (``d``'s neighbours from cache), the first reads ``v``
    alone and the last writes ``z`` alone; without steps one pass reads
    ``v`` and writes ``z``."""
    if steps == 0:
        return 2 * n * itemsize
    vectors = sum((1 if k == 0 else 3) + (1 if k == steps - 1 else 3) for k in range(steps))
    return vectors * n * itemsize


def chebyshev_step_phase(ops, stencil) -> tuple:
    """11b. The Chebyshev step against the loop it replaces, on the
    main-path system: ``chebyshev(A, 6)`` applied to a vector and a
    (CHEB_BATCH, n) block of seed 17 (with negative zeros) in float64 and
    float32, by ``chebyshev_apply`` and by ``precond.chebyshev_loop`` (K1
    and torch's pointwise kernels, what every application off the step
    runs), held bit for bit, signs of zeros included, with ``degree - 1``
    launches an application and ``v`` left as it was.  Each route is then
    timed: device time an application (torch.profiler, every kernel of a
    call, over CHEB_REPS calls) and the time between CUDA events over as
    many, in the order step, loop, loop, step, beside the bytes bound of
    :func:`cheb_step_bytes`.  Returns ``(max abs err, ms, plain ms,
    bound)`` of the float64 vector, for the kernels line, and how it was
    timed."""
    import numpy as np
    import torch

    from krylov_tpu_torch import precond
    from krylov_tpu_torch.context import Context

    n, failures, result = NX * NX, [], None
    for dt in (torch.float64, torch.float32):
        A = ops[dt]
        M = precond.chebyshev(A, degree=6)
        theta, steps = precond.chebyshev_schedule(M.lmin, M.lmax, M.degree)
        bits = torch.int64 if dt == torch.float64 else torch.int32
        for batch in (None, CHEB_BATCH):
            v = torch.from_numpy(np.random.default_rng(17).standard_normal((batch or 1, n))).to(A.device, dt)
            v[:, :4] = -0.0
            if batch is None:
                v = v[0].clone()
            kept = v.clone()
            before = launched(stencil.chebyshev_apply).launches
            got = stencil.chebyshev_apply(A, v, theta, steps)
            launches = launched(stencil.chebyshev_apply).launches - before
            want = precond.chebyshev_loop(A, v, theta, steps, Context())
            same = torch.equal(got.view(bits), want.view(bits)) and torch.equal(v.view(bits), kept.view(bits))
            err = float((got - want).abs().max())

            def step():
                return stencil.chebyshev_apply(A, v, theta, steps)

            def loop():
                return precond.chebyshev_loop(A, v, theta, steps, Context())

            device = {"step": kernels_us(step, CHEB_REPS), "loop": kernels_us(loop, CHEB_REPS)}
            events = {"step": [], "loop": []}
            for label in ("step", "loop", "loop", "step"):
                events[label].append(cuda_ms(step if label == "step" else loop, reps=CHEB_REPS)[0])
            events = {label: statistics.mean(v_) for label, v_ in events.items()}
            nbytes = cheb_step_bytes(len(steps), n, dt.itemsize) * (batch or 1)
            bnd = (nbytes / PEAK_BYTES * 1e3, "bytes")
            shape = f"laplace2d({NX}, constant) {dt}, degree {M.degree}, " + (f"({batch}, n)" if batch else "(n,)")
            phase(f"Chebyshev step {shape}: {launches} launches an application, bitwise the loop {same}, max abs "
                  f"err {err:.3e}; device {us_text(device['step'])} an application against the loop's "
                  f"{us_text(device['loop'])} (torch.profiler, every kernel, {CHEB_REPS} calls); CUDA events "
                  f"{events['step'] * 1e3:.3f} us against {events['loop'] * 1e3:.3f} us a call (step, loop, loop, "
                  f"step); bound {bnd[0] * 1e3:.3f} us ({nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12:.2f} TB/s)")
            if not same or launches != len(steps):
                failures.append(f"Chebyshev step {shape}: bitwise {same}, {launches} launches for {len(steps)} steps")
            if dt == torch.float64 and batch is None:
                timed = device["step"] is not None and device["loop"] is not None
                ms_ = (device["step"] / 1e3, device["loop"] / 1e3) if timed else (events["step"], events["loop"])
                result = (err, ms_[0], ms_[1], bnd, "torch.profiler device time of every kernel of an application, "
                          f"mean of {CHEB_REPS}" if timed else f"CUDA events, mean of {CHEB_REPS} applications")
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 11b", failures)
    return result


def pcg_steps_phase(ops) -> dict:
    """11c. The four kernels of pcg's eager body (``kernels.pcg``: the
    steps given a scratch) against their plain versions (the same steps on
    torch's passes, given none) on the same inputs: the main-path vector
    and a (CHEB_BATCH, n) block of seed 18 whose member 1 has converged, in
    float64 and float32.  Held: x, r, p, the trace, ``conv`` and ``i`` bit
    for bit; the inner products (``alpha``, ``rr``, ``ru``, ``beta``) of the
    members that have not converged within PCG_STEP_REL of the sum of their
    terms' magnitudes; the converged member's ``rr`` and ``ru`` kept bit for
    bit and its ``beta`` 0; the tickets back at 0; one launch a call in
    ``tracing.totals.pcg_launches``.  Each step is then timed against its
    plain version: device time a call (torch.profiler, every kernel of a
    call, over PCG_STEP_REPS calls) and the time between CUDA events over
    as many, in the order kernel, plain, plain, kernel, beside the bytes
    bound of PCG_STEP_VECTORS.  Returns ``{step: (max abs err, ms, plain ms,
    bound, how it was timed)}`` of the float64 vector, for the kernels
    line."""
    import numpy as np
    import torch

    from krylov_tpu_torch import tracing
    from krylov_tpu_torch.context import Context
    from krylov_tpu_torch.kernels import pcg

    n, ctx, failures, result = NX * NX, Context(), [], {}
    counted = tracing.totals.pcg_launches
    for dt in (torch.float64, torch.float32):
        dev, rel = ops[dt].device, PCG_STEP_REL[str(dt)]
        bits = torch.int64 if dt == torch.float64 else torch.int32
        for batch in (None, CHEB_BATCH):
            rows, rng = batch or 1, np.random.default_rng(18)

            def member(t):
                return t if batch else t[0]

            def scalars(*values):
                return member(torch.tensor(values[:rows], dtype=dt, device=dev))

            x, p, r, s, u = (member(torch.from_numpy(rng.standard_normal((rows, n))).to(dev, dt)) for _ in range(5))
            conv = member(torch.tensor([False, True, False][:rows], device=dev))
            alpha, beta = scalars(0.37, -1.25, 0.61), scalars(-0.73, 0.5, 2.3)
            rr, ru, b_norm = scalars(3.5, 0.25, 7.0), scalars(1.5, -2.0, 0.75), scalars(1700.0, 1100.0, 2300.0)
            i = member(torch.tensor([3, 5, 0][:rows], device=dev))
            traces = {route: member(torch.zeros(rows, 16, dtype=dt, device=dev)) for route in ("kernel", "plain")}
            work = pcg.scratch(x)

            def call(step, route):
                w = work if route == "kernel" else None
                return {"alpha": lambda: pcg.step_alpha(ctx, s, p, rr, b_norm, ru, PCG_STEP_TOL, traces[route], i, w),
                        "xr": lambda: pcg.step_xr(ctx, x, p, r, s, alpha, conv, rr, w),
                        "ru": lambda: pcg.step_ru(ctx, r, u, ru, conv, w),
                        "p": lambda: pcg.step_p(u, p, beta, conv, w)}[step]

            def size(a, c):  # the sum of the magnitudes of an inner product's terms, a member
                return (a.double() * c.double()).abs().sum(-1)

            shape = f"laplace2d({NX}, constant) {dt}, " + (f"({batch}, n)" if batch else "(n,)")
            for step in PCG_STEP_VECTORS:
                before = getattr(counted, step)
                got = call(step, "kernel")()
                launches = getattr(counted, step) - before
                want = call(step, "plain")()
                got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
                # exact: (got, want) pairs held bit for bit; near: (got, want,
                # magnitudes, members) held within rel; kept: (got, what the
                # converged member keeps)
                live, exact, near, kept = ~conv, list(zip(got, want)), [], []
                if step == "alpha":
                    sp = (s.double() * p.double()).sum(-1)
                    limit = torch.where(sp != 0, ru.double().abs() * size(s, p) / sp**2, 0.0)
                    exact = [(got[0], want[0]), (got[2], want[2]), (traces["kernel"], traces["plain"])]
                    near = [(got[1], want[1], limit, torch.ones_like(conv))]
                elif step == "xr":
                    exact, near, kept = exact[:2], [(got[2], want[2], size(want[1], want[1]), live)], [(got[2], rr)]
                elif step == "ru":
                    sz = size(r, u)
                    exact = []
                    near = [(got[0], want[0], sz, live), (got[1], want[1], sz / ru.double().abs(), live)]
                    kept = [(got[0], ru), (got[1], torch.zeros_like(ru))]
                same = all(torch.equal(a.view(bits) if a.is_floating_point() else a,
                                       c.view(bits) if c.is_floating_point() else c) for a, c in exact)
                within = all(bool(((g.double() - w.double()).abs() <= rel * lim)[m].all()) for g, w, lim, m in near)
                held = all(torch.equal(g[conv], k[conv]) for g, k in kept)
                tickets = bool((work[-rows:] == 0).all())
                diffs = [(a.double() - c.double()).abs() for a, c in exact if a.is_floating_point()]
                diffs += [(g.double() - w.double()).abs()[m] for g, w, _, m in near]
                err = max(float(d.max()) if d.numel() else 0.0 for d in diffs)

                def kernel():
                    return call(step, "kernel")()

                def plain():
                    return call(step, "plain")()

                device = {"kernel": kernels_us(kernel, PCG_STEP_REPS), "plain": kernels_us(plain, PCG_STEP_REPS)}
                events = {"kernel": [], "plain": []}
                for label in ("kernel", "plain", "plain", "kernel"):
                    events[label].append(cuda_ms(kernel if label == "kernel" else plain, reps=PCG_STEP_REPS)[0])
                events = {label: statistics.mean(v_) for label, v_ in events.items()}
                nbytes = PCG_STEP_VECTORS[step] * n * dt.itemsize * rows
                bnd = (nbytes / PEAK_BYTES * 1e3, "bytes")
                phase(f"pcg step_{step} {shape}: {launches} launch a call; exact outputs bitwise {same}, inner "
                      f"products within {rel:g} of their terms' magnitudes {within}, converged member kept "
                      f"{held}, tickets at 0 {tickets}, max abs err {err:.3e}; device "
                      f"{us_text(device['kernel'])} a call against the plain version's "
                      f"{us_text(device['plain'])} (torch.profiler, every kernel, {PCG_STEP_REPS} calls); CUDA "
                      f"events {events['kernel'] * 1e3:.3f} us against {events['plain'] * 1e3:.3f} us a call "
                      f"(kernel, plain, plain, kernel); bound {bnd[0] * 1e3:.3f} us ({nbytes / 1e6:.1f} MB at "
                      f"{PEAK_BYTES / 1e12:.2f} TB/s)")
                if not (same and within and held and tickets and launches == 1):
                    failures.append(f"pcg step_{step} {shape}: bitwise {same}, within {within}, kept {held}, "
                                    f"tickets {tickets}, {launches} launches")
                if dt == torch.float64 and batch is None:
                    timed = device["kernel"] is not None and device["plain"] is not None
                    ms_ = ((device["kernel"] / 1e3, device["plain"] / 1e3) if timed
                           else (events["kernel"], events["plain"]))
                    result[step] = (err, ms_[0], ms_[1], bnd, "torch.profiler device time of every kernel of a "
                                    f"call, mean of {PCG_STEP_REPS}" if timed
                                    else f"CUDA events, mean of {PCG_STEP_REPS} calls")
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 11c", failures)
    return result


def chunked(A, b_np, A_csr, fused, fused_kskip, stencil, unbroken: dict) -> dict:
    """12. ``solve(chunk_iters=CHUNK_ITERS)`` on the main-path system in
    float64.  The carry methods of CHUNK_RUNS chunk exactly on their eager
    loops: each is held against its unbroken eager solve (fused=False) on
    the card (``unbroken``: ``(x, info)`` by ``(method, k)`` of phases 5b
    and 11; cg and mrr run here), equal counts (CHUNK_RUNS), nosl, khistory and final k,
    histories within CHUNK_RTOL, at least 4 chunks, the host float64 true
    residual below tol, K1 launched (its counter set to 0 just before the
    chunked solve and read just after).  Then fused=True chunks of cg, mrr
    and kskipmrr k=4 warm-restart: one K2/K3/K5 launch a chunk, all
    resident, converged below tol; their counts are printed beside the
    unbroken ones.  Returns the launches of each kernel in the phase."""
    import numpy as np

    import krylov_tpu_torch

    launches = {"K1": 0, "fused_cg_solve_2d": 0, "fused_mrr_solve_2d": 0, "fused_kskipmrr_solve_2d": 0}
    failures = []
    for (m, k), count in CHUNK_RUNS.items():
        kw = dict(method=m, k=k, tol=TOL, maxiter=MAXITER)
        if (m, k) not in unbroken:
            unbroken[m, k] = krylov_tpu_torch.solve(A, b_np, fused=False, **kw)
        _, whole = unbroken[m, k]
        launched(stencil.stencil_matvec_2d).launches = 0
        x, info = krylov_tpu_torch.solve(A, b_np, chunk_iters=CHUNK_ITERS, **kw)
        k1 = launched(stencil.stencil_matvec_2d).launches
        launches["K1"] += k1
        true_res = true_rel(A_csr, b_np, x)
        m_res = len(info["residual"]) == len(whole["residual"])
        t_err = (float(np.max(np.abs(info["residual"] - whole["residual"]) / whole["residual"]))
                 if m_res else float("inf"))
        phase(f"chunked {m}{f' k={k}' if k else ''} float64, chunks of {CHUNK_ITERS}: iters {info['iterations']} "
              f"(unbroken eager {whole['iterations']}), chunks {info['chunks']}, converged {info['converged']}, "
              f"history max rel err against unbroken {t_err:.3e} (tol {CHUNK_RTOL:g}), host f64 true res "
              f"{true_res:.6e}, K1 launches {k1}; {info['time'] * 1e3:.3f} ms a solve chunked, "
              f"{whole['time'] * 1e3:.3f} ms unbroken (solve() wall)")
        same = (info["iterations"] == whole["iterations"] == count and m_res
                and np.array_equal(info["nosl"], whole["nosl"])
                and np.array_equal(info.get("khistory"), whole.get("khistory"))
                and info.get("final_k") == whole.get("final_k"))
        if not same:
            failures.append(f"chunked {m}: {info['iterations']} iterations, unbroken {whole['iterations']}, "
                            f"want {count}, or nosl/khistory/final k differ")
        elif not t_err <= CHUNK_RTOL:
            failures.append(f"chunked {m}: history differs from the unbroken solve by {t_err:.3e}")
        if not (info["converged"] and info["chunks"] >= 4 and true_res < TOL and k1 >= info["iterations"]):
            failures.append(f"chunked {m}: converged {info['converged']}, {info['chunks']} chunks, true res "
                            f"{true_res:.3e}, {k1} K1 launches")
    counted = {"cg": fused.fused_cg_solve_2d, "mrr": fused.fused_mrr_solve_2d,
               "kskipmrr": fused_kskip.fused_kskipmrr_solve_2d}
    for m, fn in counted.items():
        k = 4 if m == "kskipmrr" else 0
        reset((fn, stencil.stencil_matvec_2d))
        x, info = krylov_tpu_torch.solve(A, b_np, method=m, k=k, tol=TOL, maxiter=MAXITER, chunk_iters=CHUNK_ITERS,
                                         fused=True)
        res, stream = launched(fn).resident, launched(fn).streaming
        launches[fn.__name__] += res + stream
        launches["K1"] += launched(stencil.stencil_matvec_2d).launches
        true_res = true_rel(A_csr, b_np, x)
        phase(f"chunked {m}{f' k={k}' if k else ''} float64 fused=True (warm restarts), chunks of {CHUNK_ITERS}: "
              f"iters {info['iterations']} (unbroken {CHUNK_RUNS[m, k]}), chunks {info['chunks']}, converged "
              f"{info['converged']}, host f64 true res {true_res:.6e}, {fn.__name__} launches (resident, streaming) "
              f"({res}, {stream}), K1 launches (x0 shifts) {launched(stencil.stencil_matvec_2d).launches}; "
              f"{info['time'] * 1e3:.3f} ms a solve")
        if not (res == info["chunks"] and stream == 0 and info["converged"] and true_res < TOL):
            failures.append(f"fused chunks {m}: {res} resident and {stream} streaming launches for "
                            f"{info['chunks']} chunks, converged {info['converged']}, true res {true_res:.3e}")
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 12", failures)
    return launches


def checkpoint_phase(A, b_np, A_csr, fused_kskip) -> int:
    """13. ``checkpoint.save`` of the first chunk of an adaptive k-skip MrR
    solve (k=8, eager, CHUNK_ITERS iterations) into a temporary directory,
    ``load``, then ``resume`` on the card (the fused route: K5 after K1's
    x0 shift): the file holds the five keys of the JAX package's layout,
    the resumed solve converges with the host float64 true residual below
    tol.  Returns K5's launches in the phase."""
    import os
    import tempfile

    import numpy as np

    import krylov_tpu_torch
    from krylov_tpu_torch import checkpoint

    kw = dict(method="adaptivekskipmrr", k=8, tol=TOL)
    x1, info1 = krylov_tpu_torch.solve(A, b_np, maxiter=CHUNK_ITERS, fused=False, **kw)
    reset((fused_kskip.fused_kskipmrr_solve_2d,))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chunk.npz")
        checkpoint.save(path, x1, info1, method="adaptivekskipmrr")
        with np.load(path) as z:
            keys = sorted(z.files)
        x_saved, state = checkpoint.load(path)
        x, info = checkpoint.resume(A, b_np, path, maxiter=MAXITER, **kw)
    launches = launched(fused_kskip.fused_kskipmrr_solve_2d).launches
    true_res = true_rel(A_csr, b_np, x)
    phase(f"checkpoint: first chunk {info1['iterations']} iterations (true res {true_rel(A_csr, b_np, x1):.6e}), "
          f"keys {keys}; resumed from {state['meta']['iterations']}: iters {info['iterations']}, converged "
          f"{info['converged']}, final k {info.get('final_k')}, host f64 true res {true_res:.6e}, x on {x.device}, "
          f"K5 launches {launches}")
    if keys != sorted(["x", "residual", "nosl", "khistory", "meta_json"]) or not np.array_equal(
            x_saved, x1.cpu().numpy()):
        raise AssertionError(f"checkpoint: keys {keys}, or the saved x differs from the solve's")
    if not (info["converged"] and true_res < TOL and info["resumed_from"]["prior_iterations"] == info1["iterations"]
            and launches >= 1):
        raise AssertionError(f"checkpoint: the resumed solve did not converge below tol (true res {true_res:.3e}) "
                             f"or did not run K5")
    return launches


def gram_orders(A, B) -> None:
    """The Gram of a k-skip MrR basis at k = 8 (19 rows a member: the chain
    of A on each row of ``B``, float64) summed three ways on the card: one
    strided-batched product of the whole stack, one product per member
    (Context.gram), and products and a sum over each entry (a tree
    reduction); prints each entry's largest relative distance from the
    last."""
    import torch

    V = [B]
    for _ in range(18):
        V.append(A.matvec(V[-1]))
    V = torch.stack(V, -2)
    batched = V @ V.mT
    member = torch.stack([v @ v.T for v in V])
    tree = torch.stack([(v[:, None, :] * v[None, :, :]).sum(-1) for v in V])
    dist = {name: float(((g - tree).abs() / tree.abs()).max()) for name, g in (("batched", batched),
                                                                              ("per member", member))}
    phase(f"Gram of an (8, 19, {B.shape[-1]}) float64 Krylov stack against products and a tree sum, max rel "
          f"distance: one strided-batched product {dist['batched']:.3e}, one product a member {dist['per member']:.3e}")


def batched_kskip(A, A_csr, hyb, dev, stencil) -> int:
    """14. solve_batched of NRHS right-hand sides (seed 21, float64) on the
    eager k-skip loops (fused=False) of the main-path stencil: kskipcg k=4,
    kskipmrr k=4 and adaptive k=8, then kskipmrr k=4 on the phase-9 HYB
    (seed 22).  Each member's iterations, outer count, nosl and khistory
    equal its solo eager solve, the host float64 true residuals are below
    tol.  K1's counter is set to 0 before the batch
    and before each solo solve: for the static loops the batch launches K1
    as often as its longest member's solo solve (one launch a batched
    SpMV); for adaptive both are printed.  Times a solve, batched against
    the solos, with CUDA events.  Returns K1's launches of the batches."""
    import numpy as np
    import torch

    import krylov_tpu_torch

    B = torch.from_numpy(np.random.default_rng(21).standard_normal((NRHS, NX * NX))).to(dev)
    gram_orders(A, B)
    P, H = hyb
    BH = torch.from_numpy(np.random.default_rng(22).standard_normal((NRHS, H.shape[0]))).to(dev)
    total, failures = 0, []
    for op, rhs, m, k, label in ((A, B, "kskipcg", 4, "stencil"), (A, B, "kskipmrr", 4, "stencil"),
                                 (A, B, "adaptivekskipmrr", 8, "stencil"), (H, BH, "kskipmrr", 4, "HYB")):
        kw = dict(method=m, k=k, tol=TOL, maxiter=MAXITER, fused=False)
        launched(stencil.stencil_matvec_2d).launches = 0
        t_batch, res = cuda_ms(lambda: krylov_tpu_torch.solve_batched(op, rhs, **kw))
        k1_batch = launched(stencil.stencil_matvec_2d).launches
        total += k1_batch
        solos, k1_solo = [], []

        def run_solos():
            for b in rhs:
                launched(stencil.stencil_matvec_2d).launches = 0
                solos.append(krylov_tpu_torch.solve_device(op, b, **kw))
                k1_solo.append(launched(stencil.stencil_matvec_2d).launches)

        t_solo, _ = cuda_ms(run_solos)
        x_rel = max(rel_err(res.x[j], s.x) for j, s in enumerate(solos))
        phase(f"batched {m} k={k} float64 eager, {label}, {NRHS} RHS: iterations {res.iterations.tolist()} "
              f"(solo {[int(s.iterations) for s in solos]}), "
              f"outer {res.index.tolist()}, converged {res.converged.tolist()}"
              + ("" if res.final_k is None else f", final k {res.final_k.tolist()}")
              + f"; K1 launches batched {k1_batch}, longest solo {max(k1_solo)}; {t_batch / NRHS:.3f} ms a solve "
              f"batched, {t_solo / NRHS:.3f} ms solo (CUDA events); max |x - x_solo| / max |x_solo| {x_rel:.3e}")
        for j, s in enumerate(solos):
            m_ = int(s.index) + 1
            same = (int(res.iterations[j]), int(res.index[j]), bool(res.converged[j])) == (
                int(s.iterations), int(s.index), bool(s.converged)) and torch.equal(res.nosl_trace[j, :m_],
                                                                                   s.nosl_trace[:m_])
            if s.k_trace is not None:
                same = same and torch.equal(res.k_trace[j, :m_], s.k_trace[:m_]) and int(res.final_k[j]) == int(
                    s.final_k)
            if not (same and bool(s.converged)):
                failures.append(f"batched {m} {label} member {j}: counts or traces differ from its solo solve")
        true_res = max(true_rel(P if label == "HYB" else A_csr, rhs[j].cpu().numpy(), res.x[j]) for j in range(NRHS))
        if not true_res < TOL:
            failures.append(f"batched {m} {label}: host true residual {true_res:.3e}")
        if label == "stencil" and m != "adaptivekskipmrr" and k1_batch != max(k1_solo):
            failures.append(f"batched {m}: {k1_batch} K1 launches, the longest solo solve {max(k1_solo)}")
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 14", failures)
    return total


def batched_eager(ops, A_csr, B, stencil) -> int:
    """17. solve_batched of the NRHS right-hand sides of phase 14 (seed 21,
    float64) on the batched eager loops of the main-path stencil, for
    BATCHED_RUNS (pcg with M None, Jacobi and Chebyshev(6), the other
    pipelined methods with Jacobi, cacg/camrr k=4 with Lanczos bounds).
    Each member's count, index, convergence flag, nosl and residual traces
    and x bitwise equal to its solo solve; the host float64 true residuals
    below tol.  K1's counter is set to 0 before the batch and before each
    solo solve: a pipelined batch launches K1 as often as its longest
    solo solve (one launch a batched SpMV; a Chebyshev application runs
    the Chebyshev step, not K1); a
    CA batch may add, in an outer iteration where some members roll back
    while others advance, the rollback branch's SpMVs (one for cacg, two
    for camrr's half-step) to the advance's one, which a solo solve takes
    in turns; those outer iterations are counted and printed.  Times a
    solve, batched against the solos, with CUDA events.  Returns K1's
    launches of the batches."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch import precond
    from krylov_tpu_torch.solvers import cacg

    A = ops[torch.float64]
    Ms = {"none": None, "jacobi": precond.jacobi(A), "chebyshev6": precond.chebyshev(A, degree=6)}
    bounds = precond.lanczos_bounds(A)
    mixed = [0]  # outer iterations of a CA batch that ran both branches
    read = cacg._Outer.read

    def logged(self, *args):
        out = read(self, *args)
        mixed[0] += bool(out[0].size and out[1].size)
        return out

    cacg._Outer.read = logged
    total, failures = 0, []
    try:
        for m, p, k in BATCHED_RUNS:
            kw = dict(method=m, M=Ms[p], k=k, tol=TOL, maxiter=MAXITER)
            if m in ("cacg", "camrr"):
                kw["spectral_bounds"] = bounds
            mixed[0] = 0
            launched(stencil.stencil_matvec_2d).launches = 0
            t_batch, res = cuda_ms(lambda: krylov_tpu_torch.solve_batched(A, B, **kw))
            k1_batch, n_mixed = launched(stencil.stencil_matvec_2d).launches, mixed[0]
            total += k1_batch
            solos, k1_solo = [], []

            def run_solos():
                for b in B:
                    launched(stencil.stencil_matvec_2d).launches = 0
                    solos.append(krylov_tpu_torch.solve_device(A, b, **kw))
                    k1_solo.append(launched(stencil.stencil_matvec_2d).launches)

            t_solo, _ = cuda_ms(run_solos)
            true_res = max(true_rel(A_csr, B[j].cpu().numpy(), res.x[j]) for j in range(NRHS))
            phase(f"batched {m} M={p}{f' k={k}' if k else ''} float64 eager, stencil, {NRHS} RHS: iterations "
                  f"{res.iterations.tolist()} (solo {[int(s.iterations) for s in solos]}), outer {res.index.tolist()}, "
                  f"converged {res.converged.tolist()}; K1 launches batched {k1_batch}, longest solo {max(k1_solo)}"
                  + (f", outer iterations with a rollback beside an advance {n_mixed}" if m in ("cacg", "camrr")
                     else "") + f"; {t_batch / NRHS:.3f} ms a solve batched, {t_solo / NRHS:.3f} ms solo "
                  f"({t_batch / t_solo:.4f}x; CUDA events); host f64 true res max {true_res:.6e}")
            for j, s in enumerate(solos):
                m_ = int(s.index) + 1
                same = ((int(res.iterations[j]), int(res.index[j]), bool(res.converged[j]))
                        == (int(s.iterations), int(s.index), bool(s.converged))
                        and torch.equal(res.nosl_trace[j, :m_], s.nosl_trace[:m_])
                        and torch.equal(res.residual_trace[j, :m_], s.residual_trace[:m_])
                        and torch.equal(res.x[j], s.x))
                if not (same and bool(s.converged)):
                    failures.append(f"batched {m} M={p} member {j}: not bitwise its solo solve")
            if not true_res < TOL:
                failures.append(f"batched {m} M={p}: host true residual {true_res:.3e}")
            extra = 2 * n_mixed if m in ("cacg", "camrr") else 0
            if not max(k1_solo) <= k1_batch <= max(k1_solo) + extra:
                failures.append(f"batched {m} M={p}: {k1_batch} K1 launches, the longest solo solve {max(k1_solo)}"
                                f" (+ at most {extra} for rollbacks)")

    finally:
        cacg._Outer.read = read
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 17", failures)
    return total


def profiling_phase(A, b_np, tmp: str, fused, stencil) -> dict:
    """18, in the process of :func:`profiling_child`.
    :mod:`krylov_tpu_torch.diagnostics.profiling` on the main path:
    ``trace_solve`` of the float64 MrR solve (934 iterations) writes a
    trace whose kernel events name the resident K2 kernel, and a
    warm-started one (x0 = half the first solve's x) names K1 beside it,
    each on its first try; ``phase_times`` returns its five keys with 934
    iterations; :func:`graph_k1_check` holds K1's counter on the eager
    loops' graph route, and the Chebyshev step's, against the profiler's
    kernel records.  Prints each trace's kernel names with their summed
    device µs.  Returns the phase's launches of K1, of the Chebyshev step,
    of pcg's four step kernels and of K2 on each route."""
    import glob
    import os

    from krylov_tpu_torch import tracing
    from krylov_tpu_torch.diagnostics import profiling

    counted = (stencil.stencil_matvec_2d, fused.fused_mrr_solve_2d)
    reset(counted)
    x0, failures = None, []
    for run in ("cold", "warm"):
        want = {"mrr_resident_kernel": True, "stencil2d_kernel": run == "warm"}
        d = os.path.join(tmp, f"trace_{run}")
        x, info = profiling.trace_solve(A, b_np, d, method="mrr", tol=TOL, maxiter=MAXITER, x0=x0)
        paths = glob.glob(os.path.join(d, "*.pt.trace.json"))
        with open(paths[0]) as f:
            trace_events = json.load(f)["traceEvents"]
        events = [e for e in trace_events if e.get("cat") == "kernel"]
        launches = [e["ts"] for e in trace_events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver") and "aunch" in e.get("name", "")]
        us = {}
        for e in events:
            us[e["name"]] = us.get(e["name"], 0.0) + float(e.get("dur", 0.0))
        named = {key: any(key in n for n in us) for key in want}
        offset = min(e["ts"] for e in events) - min(launches) if events and launches else float("nan")
        phase(f"trace_solve mrr float64 {run}: {len(paths)} trace file(s), {len(events)} kernel events for "
              f"{len(launches)} launch calls, first kernel {offset:.1f} us after the first launch; "
              f"iterations {info['iterations']}, converged {info['converged']}; kernels (device us summed): "
              + ", ".join(f"{n[:60]} {v:.3f}" for n, v in sorted(us.items(), key=lambda kv: -kv[1])[:6]))
        if len(paths) != 1 or not info["converged"] or any(named[key] != v for key, v in want.items() if v):
            failures.append(f"trace_solve {run}: {len(paths)} trace files, kernels named {named}")
        if run == "cold":
            if info["iterations"] != 934:
                failures.append(f"trace_solve cold: {info['iterations']} iterations, want 934")
            x0 = 0.5 * x
    pt = profiling.phase_times(A, b_np, method="mrr", tol=TOL, maxiter=MAXITER)
    phase(f"phase_times mrr float64 N={NX * NX}: " + ", ".join(
        f"{key} {v:.6f}" if isinstance(v, float) else f"{key} {v}" for key, v in pt.items()))
    keys = {"compile_plus_first_solve_s", "solve_s", "fetch_s", "iterations", "converged"}
    if set(pt) != keys or pt["iterations"] != 934 or not pt["converged"]:
        failures.append(f"phase_times: {pt}")
    graph_k1_check(A, b_np, stencil, failures)
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 18", failures)
    launches = {fn.__name__: launched(fn).launches for fn in (stencil.stencil_matvec_2d, stencil.chebyshev_apply)}
    launches["pcg_launches"] = list(vars(tracing.totals.pcg_launches).values())
    return {**launches, **route_counts(counted[1:])}


def graph_k1_check(A, b_np, stencil, failures: list) -> None:
    """18b. The eager loops' graph route on the main-path system: pcg
    (M = None, then M = Chebyshev(6), float64) three times on one
    operator, the first capturing its block after the warm-up block and
    the others replaying every block, each request under torch.profiler.
    A replay adds to K1's launch counter, and to the Chebyshev step's, the
    launches its capture recorded (the capture adds nothing), so in each
    profile each counter must move by its kernel's records, and the
    requests must replay.  With Chebyshev(6) every application must run
    fused, in 5 launches of the Chebyshev step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import krylov_tpu_torch
    from krylov_tpu_torch import precond, tracing

    b = torch.from_numpy(b_np).to(A.device, A.dtype)
    g, applied = tracing.totals.eager_graph, tracing.totals.cheb_apply
    kernels = {"K1": (stencil.stencil_matvec_2d, "stencil2d_kernel"),
               "Chebyshev step": (stencil.chebyshev_apply, "cheb_step2d_kernel")}
    for label, M in (("M=None", None), ("M=chebyshev6", precond.chebyshev(A, degree=6))):
        for run in ("capture", "replay", "replay"):
            torch.cuda.synchronize()
            before = {key: launched(fn).launches for key, (fn, _) in kernels.items()}
            captures, replays, calls, fused = g.captures, g.replays, applied.calls, applied.fused
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                res = krylov_tpu_torch.solve_device(A, b, method="pcg", M=M, tol=TOL, maxiter=MAXITER)
                torch.cuda.synchronize()
            counted = {key: launched(fn).launches - before[key] for key, (fn, _) in kernels.items()}
            recorded = {key: sum(evt.count for evt in prof.key_averages()
                                 if name in evt.key and evt.device_type == DeviceType.CUDA)
                        for key, (_, name) in kernels.items()}
            captures, replays = g.captures - captures, g.replays - replays
            calls, fused = applied.calls - calls, applied.fused - fused
            phase(f"graph route pcg {label} float64 N={NX * NX} ({run}): iterations {int(res.iterations)}, "
                  f"captures {captures}, replays {replays}; applications {calls}, fused {fused}; "
                  + ", ".join(f"{key} counted {counted[key]}, kernel records {recorded[key]}" for key in kernels))
            cheb_ok = (fused == calls == 0 if M is None else
                       fused == calls == counted["K1"] and counted["Chebyshev step"] == 5 * calls)
            if counted != recorded or replays < 1 or captures != (run == "capture") or not cheb_ok:
                failures.append(f"graph route pcg {label} ({run}): counted {counted}, kernel records {recorded}, "
                                f"captures {captures}, replays {replays}, applications {calls}, fused {fused}")


def profiling_child(tmp: str) -> int:
    """Phase 18's process (``chip_smoke.py --profiling TMP``): the
    main-path system in float64 and its b, then :func:`profiling_phase`,
    whose launches it prints as a last line.  A process of its own, so
    that its traces are the process's first profiler sessions (on the
    card, traces taken after long use of the profiler in one process have
    lost kernel records; PERF.md, Open question 7) and that its profiler
    sessions leave no trace on the timed phases of the main process."""
    import numpy as np
    import torch

    from krylov_tpu_torch.kernels import fused, stencil
    from krylov_tpu_torch.sparse import fixtures

    if not torch.cuda.is_available():
        return 1
    A = fixtures.laplace2d(NX, dtype=torch.float64, constant=True, device=torch.device("cuda"))
    b_np = np.random.default_rng(0).standard_normal(NX * NX)
    launches = profiling_phase(A, b_np, tmp, fused, stencil)
    print("launches " + json.dumps(launches), flush=True)
    return 0


def profiling_run(tmp: str) -> dict:
    """18. :func:`profiling_child` as a subprocess on the card, after every
    timed phase, within PROFILING_TIMEOUT seconds; its lines are printed,
    and a nonzero exit fails the phase.  Returns its launches: ``{name:
    launches}`` for K1, ``{name: [resident, streaming]}`` for K2."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"), "--profiling", tmp],
                          capture_output=True, text=True, cwd=root, timeout=PROFILING_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        phase(line)
    phase(f"phase 18 process: exit {proc.returncode}, {time.perf_counter() - t0:.2f} s (subprocess wall)")
    if proc.returncode != 0 or not lines or not lines[-1].startswith("launches "):
        phase(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise AssertionError(f"phase 18 failed: exit {proc.returncode}")
    return json.loads(lines[-1].removeprefix("launches "))


def bench_phase(k1_us) -> None:
    """20. ``python -m krylov_tpu_torch.bench``, the port's bench, in a
    subprocess after every other phase, once a run of BENCH_RUNS, each
    within BENCH_TIMEOUT seconds (and its own budget of BENCH_BUDGET): its
    JSON line is printed, and it must exit 0, take the run's checked count,
    reach a true residual below tol on its checked solve and its median
    trial, launch its three timed solves on the resident route, and read
    K1's device time from its CUDA graph within 4x of ``k1_us``, phase 6's
    profiler reading."""
    import math
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    failures = []
    for args, want in BENCH_RUNS.items():
        label = " ".join(args) or "(defaults)"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "krylov_tpu_torch.bench", "--budget", str(BENCH_BUDGET), *args],
                              capture_output=True, text=True, cwd=root, timeout=BENCH_TIMEOUT)
        lines = proc.stdout.strip().splitlines()
        phase(f"bench {label}: exit {proc.returncode}, {time.perf_counter() - t0:.2f} s (subprocess wall)")
        phase(lines[-1] if lines else "(no output)")
        if proc.returncode != 0 or not lines:
            phase(proc.stderr[-4000:])
            failures.append(f"bench {label}: exit {proc.returncode}")
            continue
        e = json.loads(lines[-1])["extra"]
        us = e["spmv_us_device"]
        checks = {
            f"checked count {e['checked_iterations']}, want {want}": e["checked_iterations"] == want,
            f"true residuals {e['checked_residual_true']:.6e} (checked), {e['residual_true']:.6e} (median trial)":
                max(e["checked_residual_true"], e["residual_true"]) < TOL,
            f"route {e['route']}": e["route"] == {"resident": 3, "streaming": 0},
            f"spmv_us_device {us} against phase 6's K1 {us_text(k1_us)}":
                k1_us is not None and isinstance(us, float) and math.isfinite(us) and k1_us / 4 <= us <= 4 * k1_us,
        }
        for text, ok in checks.items():
            if not ok:
                phase(f"  FAILED: bench {label}: {text}")
                failures.append(f"bench {label}: {text}")
    raise_failures("phase 20", failures)


def start_examples() -> dict:
    """19, started: each example of ``krylov_tpu_torch.examples`` as its own
    subprocess on the card (``--device cuda``), through EXAMPLE_RUNNER,
    which prints the example's launches of the hand kernels after it.
    They run beside phases 3-4b (and phase 15), which time nothing they
    hold; :func:`examples_phase` waits for them before phase 5.  Returns
    ``{name: (process, start time)}``."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    return {name: (subprocess.Popen([sys.executable, "-c", EXAMPLE_RUNNER, name], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, cwd=root), time.perf_counter())
            for name in EXAMPLE_MARKERS}


def examples_phase(runs: dict, cards: int) -> dict:
    """19. The examples of :func:`start_examples`, each within
    EXAMPLE_TIMEOUT seconds of its start: exit 0, no "diverged", the
    markers of EXAMPLE_MARKERS, and distributed_solve's world of min(cards,
    4) NCCL ranks (its ranks are processes of their own, whose launches
    are not counted here).  Returns the launches the examples' processes
    counted, summed: ``{name: [launches]}`` for K1, ``{name: [resident,
    streaming]}`` for K2/K3/K5/K6."""
    failures, total = [], {}
    for name, (proc, t0) in runs.items():
        try:
            stdout, stderr = proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            failures.append(f"example {name}: not done within {EXAMPLE_TIMEOUT} s")
            continue
        wall = time.perf_counter() - t0
        lines = stdout.strip().splitlines()
        counts = json.loads(lines[-1].removeprefix("launches ")) if lines and lines[-1].startswith("launches ") else {}
        body = "\n".join(lines[:-1])
        phase(f"example {name}: exit {proc.returncode}, {wall:.2f} s from its start (subprocess wall, beside "
              f"phases 3-4b); launches {json.dumps(counts)}\n  " + "\n  ".join(
                  line for line in lines[:-1] if line.strip() and not line.startswith(("#", "Method", "Initial"))))
        markers = list(EXAMPLE_MARKERS[name])
        if name == "distributed_solve":
            markers.append((f"devices: {min(cards, 4)} x cuda", None))
        ok = proc.returncode == 0 and counts and "diverged" not in body and all(
            (body.count(text) >= 1) if n is None else (body.count(text) == n) for text, n in markers)
        if not ok:
            phase(stderr[-4000:])
            failures.append(f"example {name}: exit {proc.returncode}, markers {markers}")
        for key, v in counts.items():
            v = v if isinstance(v, list) else [v]
            total[key] = [a + b for a, b in zip(total.get(key, [0] * len(v)), v)]
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 19", failures)
    return total


def fixup_on_card(ops, stencil) -> None:
    """16a. The sharded stencil matvec's K1 calls at a split of the
    main-path grid over 4 ranks, without a world: each rank's bulk (K1 on
    its slab) and boundary planes (K1 on the extended slabs, from the true
    halo planes of x) against the whole grid's K1, in both forms and both
    dtypes; held at K1's limits, and whether the bits are equal is printed
    (each point sums its terms in stencil order in both)."""
    import numpy as np
    import torch

    from krylov_tpu_torch.dist.spmv import ShardedOperator, local_block, partition, stencil_boundary, stencil_bulk
    from krylov_tpu_torch.sparse import fixtures

    P = 4
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for label, A in (("constant", ops[dt]), ("grid", fixtures.laplace2d(NX, dtype=dt, device=ops[dt].device))):
            x = torch.from_numpy(np.random.default_rng(17).standard_normal((2, A.shape[0]))).to(A.device, dt)
            want = stencil.stencil_matvec(A, x)
            kind, arrays, offsets, strategy, grid = partition(A, P)
            n, parts = A.shape[0] // P, []
            launches = launched(stencil.stencil_matvec_2d).launches
            for rank in range(P):
                op = ShardedOperator(kind=kind, arrays=local_block(kind, arrays, P, rank), offsets=offsets,
                                     shape=A.shape, n_devices=P, strategy=strategy, rank=rank, grid=grid)
                plane, s0 = op.aux["plane"], rank * n
                x_l = x[:, s0: s0 + n].contiguous()
                top = x[:, s0 - plane: s0].contiguous() if rank > 0 else None
                bottom = x[:, s0 + n: s0 + n + plane].contiguous() if rank < P - 1 else None
                parts.append(stencil_boundary(op, x_l, stencil_bulk(op, x_l), top, bottom))
            launches = launched(stencil.stencil_matvec_2d).launches - launches
            got = torch.cat(parts, -1)
            err = rel_err(got, want)
            phase(f"sharded stencil matvec at 4 ranks, laplace2d({NX}) {label} {dt}, (2, n) block: {launches} K1 "
                  f"launches (4 bulk, 6 boundary), max rel err against the whole grid's K1 {err:.3e} (tol {rtol:g}), "
                  f"bitwise equal {torch.equal(got, want)}")
            if not (err <= rtol and launches == 10):
                raise AssertionError(f"the sharded stencil matvec disagrees with K1 on the whole grid ({label} {dt})")


def sharded_phase(ops, b_np, A_csr, hyb, tmp: str, stencil, B) -> int:
    """16. ``solve(mesh=)`` in an NCCL world of one (a ``file://`` store in
    ``tmp``, ``device_id`` the card): each run of SHARDED_RUNS on the
    main-path system in float64 held against the eager single-device solve
    of the same method (fused=False; pcg on torch's passes, as its sharded
    body runs): its count and SHARDED_RUNS's, nosl,
    khistory, residual history and x bitwise equal (the slab is the whole
    grid and the sum of one rank is its input), the host float64 true
    residual below tol; one float32 CG likewise; CG on the phase-9 HYB
    through the all-gather, the same.  Prints K1 launches and NCCL
    all-reduces an iteration, ms an iteration sharded against eager on the
    host clock (paired: eager, sharded, sharded, eager, twice) and the
    all-gather's µs on the HYB, with the card's name and power limit.
    16c: adaptive k=8, with and without ``restarts=1``, through
    ``solve_device(mesh=)`` twice, its steps replayed as CUDA graphs with
    their all-reduces captured, bitwise the eager single-device loop with
    every step launched from Python (the true residuals within 1e-13).
    16b: ``solve_batched(mesh=)`` of SHARDED_BATCHED on 4 of ``B``'s
    right-hand sides, bitwise equal to the eager batch, with as many
    all-reduces as its longest member's solo sharded solve, and ms an
    (outer) iteration beside the members solved one by one.
    Then, with the world gone, the multi-rank NCCL runs where the machine
    has two cards or more (:mod:`krylov_tpu_torch.diagnostics.dryrun_multichip`
    with the main-path solves at N = 250k, and :mod:`.weak_scaling`, over
    min(4, cards) ranks, their counts held within k + 1 of one rank's), or
    a line saying that it has one.  Returns
    K1's launches of the sharded solves."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    import krylov_tpu_torch
    from krylov_tpu_torch import precond, tracing
    from krylov_tpu_torch.context import all_reduce
    from krylov_tpu_torch.dist import make_mesh
    from krylov_tpu_torch.dist.spmv import gather_rows, sharded_matvec
    from krylov_tpu_torch.solvers import _common, pipelined

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cards = torch.cuda.device_count()
    phase(f"cards on this machine: {cards} ({smi})")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "nccl_store"), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    k1_total, failures = 0, []
    # a sharded pcg body runs torch's passes (its inner products sum over
    # the group), so the eager pcg it is held against runs them too
    route, pipelined.pcg_route = pipelined.pcg_route, lambda *args: False
    try:
        mesh = make_mesh()
        A = ops[torch.float64]
        bounds = precond.lanczos_bounds(A)
        b_nrm = np.linalg.norm(b_np)

        def hold(label, A_, A_csr_, b_, kw, want_iters=None, below_tol=True):
            """One sharded solve against the eager one (want_iters: the
            count both must take, else the eager solve's; below_tol: hold
            the host float64 true residual below tol)."""
            nonlocal k1_total
            x_e, i_e = krylov_tpu_torch.solve(A_, b_, fused=False, **kw)
            want_iters = i_e["iterations"] if want_iters is None else want_iters
            launched(stencil.stencil_matvec_2d).launches, all_reduce.calls, gathers = 0, 0, sharded_matvec.gather_bytes
            x_s, i_s = krylov_tpu_torch.solve(A_, b_, mesh=mesh, **kw)
            k1, reduces = launched(stencil.stencil_matvec_2d).launches, all_reduce.calls
            k1_total += k1
            true_res = float(np.linalg.norm(b_ - A_csr_ @ x_s.double().cpu().numpy()) / np.linalg.norm(b_))
            phase(f"sharded {label}: iters {i_s['iterations']} (eager {i_e['iterations']}, want {want_iters}), "
                  f"converged {i_s['converged']}, true res {true_res:.6e}, x bitwise equal {torch.equal(x_s, x_e)}; "
                  f"K1 launches {k1} ({k1 / i_s['iterations']:.3f} an iteration), NCCL all-reduces {reduces} "
                  f"({reduces / i_s['iterations']:.3f} an iteration), all-gather bytes "
                  f"{sharded_matvec.gather_bytes - gathers}; solve() wall {i_s['time'] * 1e3:.3f} ms sharded, "
                  f"{i_e['time'] * 1e3:.3f} ms eager")
            same = (i_s["iterations"] == i_e["iterations"] == want_iters and torch.equal(x_s, x_e)
                    and all(np.array_equal(i_s[key], i_e[key]) for key in ("nosl", "residual", "khistory")
                            if key in i_e or key in i_s))
            # a stencil's sharded SpMV is K1: at least one launch an iteration
            k1_ok = k1 >= i_s["iterations"] if isinstance(A_, type(ops[torch.float64])) else k1 == 0
            if not (same and k1_ok and i_s["converged"] and (true_res < TOL or not below_tol)):
                failures.append(f"sharded {label}: not the eager solve's count, traces and x, K1 launches {k1}, or "
                                f"true res {true_res:.3e} not below tol")

        for (m, k, p), want in SHARDED_RUNS.items():
            kw = dict(method=m, k=k, tol=TOL, maxiter=MAXITER)
            if p == "jacobi":
                kw["M"] = precond.jacobi(A)
            if m == "cacg":
                kw["spectral_bounds"] = bounds
            hold(f"{m}{f' k={k}' if k else ''}{f' M={p}' if p else ''} float64", A, A_csr, b_np, kw, want)
        # 16c. the adaptive loop's steps as CUDA graphs under the mesh, their
        # all-reduces captured, against the eager single-device loop (every
        # step launched from Python), restarts=1 included
        b_t = torch.from_numpy(b_np).to(A.coef.device)
        for restarts in (0, 1):
            kw = dict(method="adaptivekskipmrr", k=8, tol=TOL, maxiter=MAXITER, restarts=restarts)
            route_of, _common.step_route = _common.step_route, lambda state: False
            try:
                e = krylov_tpu_torch.solve_device(A, b_t, fused=False, **kw)
            finally:
                _common.step_route = route_of
            replays = tracing.totals.eager_graph.replays
            runs = [krylov_tpu_torch.solve_device(A, b_t, mesh=mesh, **kw) for _ in range(2)]
            replays = tracing.totals.eager_graph.replays - replays
            same = all(torch.equal(getattr(r, f), getattr(e, f)) for r in runs
                       for f in ("x", "residual_trace", "nosl_trace", "k_trace", "final_k", "iterations"))
            close = restarts == 0 or all(abs(float(r.true_residual) - float(e.true_residual))
                                         <= 1e-13 * float(e.true_residual) for r in runs)
            phase(f"sharded adaptive k=8 restarts={restarts} float64, steps as CUDA graphs: iterations "
                  f"{[int(r.iterations) for r in runs]} (eager single-device loop {int(e.iterations)}), replayed steps "
                  f"{replays} over two requests, bitwise equal to the eager loop {same}"
                  + (f", true res {[float(r.true_residual) for r in runs]} (eager {float(e.true_residual)})"
                     if restarts else ""))
            if not (same and close and replays > 0 and all(bool(r.converged) for r in runs)):
                failures.append(f"sharded adaptive restarts={restarts}: the graph route is not the eager loop's "
                                f"bits, or replayed no step ({replays})")
        # float32: its true residual is printed, not held (phase 5's)
        hold("cg float32", ops[torch.float32], A_csr, b_np, dict(method="cg", tol=TOL, maxiter=MAXITER),
             below_tol=False)
        P_csr, H = hyb
        b_h = np.random.default_rng(0).standard_normal(H.shape[0])
        hold("cg HYB powerlaw_spd(2**20), all-gather", H, P_csr, b_h, dict(method="cg", tol=TOL, maxiter=MAXITER))

        # 16b. batches under mesh=: one (batch, n) loop, whose reductions sum
        # the whole batch in one all-reduce each
        B4 = B[:4]
        for m, k, p in SHARDED_BATCHED:
            kw = dict(method=m, k=k, tol=TOL, maxiter=MAXITER)
            if p == "jacobi":
                kw["M"] = precond.jacobi(A)
            if m == "cacg":
                kw["spectral_bounds"] = bounds
            eager = krylov_tpu_torch.solve_batched(A, B4, **kw)
            launched(stencil.stencil_matvec_2d).launches, all_reduce.calls = 0, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = krylov_tpu_torch.solve_batched(A, B4, mesh=mesh, **kw)
            torch.cuda.synchronize()
            t_batch = time.perf_counter() - t0
            k1, reduces = launched(stencil.stencil_matvec_2d).launches, all_reduce.calls
            k1_total += k1
            solo_reduces, t_solo = [], 0.0
            for b in B4:
                all_reduce.calls = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                krylov_tpu_torch.solve_device(A, b, mesh=mesh, **kw)
                torch.cuda.synchronize()
                t_solo += time.perf_counter() - t0
                solo_reduces.append(all_reduce.calls)
            steps = int(res.index.max())  # (outer) iterations of the longest member
            same = (torch.equal(res.x, eager.x) and torch.equal(res.iterations, eager.iterations)
                    and torch.equal(res.residual_trace, eager.residual_trace)
                    and torch.equal(res.nosl_trace, eager.nosl_trace))
            true_res = max(true_rel(A_csr, B4[j].cpu().numpy(), res.x[j]) for j in range(len(B4)))
            phase(f"sharded batch {m}{f' k={k}' if k else ''}{f' M={p}' if p else ''} float64, {len(B4)} RHS: "
                  f"iterations {res.iterations.tolist()}, bitwise equal to the eager batch {same}, host f64 true res "
                  f"max {true_res:.6e}; NCCL all-reduces {reduces} ({reduces / steps:.3f} an (outer) iteration of "
                  f"the longest member), member by member {solo_reduces} (longest {max(solo_reduces)}); K1 launches "
                  f"{k1}; ms an (outer) iteration of the batch {t_batch * 1e3 / steps:.4f}, member by member (the "
                  f"path before the batch loop) {t_solo * 1e3 / steps:.4f} ({t_batch / t_solo:.4f}x; host clock "
                  f"between synchronisations; {smi})")
            if not (same and bool(res.converged.all()) and true_res < TOL and reduces == max(solo_reduces)):
                failures.append(f"sharded batch {m}: not the eager batch bitwise, or {reduces} all-reduces against "
                                f"the longest member's {max(solo_reduces)}")

        # the all-gather of one iterate of the HYB system, alone
        x = torch.from_numpy(b_h).to(H.device)
        buf = torch.empty_like(x)
        group = mesh.get_group()
        gather_rows(x, 1, group, buf)
        ag_ms = cuda_ms(lambda: gather_rows(x, 1, group, buf), reps=200)[0]
        ag_host = host_us(lambda: gather_rows(x, 1, group, buf), reps=200)
        phase(f"all-gather of a float64 x of {H.shape[0]} rows in the world of one: {ag_ms * 1e3:.3f} us a call "
              f"(CUDA events over 200 calls), {ag_host:.3f} us a call on the host ({smi})")

        for m, k in SHARDED_TIMED:
            kw = dict(method=m, k=k, tol=TOL, maxiter=MAXITER)
            eager, shard = [], []
            for _ in range(2):
                for route in ("eager", "sharded", "sharded", "eager"):
                    _, info = krylov_tpu_torch.solve(A, b_np, **kw, **({"mesh": mesh} if route == "sharded"
                                                                       else {"fused": False}))
                    (shard if route == "sharded" else eager).append(info["time"] * 1e3 / info["iterations"])
            phase(f"ms an iteration, {m}{f' k={k}' if k else ''} float64 N={NX * NX} (host clock between device "
                  f"synchronisations, paired eager, sharded, sharded, eager, twice; {smi}): sharded "
                  f"{[round(v, 6) for v in shard]}, eager {[round(v, 6) for v in eager]}; median sharded / eager "
                  f"{statistics.median(shard) / statistics.median(eager):.4f}")
    finally:
        pipelined.pcg_route = route
        dist.destroy_process_group()
    for f in failures:
        phase(f"  FAILED: {f}")
    raise_failures("phase 16", failures)

    if cards < 2:
        phase(f"multi-rank NCCL run: not possible on this machine, which has {cards} card (NCCL takes one card "
              "a rank)")
        return k1_total
    ranks = min(4, cards)
    runs = {
        "dryrun_multichip": [sys.executable, "-m", "krylov_tpu_torch.diagnostics.dryrun_multichip", "--ranks",
                             str(ranks), "--device", "cuda", "--nx", str(NX)],
        "weak_scaling": [sys.executable, "-m", "krylov_tpu_torch.diagnostics.weak_scaling", "--ranks", "1",
                         str(ranks), "--device", "cuda"],
    }
    for name, cmd in runs.items():
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        phase(f"{name} over {ranks} NCCL ranks: exit {proc.returncode}\n  " + "\n  ".join(proc.stdout.splitlines()))
        if proc.returncode != 0:
            phase(proc.stderr[-4000:])
            raise AssertionError(f"{name} over {ranks} NCCL ranks failed")
        lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        if name == "dryrun_multichip":  # the main path's counts it holds itself
            off = {s: r for s, r in lines[0]["dryrun_multichip"].items() if abs(r["sharded"] - r["single"]) > r["k"] + 1}
        else:
            off = {(r["ranks"], r["rank"]): r["iterations"] for r in lines if r["iterations"] != lines[0]["iterations"]}
        if off:
            raise AssertionError(f"{name} over {ranks} NCCL ranks: counts off those of one rank: {off}")
    return k1_total


def start_cli(tmp: str):
    """15, started: ``python -m krylov_tpu_torch solve --config
    condition.json`` in a subprocess on the main-path system (k-skip MrR
    k=4, float64, chunks of CHUNK_ITERS, ``"b": "random"``, the main
    path's b), its solution saved under ``tmp``.  It runs beside phases
    3-4b, which time nothing they hold; :func:`cli_phase` waits for it
    before phase 5.  Returns ``(process, start time, solution path)``."""
    import os

    out, cfg_path = os.path.join(tmp, "x.npz"), os.path.join(tmp, "condition.json")
    with open(cfg_path, "w") as f:
        json.dump({"matrix": {"fixture": "laplace2d", "n": NX, "constant": True}, "b": "random",
                   "method": "kskipmrr", "k": 4, "dtype": "float64", "chunk_iters": CHUNK_ITERS, "out": out}, f)
    proc = subprocess.Popen([sys.executable, "-m", "krylov_tpu_torch", "solve", "--config", cfg_path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter(), out


def cli_phase(run, A_csr) -> None:
    """15. The driver run of :func:`start_cli`: exit code 0, the saved
    iterate loads with 936 iterations and the host float64 true residual
    below tol.  Then ``info`` on the same fixture, in this process."""
    import contextlib
    import io

    import numpy as np

    from krylov_tpu_torch import checkpoint, cli

    proc, t0, out = run
    stdout, stderr = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    phase("  " + "\n  ".join(stdout.strip().splitlines()))
    if proc.returncode != 0:
        phase(stderr[-4000:])
        raise AssertionError(f"python -m krylov_tpu_torch solve exited {proc.returncode}")
    x, state = checkpoint.load(out)
    b = np.random.default_rng(0).standard_normal(NX * NX)
    true_res = float(np.linalg.norm(b - A_csr @ x) / np.linalg.norm(b))
    phase(f"cli solve: exit 0, {wall:.2f} s from its start (subprocess wall, beside phases 3-4b), "
          f"{state['meta']['iterations']} iterations, converged {state['meta']['converged']}, "
          f"{len(state['nosl'])} trace entries, host f64 true res {true_res:.6e}")
    if state["meta"]["iterations"] != 936 or not true_res < TOL:
        raise AssertionError(f"cli solve: {state['meta']['iterations']} iterations (want 936), true res {true_res:.3e}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["info", "--fixture", "laplace2d", "--n", str(NX)])
    report = json.loads(buf.getvalue())
    phase(f"cli info: exit {rc}, {json.dumps(report)}")
    if rc != 0 or report["container"] != "StencilMatrix" or report["shape"] != [NX * NX, NX * NX]:
        raise AssertionError(f"cli info: exit {rc}, report {report}")


def k4_phase(dev) -> dict:
    """3b. K4, the resident stencil pass of K2/K3/K5/K6, alone
    (``fused.stencil_pass_probe``, its launches counted nowhere): on each
    system of K4_SYSTEMS in float64 and float32, the specialised pass
    (NS = 5 on the 2-D grids, 7 on the collapsed 3-D ones), in both its
    forms (predicated; split, 2 points at a time), holds the
    masked pass (NS = 0) bitwise on the same mirror over 3 passes, and the
    plain stencil to K1's tolerance.  Then its µs a pass on the main-path
    plan and on laplace3d(64) (NS = 7), as grid_sweep times it: (time of
    2000 passes - time of 200) / 1800, median of 3, CUDA events; and its
    bound, the shared-memory bytes of the largest band (NS loads of the
    element a point) at SMEM_BYTES_PER_CLOCK, at the SM clock nvidia-smi
    reads while a long probe runs.  Returns, in float64, ``{(ns, split):
    (max |y - y_plain|, ms a pass, plain ms, bound, conv ms, MHz)}``, the
    main-path plan for NS 0 and 5 and laplace3d(64) for 7."""
    import numpy as np
    import torch

    from krylov_tpu_torch.kernels import fused, stencil
    from krylov_tpu_torch.sparse import fixtures

    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, (fixture, shape) in K4_SYSTEMS.items():
        for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            A = getattr(fixtures, fixture)(*shape, dtype=dt, constant=True, device=dev)
            coef2, st2, g2, sub = A.collapse_to_2d()
            ns = fused.pass_terms(st2, True)
            x = torch.from_numpy(np.random.default_rng(14).standard_normal(A.shape[0])).to(dev, dt)
            kw = dict(stencil=st2, grid=g2, sub=sub)
            y0, sums0, _ = fused.stencil_pass_probe(coef2, x, ns_pass=0, reps=3, **kw)
            same = True
            for split in (False, True):
                y, sums, _ = fused.stencil_pass_probe(coef2, x, ns_pass=ns, split=split, reps=3, **kw)
                same = same and torch.equal(y, y0) and torch.equal(sums, sums0)
            y_ref = stencil.stencil_matvec_2d_reference(coef2, x, **kw)
            err = float((y0 - y_ref).abs().max())
            phase(f"K4 {label} {dt}: NS = {ns}, predicated and split, bitwise the masked pass (NS = 0) "
                  f"over 3 passes: {same}; max |y - y_plain| {err:.3e} ({rel_err(y0, y_ref):.3e} of max |y|, tol "
                  f"{rtol:g})")
            if not (same and rel_err(y0, y_ref) <= rtol):
                raise AssertionError(f"K4 NS = {ns} on {label} {dt} is not the masked pass bitwise or not the plain "
                                     f"stencil")
            if dt != torch.float64 or label not in ("laplace2d(500)", "laplace3d(64)"):
                continue
            plain_ms = cuda_ms(lambda: stencil.stencil_matvec_2d_reference(coef2, x, **kw), reps=20)[0]
            conv_ms = conv2d_yardstick(A, x)[0]
            _, rows, _, _ = fused.resident_bands(g2, st2, sms, fused.MAX_BLOCKS)
            fused.stencil_pass_probe(coef2, x, ns_pass=ns, reps=1_000_000, **kw)  # under a second; the clock meanwhile
            mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                       capture_output=True, text=True, check=True).stdout.split()[0])
            torch.cuda.synchronize()
            clocks = rows * g2[1] * len(st2) * dt.itemsize / SMEM_BYTES_PER_CLOCK
            bnd = (clocks / (mhz * 1e3), "bytes")
            for ns_, split in ((0, False), (ns, False), (ns, True)) if ns == 5 else ((ns, False), (ns, True)):
                def launch(reps):
                    fused.stencil_pass_probe(coef2, x, ns_pass=ns_, split=split, reps=reps, **kw)

                launch(10)  # warm-up
                us = (statistics.median(cuda_ms(lambda: launch(2000))[0] for _ in range(3))
                      - statistics.median(cuda_ms(lambda: launch(200))[0] for _ in range(3))) / 1800 * 1e3
                out[ns_, split] = (err, us * 1e-3, plain_ms, bnd, conv_ms, mhz)
                form = "masked" if ns_ == 0 else "split" if split else "predicated"
                phase(f"K4 NS = {ns_} ({form}) {label} float64: {us:.3f} us a pass (probe, (2000 - 200 passes) / "
                      f"1800, median of 3); plain stencil {plain_ms * 1e3:.3f} us; bound {bnd[0] * 1e3:.3f} us "
                      f"(shared-memory bytes of the largest band, {rows} rows, {len(st2)} loads a point, at "
                      f"{SMEM_BYTES_PER_CLOCK} B a clock and {mhz:.0f} MHz, nvidia-smi during the probe); "
                      f"{'conv2d' if label.startswith('laplace2d') else 'conv3d'} {conv_ms * 1e3:.3f} us a call")
    return out


def degenerate_phase(ops, A_csr, B, fused, fused_kskip, stencil) -> dict:
    """5c. Degenerate systems on the main-path system in float64 (ROADMAP
    queue 3, F1 and F2).  Every method of DEGENERATE_RUNS started at its
    solution (b = A x0 through K1) returns x0 bitwise, converged after at
    most one iteration (Chronopoulos–Gear after none), the fused methods on
    K2/K3/K5/K6's resident route and forced to stream, one launch each; with
    b = 0 every method, on both fused routes and eager, returns x = 0, 0
    iterations and converged, and launches no fused kernel and no K1.  Then
    NRHS right-hand sides with member 3 zero: fused MrR (one K2 launch a
    non-zero member) and eager CG (the K1 launches of the batch without the
    zero member), every other member bitwise the batch without it.
    Returns the fused launches of the warm starts, by wrapper."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch import precond

    A = ops[torch.float64]
    fused_fns = (fused.fused_cg_solve_2d, fused.fused_mrr_solve_2d, fused_kskip.fused_kskipcg_solve_2d,
                 fused_kskip.fused_kskipmrr_solve_2d)
    counted = (stencil.stencil_matvec_2d, *fused_fns)
    bounds = precond.lanczos_bounds(A)
    x0 = torch.from_numpy(np.random.default_rng(23).standard_normal(NX * NX)).to(A.device)
    b_exact, b_zero = A.matvec(x0), torch.zeros_like(x0)
    failures, warm_launches = [], {fn.__name__: 0 for fn in fused_fns}
    for m, k in DEGENERATE_RUNS.items():
        kw = dict(method=m, k=k, tol=TOL, maxiter=MAXITER)
        if m in ("cacg", "camrr"):
            kw["spectral_bounds"] = bounds
        fusable = m in ("cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr")
        for route in (("resident", "streaming", "eager") if fusable else ("eager",)):
            fused.ROUTE = None if route == "eager" else route
            try:
                run = dict(kw, fused=False) if route == "eager" else kw
                before = {fn.__name__: launched(fn).launches for fn in counted}
                before_route = {fn.__name__: getattr(launched(fn), route, 0) for fn in fused_fns}
                x, info = krylov_tpu_torch.solve(A, b_exact, x0=x0, **run)
                warm = {fn.__name__: launched(fn).launches - before[fn.__name__] for fn in fused_fns}
                on_route = sum(getattr(launched(fn), route, 0) - before_route[fn.__name__] for fn in fused_fns)
                for name, v in warm.items():
                    warm_launches[name] += v
                ok_warm = (torch.equal(x, x0) and info["converged"] and info["iterations"] <= (
                    0 if m == "chronopoulos_gear" else 1) and (route == "eager" or on_route == sum(warm.values()) == 1))
                before = {fn.__name__: launched(fn).launches for fn in counted}
                xz, infoz = krylov_tpu_torch.solve(A, b_zero, x0=x0, **run)
                zero_launches = {name: launched(fn).launches - before[name] for name, fn in zip(before, counted)}
            finally:
                fused.ROUTE = None
            ok_zero = (bool((xz == 0).all()) and xz.dtype == x0.dtype and infoz["converged"]
                       and infoz["iterations"] == 0 and list(infoz["residual"]) == [0.0]
                       and not any(zero_launches.values()))
            phase(f"degenerate {m}{f' k={k}' if k else ''} {route}: exact warm start x bitwise x0 "
                  f"{torch.equal(x, x0)}, iterations {info['iterations']}, converged {info['converged']}, fused "
                  f"launches {sum(warm.values())}; b = 0: x = 0 {bool((xz == 0).all())}, iterations "
                  f"{infoz['iterations']}, converged {infoz['converged']}, residual {infoz['residual'].tolist()}, "
                  f"launches {zero_launches}")
            if not (ok_warm and ok_zero):
                failures.append(f"degenerate {m} {route}: warm start ok {ok_warm}, b = 0 ok {ok_zero}")
    Bz = B.clone()
    Bz[3] = 0
    keep = torch.tensor([j for j in range(B.shape[0]) if j != 3], device=B.device)
    tol = torch.tensor(TOL, dtype=B.dtype, device=B.device)
    for m, on_fused, fn in (("mrr", True, fused.fused_mrr_solve_2d), ("cg", False, stencil.stencil_matvec_2d)):
        kw = dict(method=m, tol=tol, maxiter=MAXITER, fused=None if on_fused else False)
        before = launched(fn).launches
        res = krylov_tpu_torch.solve_batched(A, Bz, **kw)
        ran = launched(fn).launches - before
        before = launched(fn).launches
        alone = krylov_tpu_torch.solve_batched(A, B.index_select(0, keep), **kw)
        ran_alone = launched(fn).launches - before
        same = all(torch.equal(res.x[j], alone.x[i]) and int(res.iterations[j]) == int(alone.iterations[i])
                   and torch.equal(res.residual_trace[j, : int(alone.index[i]) + 1],
                                   alone.residual_trace[i, : int(alone.index[i]) + 1])
                   for i, j in enumerate(keep.tolist()))
        zero_ok = (bool((res.x[3] == 0).all()) and int(res.iterations[3]) == 0 and bool(res.converged[3])
                   and float(res.residual_trace[3, 0]) == 0.0)
        true_res = max(true_rel(A_csr, B[j].cpu().numpy(), res.x[j]) for j in keep.tolist())
        phase(f"degenerate batch {m} {'fused' if on_fused else 'eager'}, {B.shape[0]} RHS with member 3 zero: "
              f"iterations {res.iterations.tolist()}, the others bitwise the batch without it {same}, member 3 x = 0 "
              f"and converged at 0 iterations {zero_ok}; {fn.__name__} launches {ran} (batch without member 3: "
              f"{ran_alone}); host f64 true res max {true_res:.3e}")
        if not (same and zero_ok and ran == ran_alone and true_res < TOL
                and (not on_fused or ran == B.shape[0] - 1)):
            failures.append(f"degenerate batch {m}: a zero member changed the batch")
    raise_failures("phase 5c", failures)
    return warm_launches


def main() -> int:
    """:func:`smoke`, then the driver subprocess of phase 15 stopped if it
    still runs (a phase before its check failed) and its directory
    removed."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp()
    started = []
    try:
        return smoke(tmp, started)
    finally:
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def smoke(tmp: str, started: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import numpy as np

    import krylov_tpu_torch
    from krylov_tpu_torch import tracing
    from krylov_tpu_torch.bench import laplace2d_csr_f64
    from krylov_tpu_torch.kernels import _build, fused, fused_kskip, stencil
    from krylov_tpu_torch.sparse import fixtures

    dev = torch.device("cuda")
    f64, f32 = torch.float64, torch.float32

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phase(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    mark("2 build")
    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.nvcc()}, {' '.join(_build.FLAGS)})")

    mark("15 cli and 19 examples, started")
    cli_run = start_cli(tmp)
    started.append(cli_run[0])
    example_runs = start_examples()
    started.extend(proc for proc, _ in example_runs.values())

    mark("3 K1")
    # 3. K1 against its plain version, on the main-path grid in both forms,
    # a collapsed 3-D grid, uneven grids whose rows do not divide into K1's
    # segments, and (8, n) blocks in one launch, member by member
    k1_err = None
    for make, label in (
        (lambda dt: fixtures.laplace2d(NX, dtype=dt, device=dev), "laplace2d(500)"),
        (lambda dt: fixtures.laplace2d(NX, dtype=dt, constant=True, device=dev), "laplace2d(500, constant)"),
        (lambda dt: fixtures.laplace3d(64, dtype=dt, constant=True, device=dev), "laplace3d(64, constant)"),
        (lambda dt: fixtures.laplace2d(NX + 3, NX - 7, dtype=dt, device=dev), "laplace2d(503, 493)"),
        (lambda dt: fixtures.laplace2d(NX + 1, NX + 5, dtype=dt, constant=True, device=dev),
         "laplace2d(501, 505, constant)"),
    ):
        for dt, rtol in ((f64, 1e-12), (f32, 1e-5)):
            A = make(dt)
            coef2, st2, g2, sub = A.collapse_to_2d()
            x = torch.from_numpy(np.random.default_rng(11).standard_normal(A.shape[0])).to(dev, dt)
            y = stencil.stencil_matvec_2d(coef2, x, stencil=st2, grid=g2, sub=sub)
            y_ref = stencil.stencil_matvec_2d_reference(coef2, x, stencil=st2, grid=g2, sub=sub)
            err = rel_err(y, y_ref)
            phase(f"K1 {label} {dt}: max rel err {err:.3e} (tol {rtol:g})")
            if not err <= rtol:
                raise AssertionError(f"K1 disagrees with its plain version on {label} {dt}")
            if label == "laplace2d(500, constant)" and dt == f64:
                k1_err = float((y - y_ref).abs().max())
            if label in ("laplace2d(500, constant)", "laplace2d(503, 493)"):
                X = torch.from_numpy(np.random.default_rng(15).standard_normal((8, A.shape[0]))).to(dev, dt)
                Y = stencil.stencil_matvec_2d(coef2, X, stencil=st2, grid=g2, sub=sub)
                err = max(rel_err(Y[j], stencil.stencil_matvec_2d_reference(coef2, X[j], stencil=st2, grid=g2,
                                                                            sub=sub)) for j in range(8))
                phase(f"K1 {label} {dt}, (8, n) block in one launch: max rel err over the members {err:.3e} "
                      f"(tol {rtol:g})")
                if not err <= rtol:
                    raise AssertionError(f"K1 on an (8, n) block disagrees with its plain version on {label} {dt}")

    mark("3b K4")
    k4 = k4_phase(dev)
    k4_launches = dict.fromkeys(K4_PASSES, 0)  # resident launches by K4's specialisation, phases 4, 4b, 5, 5b

    mark("4 K2/K3 small")
    # 4. K2/K3 against their plain versions on small grids, float64, on the
    # resident route; each system's launches take K4's specialisation for
    # its geometry (the masked pass for the grid form)
    k23 = (fused.fused_cg_solve_2d, fused.fused_mrr_solve_2d)
    reset(k23)
    for make, label, ns in (
        (lambda: fixtures.laplace2d(64, device=dev), "laplace2d(64)", 0),
        (lambda: fixtures.laplace2d(64, constant=True, device=dev), "laplace2d(64, constant)", 5),
        (lambda: fixtures.laplace3d(16, constant=True, device=dev), "laplace3d(16, constant)", 7),
    ):
        before = pass_counts(k23)
        A = make()
        coef2, st2, g2, sub = A.collapse_to_2d()
        b = torch.from_numpy(np.random.default_rng(12).standard_normal(A.shape[0])).to(dev)
        b_norm = torch.linalg.vector_norm(b)
        kw = dict(stencil=st2, grid=g2, maxiter=A.shape[0], sub=sub)
        for m, kern, plain in (("cg", fused.fused_cg_solve_2d, fused.fused_cg_solve_2d_reference),
                               ("mrr", fused.fused_mrr_solve_2d, fused.fused_mrr_solve_2d_reference)):
            p = fused.device_plan(m, g2, st2, f64)
            compare_solves(f"K{'3' if m == 'cg' else '2'} {m} {label} f64 ({p.route}, {p.blocks} blocks)",
                           kern(coef2, b, 1e-8, b_norm, **kw), plain(coef2, b, 1e-8, b_norm, **kw),
                           **TOLS["float64"])
        for d in check_passes(f"K2/K3 {label}", k23, before, ns).values():
            k4_launches[ns] += d[ns] if ns != 5 else 0  # NS = 5's count is the main path's (5, 5b)
    if any(res < 3 or stream for res, stream in route_counts(k23).values()):
        raise AssertionError(f"phase 4 did not run K2/K3 on the resident route: {route_counts(k23)}")

    mark("4b K5/K6 small")
    # 4b. K5/K6 on both routes against one run of their plain versions on
    # small grids, two seeds: whole solves in float64, and in float32 at
    # k <= 2; the float32 k = 4 solves over their first outer iteration
    # against the float64 plain version; then the adaptive rollback case in
    # both
    kernel_id = {"kskipcg": "K6", "kskipmrr": "K5", "adaptivekskipmrr": "K5 adaptive"}
    k56 = (fused_kskip.fused_kskipcg_solve_2d, fused_kskip.fused_kskipmrr_solve_2d)
    reset(k56)
    failures = []
    for dt, tol in ((f64, 1e-8), (f32, 1e-5)):
        name = str(dt).removeprefix("torch.")
        for make, label, ns in (
            (lambda: fixtures.laplace2d(64, dtype=dt, device=dev), "laplace2d(64)", 0),
            (lambda: fixtures.laplace2d(64, dtype=dt, constant=True, device=dev), "laplace2d(64, constant)", 5),
            (lambda: fixtures.laplace3d(16, dtype=dt, constant=True, device=dev), "laplace3d(16, constant)", 7),
        ):
            before = pass_counts(k56)
            A = make()
            for seed in (12, 13):
                b = torch.from_numpy(np.random.default_rng(seed).standard_normal(A.shape[0])).to(dev, dt)
                for m, k in (("kskipcg", 1), ("kskipcg", 4), ("kskipmrr", 2), ("kskipmrr", 4),
                             ("adaptivekskipmrr", 4)):
                    first = dt == f32 and k >= 4
                    maxiter = first_outer(m, k, 1) if first else A.shape[0]
                    want = kskip_call(m, k, A, b, tol, maxiter, plain=True, plain64=first)
                    for route, (_, got) in kskip_routes(m, k, A, b, tol, maxiter).items():
                        held(failures, compare_kskip, f"{kernel_id[m]} {route} {m} k={k} {label} {name} seed {seed}"
                             + (f", maxiter {maxiter} against float64" if first else ""),
                             got, want, **KSKIP_SMALL_TOLS[name, k])
            for d in (held(failures, check_passes, f"K5/K6 {label} {name}", k56, before, ns) or {}).values():
                k4_launches[ns] += d[ns] if ns != 5 else 0
        adv = advection(dev)
        A = type(adv)(adv.coef.to(dt), adv.stencil, adv.grid)
        for seed in (3, 4):
            b = torch.from_numpy(np.random.default_rng(seed).standard_normal(A.shape[0])).to(dev, dt)
            want = kskip_call("adaptivekskipmrr", 6, A, b, tol, 2000, plain=True)
            for route, (_, got) in kskip_routes("adaptivekskipmrr", 6, A, b, tol, 2000).items():
                held(failures, compare_kskip, f"K5 adaptive {route} rollback, advection 16x16 k=6 {name} seed {seed}",
                     got, want, **KSKIP_SMALL_TOLS[name, "rollback"])
                if not (int(got[7]) < 6 and int(want[7]) < 6):
                    failures.append(f"the advection case did not roll back ({route}, {name}, seed {seed})")
    raise_failures("phase 4b", failures)

    A_csr = laplace2d_csr_f64(NX)
    mark("15 cli")
    cli_phase(cli_run, A_csr)
    mark("19 examples")
    ex = examples_phase(example_runs, torch.cuda.device_count())

    mark("5 main path")
    # 5. the main path through solve(), counters from this run only
    b_np = np.random.default_rng(0).standard_normal(NX * NX)
    runs = [("mrr", f64), ("cg", f64), ("mrr", f32), ("cg", f32)]
    ops = {dt: fixtures.laplace2d(NX, dtype=dt, constant=True, device=dev) for dt in (f64, f32)}
    counted = (stencil.stencil_matvec_2d, fused.fused_mrr_solve_2d, fused.fused_cg_solve_2d)
    reset(counted)
    results = {}
    for m, dt in runs:
        results[m, dt] = krylov_tpu_torch.solve(ops[dt], b_np, method=m, tol=TOL, maxiter=MAXITER)
    # warm start: polish the float32 MrR answer in float64 (K1 forms b - A x0)
    x0_np = results["mrr", f32][0].double().cpu().numpy()
    results["mrr warm", f64] = krylov_tpu_torch.solve(ops[f64], b_np, method="mrr", x0=x0_np,
                                                      tol=TOL, maxiter=MAXITER)
    check_launched("main path", counted)
    for d in check_passes("main path K2/K3", counted[1:], {f.__name__: dict.fromkeys(K4_PASSES, 0)
                                                           for f in counted[1:]}, 5).values():
        k4_launches[5] += d[5]
    for m, k in DIGEST_RUNS[:2]:
        for dt in (f64, f32):
            phase(digest_line(f"{m} {dt}", *results[m, dt]))
    routes = route_counts(counted[1:])
    phase(f"main path K2/K3 launches by route (resident, streaming): {routes}")
    if any(res < 1 or stream for res, stream in routes.values()):
        raise AssertionError(f"the main path did not run K2/K3 on the resident route alone: {routes}")

    refs = {"mrr": numpy_mrr(A_csr, b_np, TOL, MAXITER), "cg": numpy_cg(A_csr, b_np, TOL, MAXITER),
            "mrr warm": numpy_mrr(A_csr, b_np, TOL, MAXITER, x0=x0_np)}
    b_nrm = np.linalg.norm(b_np)
    summary = {}
    for (m, dt), (x, info) in results.items():
        x64 = x.double().cpu().numpy()
        true_res = float(np.linalg.norm(b_np - A_csr @ x64) / b_nrm)
        if not np.all(np.isfinite(x64)) or x64.shape != (NX * NX,):
            raise AssertionError(f"solve {m} {dt}: x not finite or of the wrong shape")
        ref_iters, ref_hist = refs[m]
        phase(f"solve {m} {dt}: iters {info['iterations']} (numpy f64 ref {ref_iters}), "
              f"converged {info['converged']}, recurred res {info['residual'][-1]:.6e}, "
              f"true res {true_res:.6e}, solve() wall {info['time'] * 1e3:.3f} ms")
        summary[m, dt] = info["iterations"]
        if dt == f64:
            if info["iterations"] != ref_iters:
                k = min(info["iterations"], ref_iters)
                phase(f"  residuals near the crossing: port {info['residual'][k - 1:k + 2]}, "
                      f"ref {ref_hist[k - 1:k + 2]}")
                raise AssertionError(f"{m} f64 took {info['iterations']} iterations, the reference {ref_iters}")
            if not (info["converged"] and true_res < TOL):
                raise AssertionError(f"{m} f64 did not converge to the true residual (true {true_res:.3e})")

    mark("5b k-skip path")
    # 5b. the k-skip path through solve(), counters from this run only
    counted_k = (fused_kskip.fused_kskipcg_solve_2d, fused_kskip.fused_kskipmrr_solve_2d)
    reset(counted_k)
    kres = {}
    for dt in (f64, f32):
        for m, k in KSKIP_RUNS.items():
            kres[m, dt] = krylov_tpu_torch.solve(ops[dt], b_np, method=m, k=k, tol=TOL, maxiter=MAXITER)
    check_launched("k-skip path", counted_k)
    for d in check_passes("k-skip path K5/K6", counted_k, {f.__name__: dict.fromkeys(K4_PASSES, 0)
                                                            for f in counted_k}, 5).values():
        k4_launches[5] += d[5]
    for m, k in DIGEST_RUNS[2:]:
        for dt in (f64, f32):
            phase(digest_line(f"{m} {dt}", *kres[m, dt]))
    kroutes = route_counts(counted_k)
    phase(f"k-skip path K5/K6 launches by route (resident, streaming): {kroutes}")
    if any(res < 1 or stream for res, stream in kroutes.values()):
        raise AssertionError(f"the k-skip path did not run K5/K6 on the resident route alone: {kroutes}")
    # the eager loops on the card: an independent second route, float64; in
    # float32 printed only, also with float64 inner products
    for m, k in KSKIP_RUNS.items():
        for label, dt, sdt in ((" eager", f64, None), (" eager", f32, None), (" eager f64 sums", f32, f64)):
            kres[m + label, dt] = krylov_tpu_torch.solve(ops[dt], b_np, method=m, k=k, tol=TOL, maxiter=MAXITER,
                                                         fused=False, scalar_dtype=sdt)
    ksummary = {}
    for (m, dt), (x, info) in kres.items():
        x64 = x.double().cpu().numpy()
        true_res = float(np.linalg.norm(b_np - A_csr @ x64) / b_nrm)
        if x64.shape != (NX * NX,):
            raise AssertionError(f"solve {m} {dt}: x of the wrong shape")
        outer = len(info["residual"]) - 1
        kh = info.get("khistory")
        extra = "" if kh is None else f", final k {info['final_k']}, rolled back: {bool((kh < kh[0]).any())}"
        phase(f"solve {m} {dt}: iters {info['iterations']}, outer {outer}, converged {info['converged']}, "
              f"recurred res {info['residual'][-1]:.6e}, true res {true_res:.6e}{extra}, "
              f"solve() wall {info['time'] * 1e3:.3f} ms")
        ksummary[m, dt] = info["iterations"]
        if dt != f64:
            continue
        base = m.removesuffix(" eager")
        if (info["iterations"], outer) != KSKIP_F64[base]:
            phase(f"  residuals near the crossing: {info['residual'][-4:]}")
            raise AssertionError(f"{m} f64: {info['iterations']} iterations, {outer} outer; "
                                 f"the JAX package gives {KSKIP_F64[base]}")
        if not (info["converged"] and np.all(np.isfinite(x64)) and true_res < TOL):
            raise AssertionError(f"{m} f64 did not converge to the true residual (true {true_res:.3e})")
        if base == "adaptivekskipmrr" and info["final_k"] != KSKIP_RUNS[base]:
            raise AssertionError(f"{m} f64 ended at k {info['final_k']}, the JAX package at 8")

    mark("5c degenerate systems")
    B21 = torch.from_numpy(np.random.default_rng(21).standard_normal((NRHS, NX * NX))).to(dev)
    degenerate_phase(ops, A_csr, B21, fused, fused_kskip, stencil)

    mark("6 K2/K3 timed")
    # 6. K2/K3 against their plain versions at the main-path shape, timed:
    # median of 3 fresh b
    ms, k23_err, k23_bound = {}, {}, {}
    for dt in (f64, f32):
        coef2, st2, g2, sub = ops[dt].collapse_to_2d()
        kw = dict(stencil=st2, grid=g2, maxiter=MAXITER, sub=sub)
        for m, kern, plain in (("mrr", fused.fused_mrr_solve_2d, fused.fused_mrr_solve_2d_reference),
                               ("cg", fused.fused_cg_solve_2d, fused.fused_cg_solve_2d_reference)):
            t_k, t_p, errs, bounds = [], [], [], []
            name = str(dt).removeprefix("torch.")
            for seed in (1, 2, 3):
                b = torch.from_numpy(np.random.default_rng(seed).standard_normal(NX * NX)).to(dev, dt)
                b_norm = torch.linalg.vector_norm(b)
                tp, want = cuda_ms(lambda: plain(coef2, b, TOL, b_norm, **kw))
                tk, got = cuda_ms(lambda: kern(coef2, b, TOL, b_norm, **kw))
                t_p.append(tp)
                t_k.append(tk)
                errs.append(compare_solves(f"K{'3' if m == 'cg' else '2'} {m} laplace2d({NX}, constant) "
                                           f"{dt} seed {seed}", got, want, **TOLS[name]))
                bounds.append(bound(fused_flops(m, ops[dt].nnz, NX * NX, int(got[2])),
                                    2 * NX * NX * dt.itemsize, name))
            ms[m, dt] = (statistics.median(t_k), statistics.median(t_p))
            k23_err[m, dt] = max(errs)
            k23_bound[m, dt] = sorted(bounds)[1]
            p = fused.device_plan(m, g2, st2, dt)
            phase(f"time-to-solution {m} {dt} N={NX * NX}: kernel {ms[m, dt][0]:.3f} ms, "
                  f"plain {ms[m, dt][1]:.3f} ms (median of 3, CUDA events; "
                  f"{summary[m, dt]} iterations on seed 0); {p.route} route, {p.blocks} blocks of {p.threads} "
                  f"threads, {p.ppt} points a thread; bound {k23_bound[m, dt][0]:.3f} ms ({k23_bound[m, dt][1]})")
    spmv, conv = {}, {}
    for dt in (f64, f32):
        coef2, st2, g2, sub = ops[dt].collapse_to_2d()
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(NX * NX)).to(dev, dt)
        kw = dict(stencil=st2, grid=g2, sub=sub)
        stencil.stencil_matvec_2d(coef2, x, **kw)  # warm-up
        t_k = cuda_ms(lambda: stencil.stencil_matvec_2d(coef2, x, **kw), reps=200)[0]
        t_p = cuda_ms(lambda: stencil.stencil_matvec_2d_reference(coef2, x, **kw), reps=20)[0]
        host = {"stencil_matvec_2d": host_us(lambda: stencil.stencil_matvec_2d(coef2, x, **kw)),
                "StencilMatrix.matvec": host_us(lambda: ops[dt].matvec(x)),
                "a bare torch launch (x * 2.0)": host_us(lambda: x * 2.0)}
        k1_us = device_us(lambda: stencil.stencil_matvec_2d(coef2, x, **kw), "stencil2d_kernel", 50)
        # K1's one-call yardstick, conv2d of the same stencil
        conv[dt] = conv2d_yardstick(ops[dt], x)
        c_ms, c_us, err = conv[dt]
        bnd = bound(2 * ops[dt].nnz, 2 * NX * NX * dt.itemsize, str(dt).removeprefix("torch."))
        spmv[dt] = (t_k, t_p, k1_us)
        phase(f"K1 SpMV {dt} N={NX * NX}: host " + ", ".join(f"{k} {v:.3f} us" for k, v in host.items())
              + f" a call (host clock over 1000 calls); {t_k * 1e3:.3f} us a call (CUDA events over 200 calls, "
              f"{ops[dt].nnz / (t_k * 1e-3) / 1e9:.3f} Gnnz/s); device {us_text(k1_us)} "
              f"(torch.profiler); bound {bnd[0] * 1e3:.3f} us ({bnd[1]}); plain {t_p * 1e3:.3f} us a call; conv2d "
              f"{us_text(c_us)} device, {c_ms * 1e3:.3f} us a call (CUDA events, cuDNN TF32 off), "
              f"max |y_conv - y_K1| / max |y_K1| {err:.3e}")
        if not err <= (1e-12 if dt == f64 else 1e-5):
            raise AssertionError(f"conv2d and K1 disagree on the same stencil ({dt})")

    mark("6b K5/K6 timed")
    # 6b. K5/K6 against one run of their plain versions at the main-path
    # shape: the resident route on SEEDS, timed as the median over them,
    # the plain version too, and the streaming route on SEEDS[0]; static
    # k-skip MrR k=8 stands beside adaptive k=8 as a witness that the gap
    # comes from k.  Then the whole float32 solves that are not held (see
    # KSKIP_FULL), printed side by side, and the device time of each
    # route's kernel.
    kms, kerr, kouter, failures = {}, {}, {}, []
    for (m, k, name), tols in KSKIP_FULL.items():
        dt = getattr(torch, name)
        first = dt == f32 and k >= 4
        maxiter = first_outer(m, k, 1) if first else MAXITER
        t_k, t_p, errs = {r: [] for r in KSKIP_ROUTES}, [], {r: [] for r in KSKIP_ROUTES}
        for seed in SEEDS:
            b = torch.from_numpy(np.random.default_rng(seed).standard_normal(NX * NX)).to(dev, dt)
            got = {}
            seed_routes = KSKIP_ROUTES if seed == SEEDS[0] else ("resident",)
            for route, (tk, out) in kskip_routes(m, k, ops[dt], b, TOL, maxiter, seed_routes).items():
                t_k[route].append(tk)
                got[route] = out
            tp, want = cuda_ms(lambda: kskip_call(m, k, ops[dt], b, TOL, maxiter, plain=True, plain64=first))
            t_p.append(tp)
            kouter.setdefault((m, k, name), []).append(int(got["resident"][6]))
            for route in seed_routes:
                err = held(failures, compare_kskip,
                           f"{kernel_id[m]} {route} {m} k={k} laplace2d({NX}, constant) {name} seed {seed}"
                           + (f", maxiter {maxiter} against float64" if first else ""), got[route], want, **tols)
                if err is not None:
                    errs[route].append(err)
        for route in KSKIP_ROUTES:
            kms[m, k, name, route] = statistics.median(t_k[route])
            kerr[m, k, name, route] = max(errs[route], default=float("nan"))
        kms[m, k, name, "plain"] = statistics.median(t_p)
        p = fused_kskip.device_plan(m.removeprefix("adaptive"), ops[dt].grid, ops[dt].stencil, dt, max(k, 1))
        fused.ROUTE = "streaming"
        try:
            blocks = fused_kskip.device_plan(m.removeprefix("adaptive"), ops[dt].grid, ops[dt].stencil, dt,
                                             max(k, 1)).blocks
        finally:
            fused.ROUTE = None
        bnd = bound(kskip_flops(m, k, ops[dt].nnz, NX * NX, statistics.median(kouter[m, k, name])),
                    2 * NX * NX * dt.itemsize, name)
        phase(f"time-to-solution {m} k={k} {name} N={NX * NX}" + (f" maxiter {maxiter}" if first else "")
              + ": " + ", ".join(f"{r} {kms[m, k, name, r]:.3f} ms" for r in (*KSKIP_ROUTES, "plain"))
              + f" (resident and plain: median over seeds {SEEDS}, streaming: seed {SEEDS[0]}; CUDA events; "
              f"outer iterations {kouter[m, k, name]}); bound {bnd[0]:.3f} ms ({bnd[1]}); plan: {p.route}, "
              f"{p.blocks} bands of <= {p.rows} rows, {p.ppt} points a thread of {p.threads}, {p.smem} bytes of "
              f"shared memory a block; streaming grid {blocks} blocks of 256 threads")
    raise_failures("phase 6b", failures)
    for m, k in (("kskipcg", 4), ("kskipmrr", 4), ("adaptivekskipmrr", 8)):
        for seed in SEEDS:
            b = torch.from_numpy(np.random.default_rng(seed).standard_normal(NX * NX)).to(dev, f32)
            runs = kskip_routes(m, k, ops[f32], b, TOL, MAXITER)
            last = fused_kskip.trace_length(MAXITER) - 1
            texts = []
            for r, (ms_, (_, t, _, _, i, c, idx, f)) in runs.items():
                bnd = bound(kskip_flops(m, k, ops[f32].nnz, NX * NX, int(idx)), 2 * NX * NX * 4, "float32")
                texts.append(f"{r} {ms_:.3f} ms, {int(i)} iterations, {int(idx)} outer, conv {bool(c)}, recurred "
                             f"res {float(t[min(int(idx), last)]):.6e}" + ("" if f is None else f", final k {int(f)}")
                             + f", bound {bnd[0]:.3f} ms")
            phase(f"  float32 whole solve, not held: {m} k={k} seed {seed} (CUDA events; bound from the outer "
                  f"iterations): " + "; ".join(texts))
    b64 = torch.from_numpy(np.random.default_rng(SEEDS[-1]).standard_normal(NX * NX)).to(dev)
    kernel_names = {"resident": "_resident_kernel", "streaming": "_fused_kernel"}
    for m, k in KSKIP_RUNS.items():
        us = {}
        for route in KSKIP_ROUTES if m in ("kskipcg", "kskipmrr") else ("resident",):
            fused.ROUTE = route
            try:
                us[route] = device_us(lambda: kskip_call(m, k, ops[f64], b64, TOL, MAXITER),
                                      m.removeprefix("adaptive") + kernel_names[route], 3)
            finally:
                fused.ROUTE = None
        phase(f"device time {m} k={k} float64 (torch.profiler, mean of 3 solves, seed {SEEDS[-1]}): "
              + ", ".join(f"{r} {us_text(v)}" for r, v in us.items()))

    # kernel time alone, from the profiler: a K1 call through the wrapper
    # costs host time too, and K2/K3 add the wrapper's few small launches
    for dt in (f64, f32):
        coef2, st2, g2, sub = ops[dt].collapse_to_2d()
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(NX * NX)).to(dev, dt)
        b_norm = torch.linalg.vector_norm(x)
        us = {
            "K1 stencil2d_kernel": device_us(
                lambda: stencil.stencil_matvec_2d(coef2, x, stencil=st2, grid=g2, sub=sub), "stencil2d_kernel", 50),
            "K2 mrr_resident_kernel": device_us(
                lambda: fused.fused_mrr_solve_2d(coef2, x, TOL, b_norm, stencil=st2, grid=g2, maxiter=MAXITER, sub=sub),
                "mrr_resident_kernel", 3),
            "K3 cg_resident_kernel": device_us(
                lambda: fused.fused_cg_solve_2d(coef2, x, TOL, b_norm, stencil=st2, grid=g2, maxiter=MAXITER, sub=sub),
                "cg_resident_kernel", 3),
        }
        plans = {m: fused.device_plan(m, g2, st2, dt) for m in ("mrr", "cg")}
        phase(f"device time {dt} (torch.profiler, b = x of seed 13): " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.3f} us'}" for k, v in us.items())
            + "; grids: " + ", ".join(f"{m} {p.route} {p.blocks} x {p.threads}" for m, p in plans.items()))

    mark("6c K2/K3 streaming")
    stream = streaming(dev, fused, stencil)
    mark("6d k-skip path streaming")
    kstream = kskip_streaming(ops[f64], b_np, A_csr, fused, fused_kskip)
    mark("6e row 5")
    row5 = row5_phase(dev, fused_kskip, stencil)
    mark("6f row 5 cg/mrr")
    row5_k23 = row5_k23_phase(dev, fused, stencil)
    mark("7 fidelity")
    fidelity(ops, b_np, A_csr, fused, stencil)
    mark("8-9 irregular and batched")
    hyb = irregular_system(dev)
    batched(ops, hyb, dev, fused)
    irregular(hyb, dev)
    mark("10 row 4b")
    row4b(dev)
    mark("11 preconditioned, pipelined and CA")
    k1_launches, unbroken = preconditioned(ops, b_np, A_csr, stencil)
    unbroken.update({(m, k): kres[m + " eager", f64] for m, k in KSKIP_RUNS.items()})
    mark("11b Chebyshev step")
    cheb = chebyshev_step_phase(ops, stencil)
    mark("11c pcg steps")
    pcg_steps = pcg_steps_phase(ops)
    mark("12 chunked")
    chunk_launches = chunked(ops[f64], b_np, A_csr, fused, fused_kskip, stencil, unbroken)
    mark("13 checkpoint")
    ckpt_launches = checkpoint_phase(ops[f64], b_np, A_csr, fused_kskip)
    mark("14 batched k-skip")
    k1_launches += chunk_launches["K1"] + batched_kskip(ops[f64], A_csr, hyb, dev, stencil)
    mark("17 batched eager")
    k1_launches += batched_eager(ops, A_csr, B21, stencil)
    mark("16 sharded")
    fixup_on_card(ops, stencil)
    k1_launches += sharded_phase(ops, b_np, A_csr, hyb, tmp, stencil, B21)
    mark("18 profiling")
    prof = profiling_run(tmp)
    mark("20 bench")
    bench_phase(spmv[f64][2])
    mark("done")

    # the k-skip bounds for the timed solves (the median of their outer
    # iteration counts over SEEDS)
    kbound = {m: bound(kskip_flops(m, 4, ops[f64].nnz, NX * NX, statistics.median(kouter[m, 4, "float64"])),
                       2 * NX * NX * 8, "float64") for m in ("kskipmrr", "kskipcg")}
    k1_bound = bound(2 * ops[f64].nnz, 2 * NX * NX * 8, "float64")

    def entry(name, source, replaces, launches, err, ms_, plain_ms, bnd, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    res_src, str_src = "krylov_tpu_torch/kernels/csrc/fused_resident.cu", "krylov_tpu_torch/kernels/csrc/fused.cu"
    def more(fn, route):
        """The launches of phases 18 (K2, K1) and 19 (the examples' processes)
        on ``route`` (0 resident, 1 streaming) of the wrapper ``fn``."""
        p = prof.get(fn, 0)
        return (p[route] if isinstance(p, list) else p) + ex.get(fn, [0, 0])[route]

    kernels = [
        # K1's launches: those of the eager paths it carries, phases 11, 12,
        # 14, 16 and 17 and the examples of 19 (the fused main path of phase
        # 5 launched it for the warm start alone, phase 18 for its warm
        # trace); each path's counts run from 0, and the resident K2/K3/K5
        # entries add the fused chunks of phase 12 (K5 also the resume of
        # phase 13), the traced and timed solves of phase 18 (K2) and the
        # examples of phase 19 to the main path's launches
        entry("stencil_matvec_2d", "krylov_tpu_torch/kernels/csrc/stencil.cu", "krylov_tpu/kernels/stencil.py:89",
              k1_launches + more("stencil_matvec_2d", 0), k1_err, spmv[f64][0], spmv[f64][1], k1_bound,
              conv[f64][0]),
        entry("fused_mrr_solve_2d resident", res_src, "krylov_tpu/kernels/fused.py:344",
              routes["fused_mrr_solve_2d"][0] + chunk_launches["fused_mrr_solve_2d"] + more("fused_mrr_solve_2d", 0),
              k23_err["mrr", f64], ms["mrr", f64][0], ms["mrr", f64][1], k23_bound["mrr", f64]),
        dict(entry("fused_mrr_solve_2d streaming", str_src, "krylov_tpu/kernels/fused.py:344",
                   stream["mrr"][0] + row5_k23["mrr"] + more("fused_mrr_solve_2d", 1), stream["mrr"][1],
                   stream["mrr"][2], stream["mrr"][3], stream["mrr"][4]),
             shape=f"laplace2d({NX_STREAM}, constant) float64, {MAXITER_STREAM} iterations, "
                   "{} form on {}".format(*fused.stream_shape("mrr", 5, f64)), sweep_bytes_bound_ms=stream["mrr"][5]),
        entry("fused_cg_solve_2d resident", res_src, "krylov_tpu/kernels/fused.py:259",
              routes["fused_cg_solve_2d"][0] + chunk_launches["fused_cg_solve_2d"] + more("fused_cg_solve_2d", 0),
              k23_err["cg", f64], ms["cg", f64][0], ms["cg", f64][1], k23_bound["cg", f64]),
        dict(entry("fused_cg_solve_2d streaming", str_src, "krylov_tpu/kernels/fused.py:259",
                   stream["cg"][0] + row5_k23["cg"] + more("fused_cg_solve_2d", 1), stream["cg"][1], stream["cg"][2],
                   stream["cg"][3], stream["cg"][4]),
             shape=f"laplace2d({NX_STREAM}, constant) float64, {MAXITER_STREAM} iterations, "
                   "{} form on {}".format(*fused.stream_shape("cg", 5, f64)), sweep_bytes_bound_ms=stream["cg"][5]),
    ]
    # the Chebyshev step: its launches in every phase and process (phase
    # 11b's, the Chebyshev-preconditioned solves of 11, 17 and 18, the
    # examples of 19); its error and times phase 11b's, against the loop
    # it replaces, on the float64 vector
    err, ms_, plain_ms, bnd, timed_by = cheb
    kernels.append(dict(entry("chebyshev_apply (the Chebyshev step)", "krylov_tpu_torch/kernels/csrc/stencil.cu",
                              "krylov_tpu/precond.py:188 (ChebyshevPreconditioner.matvec: no TPU kernel)",
                              launched(stencil.chebyshev_apply).launches + more("chebyshev_apply", 0), err, ms_,
                              plain_ms, bnd),
                        shape=f"laplace2d({NX}, constant) float64, degree 6, (n,)", timed_by=timed_by))
    # pcg's four step kernels: their launches since phase 11 set them to 0
    # (its solves and timing, 11c's, the batched pcg of 17) and those of the
    # processes of phases 18 and 19; their errors and times phase 11c's,
    # against the same steps on torch's passes, on the float64 vector
    elsewhere = [a + b for a, b in zip(prof.get("pcg_launches", [0] * 4), ex.get("pcg_launches", [0] * 4))]
    for j, (step, (err, ms_, plain_ms, bnd, timed_by)) in enumerate(pcg_steps.items()):
        kernels.append(dict(entry(f"pcg_{step}_kernel (kernels.pcg.step_{step})", "krylov_tpu_torch/kernels/csrc/pcg.cu",
                                  "krylov_tpu/solvers/pipelined.py:86 (pcg_kernel's body: XLA's fusions, no TPU "
                                  "kernel)", getattr(tracing.totals.pcg_launches, step) + elsewhere[j], err, ms_,
                                  plain_ms, bnd),
                            shape=f"laplace2d({NX}, constant) float64, (n,)", timed_by=timed_by))
    kskip_src = {"resident": "krylov_tpu_torch/kernels/csrc/fused_kskip_resident.cu",
                 "streaming": "krylov_tpu_torch/kernels/csrc/fused_kskip.cu"}
    for m, fn, line, witness in (("kskipmrr", "fused_kskipmrr_solve_2d", 528, ("adaptivekskipmrr", 8)),
                                 ("kskipcg", "fused_kskipcg_solve_2d", 629, ("kskipcg", 4))):
        launches = kroutes[fn][0] + more(fn, 0)
        if fn == "fused_kskipmrr_solve_2d":  # the fused chunks and the resume
            launches += chunk_launches[fn] + ckpt_launches
        err = max(kerr[m, 4, "float64", "resident"], kerr[(*witness, "float64", "resident")])
        kernels.append(entry(f"{fn} resident", kskip_src["resident"], f"krylov_tpu/kernels/fused_kskip.py:{line}",
                             launches, err, kms[m, 4, "float64", "resident"], kms[m, 4, "float64", "plain"],
                             kbound[m]))
        # the streaming route: launched by phases 6d and 6e (row 5, K5), timed
        # and held against its plain version on laplace3d(ROW5_MID) in float64
        # (the witness), its bound beside that of its sweeps' bytes model
        err, ms_, plain_ms, outer, nnz, n = row5["mid"][witness]
        launches = kstream[fn] + more(fn, 1) + (row5["launches"][1] if m == "kskipmrr" else 0)
        sweeps = outer * kskip_sweep_words(m, witness[1], witness[0] == "adaptivekskipmrr") * n * 8 / PEAK_BYTES * 1e3
        kernels.append(dict(entry(f"{fn} streaming", kskip_src["streaming"], f"krylov_tpu/kernels/fused_kskip.py:{line}",
                                  launches, err, ms_, plain_ms, bound(kskip_flops(witness[0], witness[1], nnz, n, outer),
                                                                      2 * n * 8, "float64")),
                            shape=f"{witness[0]} k={witness[1]} laplace3d({ROW5_MID}, constant) float64",
                            sweep_bytes_bound_ms=sweeps))
    # K4's streaming form inside K5/K6 (csrc/stencil.cuh StreamSweep): its
    # launches are the streaming K5/K6 launches that took the pass
    # specialised on 7 terms, the row-5 path's (phase 6e) and the mid-size
    # checks'; its time the probe's µs a pass at row 5 in float64 (phase 6e)
    err, ms_, plain_ms, bnd, conv_ms = row5["pass"]
    kernels.append(dict(entry("stream_pass NS=7 (K4's streaming form, the pass of streaming K5/K6)",
                              "krylov_tpu_torch/kernels/csrc/stencil.cuh", "krylov_tpu/kernels/fused.py:47",
                              row5["launches_ns7"], err, ms_, plain_ms, bnd, conv_ms),
                        shape=f"laplace3d({ROW5_NX}, constant) float64, one pass"))
    # K4, the resident stencil pass inside K2/K3/K5/K6, by specialisation:
    # its launches are the resident launches that took it (NS = 5: the main
    # path, phases 5 and 5b; 7 and 0: the collapsed 3-D and grid-form
    # systems of phases 4 and 4b); its times are phase 3b's probe, a pass
    # over the main-path plan (NS = 5, 0) or laplace3d(64) (NS = 7), in the
    # predicated form (the float64 main path's K2/K3/K6 take it; phase 3b
    # prints the others), and its bound the shared-memory bytes of a pass,
    # where its operands are
    for ns in (5, 7, 0):
        err, ms_, plain_ms, bnd, conv_ms, mhz = k4[ns, False]
        kernels.append(dict(entry(f"stencil_pass NS={ns} (K4, the resident pass of K2/K3/K5/K6)",
                                  "krylov_tpu_torch/kernels/csrc/resident.cuh", "krylov_tpu/kernels/fused.py:47",
                                  k4_launches[ns], err, ms_, plain_ms, bnd, conv_ms),
                            bound_of=f"shared-memory bytes of the largest band at {SMEM_BYTES_PER_CLOCK} B a clock "
                                     f"and {mhz:.0f} MHz"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profiling"]:
        sys.exit(profiling_child(sys.argv[2]))
    if sys.argv[1:2] == ["--row5"]:
        sys.exit(row5_only())
    if sys.argv[1:2] == ["--k23"]:
        sys.exit(k23_only())
    if sys.argv[1:2] in (["--cheb"], ["--pcg"]):
        sys.exit(phase_alone(sys.argv[1]))
    sys.exit(main_path_digests() if sys.argv[1:2] == ["--digests"] else main())
