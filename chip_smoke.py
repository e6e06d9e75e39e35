"""Smoke run of the PyTorch/CUDA port (krylov_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, then drives two paths of
``krylov_tpu_torch.solve`` on the 2-D 5-point Laplacian at N = 250,000
(constant-weight stencil form) in float64 and float32: MrR and CG (and a
float64 MrR warm-started from the float32 answer), then k-skip CG (k=4),
k-skip MrR (k=4) and adaptive k-skip MrR (k=8).  It checks the float64
solves against float64 references (scipy/numpy MrR and CG; the JAX
package's counts for the k-skip family) with the true residual below tol,
holds the fused kernels against their plain versions at that size while it
times them with CUDA events.  Then it drives the paths that reuse the
kernels: ``restarts=``/``refine=`` on the same system, ``solve_batched`` of
8 right-hand sides (fused MrR; eager CG on a HYB operator), the HYB
operator of ``powerlaw_spd(2**20)`` (matvec against scipy, CG against
numpy, Matrix Market IO), and the ill-conditioned row-4b system of
RESULTS.md, printed only.  It prints a JSON line of the kernels and last a
JSON line with the device.

Imports no JAX.  Any failed check raises, so the exit code is nonzero; with
no CUDA device it exits 1 before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

NX = 500  # N = 250,000: the main-path system
TOL = 1e-5
MAXITER = 3000
# fused kernel against its plain version: the sums run in another order
# (per-block partials), so the recurrences drift apart by rounding over
# ~1000 iterations.  The float32 limits sit about 10x above the largest
# differences read on an H100 at N = 250k (trace 7.8e-6 relative, x 9.9e-5
# absolute with max |x| ~ 76); a wrong kernel misses them by orders.
TOLS = {
    "float64": dict(trace_rtol=1e-9, x_rtol=1e-8, x_atol=1e-12),
    "float32": dict(trace_rtol=1e-4, x_rtol=1e-4, x_atol=1e-3),
}


# fused k-skip kernel (K5/K6) against its plain version, the eager loop on
# the same stencil: equal counts, nosl, ktrace and final k, the residual
# trace within trace_rtol entry by entry and max |x - x_plain| / max
# |x_plain| within x_rel.  Each limit sits 10x above the largest reading on
# an H100 (700 W) over the seeds of its phase (beside it; PERF.md, PR 2).
# The k-step recurrences amplify the rounding of the inner products, by
# about 1e6 at k = 4 and 1e12 at k = 8 (the float64 readings over eps), so
# the float64 limits grow with k.  In float32 that leaves no reproducible
# trajectory at k >= 4: there a kernel is held over its first outer
# iteration against the plain version in float64 on the same inputs (its
# float32 rounding, all digits of it at k = 8), and whole float32 solves
# are held at k = 1 and 2 and in the rollback case.
KSKIP_SMALL_TOLS = {  # whole solves; ("float32", 4): the first outer iteration
    ("float64", 1): dict(trace_rtol=2.3e-13, x_rel=2.1e-14),  # 2.207e-14, 2.005e-15
    ("float64", 2): dict(trace_rtol=4.6e-14, x_rel=1.3e-13),  # 4.588e-15, 1.283e-14
    ("float64", 4): dict(trace_rtol=3e-8, x_rel=5.4e-11),  # 2.938e-09, 5.354e-12
    ("float64", "rollback"): dict(trace_rtol=6.2e-6, x_rel=4.1e-15),  # 6.149e-07, 4.034e-16
    ("float32", 1): dict(trace_rtol=6.9e-4, x_rel=1.5e-5),  # 6.841e-05, 1.480e-06
    ("float32", 2): dict(trace_rtol=4.3e-2, x_rel=1.4e-4),  # 4.287e-03, 1.339e-05
    ("float32", 4): dict(trace_rtol=0.23, x_rel=0.23),  # 2.24e-02, 2.25e-02
    ("float32", "rollback"): dict(trace_rtol=0.12, x_rel=1.3e-6),  # 1.109e-02, 1.234e-07
}
KSKIP_FULL = {  # (method, k, dtype): limits at N = 250k over SEEDS
    ("kskipcg", 4, "float64"): dict(trace_rtol=1.1e-8, x_rel=3.1e-10),  # 1.091e-09, 3.018e-11
    ("kskipmrr", 4, "float64"): dict(trace_rtol=2.9e-14, x_rel=2.9e-9),  # 2.834e-15, 2.887e-10
    ("kskipmrr", 8, "float64"): dict(trace_rtol=1.8e-2, x_rel=2.1e-3),  # 1.762e-03, 2.033e-04
    ("adaptivekskipmrr", 8, "float64"): dict(trace_rtol=1.8e-2, x_rel=2.1e-3),  # the same
    ("kskipcg", 1, "float32"): dict(trace_rtol=4.8e-3, x_rel=1.4e-4),  # 4.724e-04, 1.337e-05
    ("kskipmrr", 2, "float32"): dict(trace_rtol=7.2e-2, x_rel=4.3e-3),  # 7.171e-03, 4.227e-04
    # the first outer iteration, against the float64 plain version
    ("kskipcg", 4, "float32"): dict(trace_rtol=0.25, x_rel=6.5e-2),  # 2.48e-02, 6.48e-03
    ("kskipmrr", 4, "float32"): dict(trace_rtol=6.5e-3, x_rel=0.12),  # 6.49e-04, 1.13e-02
    ("adaptivekskipmrr", 8, "float32"): dict(trace_rtol=7.9, x_rel=4.9),  # 0.783, 0.481: no digit left
}
# The k-skip main path, with the counts of krylov_tpu.solve (the JAX
# package) on the CPU with x64 on the same system, b, tol and maxiter:
# (iterations, outer iterations = len(residual) - 1) in float64; in float32
# it gave 1460, 3001 (not converged) and 1083 (final k 3), not held here.
KSKIP_RUNS = {"kskipcg": 4, "kskipmrr": 4, "adaptivekskipmrr": 8}
KSKIP_F64 = {"kskipcg": (1055, 211), "kskipmrr": (936, 188), "adaptivekskipmrr": (937, 105)}
SEEDS = (1, 2, 3)  # fresh b of the timed comparisons
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


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def laplace2d_csr_f64(nx):
    """Plain scipy 2-D 5-point Dirichlet Laplacian, A = I (x) T + T (x) I
    with T = tridiag(-1, 2, -1): built independently of the port."""
    import numpy as np
    import scipy.sparse as sp

    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx), dtype=np.float64)
    I = sp.identity(nx, dtype=np.float64, format="csr")
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


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
    profiler recorded no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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


def true_rel(A_csr, b, x) -> float:
    """||b - A x|| / ||b|| in float64 on the host, with the scipy matrix."""
    import numpy as np

    b64, x64 = np.asarray(b, dtype=np.float64), x.double().cpu().numpy()
    return float(np.linalg.norm(b64 - A_csr @ x64) / np.linalg.norm(b64))


def reset(fns) -> None:
    for fn in fns:
        fn.launches = 0


def check_launched(path: str, fns) -> dict:
    """The launch counts of ``fns`` since :func:`reset`; raises when one of
    them never launched."""
    counts = {fn.__name__: fn.launches for fn in fns}
    phase(f"{path} launches: {counts}")
    for name, count in counts.items():
        if count < 1:
            raise AssertionError(f"the {path} never launched {name}")
    return counts


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
    one K2 launch per member, back to back with no host sync in between
    (run under torch.cuda.set_sync_debug_mode("error")); each member equals
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
            torch.cuda.set_sync_debug_mode("error")  # a host sync inside raises
            try:
                return krylov_tpu_torch.solve_batched(ops[dt], B, method="mrr", tol=tol, maxiter=MAXITER)
            finally:
                torch.cuda.set_sync_debug_mode("default")

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
    printed, not held: float32 vectors, tol 1e-4, MAXITER, CG and the
    monomial k-skip family with float64 scalars, each with its converged
    flag, count, host float64 true residual and time."""
    import numpy as np
    import torch

    import krylov_tpu_torch
    from krylov_tpu_torch.sparse import as_operator, fixtures

    tol = 1e-4
    t0 = time.perf_counter()
    P = fixtures.powerlaw_spd(2**20, shift=1e-3, diag_scale_decades=1.5)
    A = as_operator(P, dtype=torch.float32, device=dev)
    phase(f"row 4b powerlaw_spd(2**20, shift=1e-3, diag_scale_decades=1.5): {type(A).__name__} float32, "
          f"nnz {P.nnz}, set-up {time.perf_counter() - t0:.2f} s")
    b_np = np.random.default_rng(27).standard_normal(P.shape[0]).astype(np.float32)
    t0 = time.perf_counter()
    ref_iters, ref_hist = numpy_cg(P, b_np.astype(np.float64), tol, MAXITER)
    phase(f"  numpy f64 CG on the same CSR: {ref_iters} iterations, residual {ref_hist[-1]:.6e}, "
          f"{time.perf_counter() - t0:.2f} s")
    runs = [
        ("cg", 0, {}),
        ("kskipmrr", 4, dict(scalar_dtype=torch.float64)),
        ("adaptivekskipmrr", 8, dict(scalar_dtype=torch.float64)),
        ("adaptivekskipmrr", 8, dict(scalar_dtype=torch.float64, basis_norm=True)),
    ]
    for m, k, kw in runs:
        x, info = krylov_tpu_torch.solve(A, b_np, method=m, k=k, tol=tol, maxiter=MAXITER, **kw)
        res = true_rel(P, b_np, x)
        extra = "" if "final_k" not in info else f", final k {info['final_k']}"
        phase(f"  row 4b {m} k={k}{' basis_norm' if kw.get('basis_norm') else ''}"
              f"{' f64 scalars' if kw else ''}: converged {info['converged']}, iters {info['iterations']}, "
              f"recurred res {info['residual'][-1]:.6e}, host f64 true res {res:.6e}{extra}, "
              f"solve() time {info['time']:.3f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import numpy as np

    import krylov_tpu_torch
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

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.nvcc()}, {' '.join(_build.FLAGS)})")

    # 3. K1 against its plain version
    k1_err = None
    for make, label in (
        (lambda dt: fixtures.laplace2d(NX, dtype=dt, device=dev), "laplace2d(500)"),
        (lambda dt: fixtures.laplace2d(NX, dtype=dt, constant=True, device=dev), "laplace2d(500, constant)"),
        (lambda dt: fixtures.laplace3d(64, dtype=dt, constant=True, device=dev), "laplace3d(64, constant)"),
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

    # 4. K2/K3 against their plain versions on small grids, float64
    for make, label in (
        (lambda: fixtures.laplace2d(64, device=dev), "laplace2d(64)"),
        (lambda: fixtures.laplace2d(64, constant=True, device=dev), "laplace2d(64, constant)"),
        (lambda: fixtures.laplace3d(16, constant=True, device=dev), "laplace3d(16, constant)"),
    ):
        A = make()
        coef2, st2, g2, sub = A.collapse_to_2d()
        b = torch.from_numpy(np.random.default_rng(12).standard_normal(A.shape[0])).to(dev)
        b_norm = torch.linalg.vector_norm(b)
        kw = dict(stencil=st2, grid=g2, maxiter=A.shape[0], sub=sub)
        for m, kern, plain in (("cg", fused.fused_cg_solve_2d, fused.fused_cg_solve_2d_reference),
                               ("mrr", fused.fused_mrr_solve_2d, fused.fused_mrr_solve_2d_reference)):
            compare_solves(f"K{'3' if m == 'cg' else '2'} {m} {label} f64",
                           kern(coef2, b, 1e-8, b_norm, **kw), plain(coef2, b, 1e-8, b_norm, **kw),
                           **TOLS["float64"])

    # 4b. K5/K6 against their plain versions on small grids, two seeds:
    # whole solves in float64, and in float32 at k <= 2; the float32 k = 4
    # solves over their first outer iteration against the float64 plain
    # version; then the adaptive rollback case in both
    kernel_id = {"kskipcg": "K6", "kskipmrr": "K5", "adaptivekskipmrr": "K5 adaptive"}
    for dt, tol in ((f64, 1e-8), (f32, 1e-5)):
        name = str(dt).removeprefix("torch.")
        for make, label in (
            (lambda: fixtures.laplace2d(64, dtype=dt, device=dev), "laplace2d(64)"),
            (lambda: fixtures.laplace2d(64, dtype=dt, constant=True, device=dev), "laplace2d(64, constant)"),
            (lambda: fixtures.laplace3d(16, dtype=dt, constant=True, device=dev), "laplace3d(16, constant)"),
        ):
            A = make()
            for seed in (12, 13):
                b = torch.from_numpy(np.random.default_rng(seed).standard_normal(A.shape[0])).to(dev, dt)
                for m, k in (("kskipcg", 1), ("kskipcg", 4), ("kskipmrr", 2), ("kskipmrr", 4),
                             ("adaptivekskipmrr", 4)):
                    first = dt == f32 and k >= 4
                    maxiter = first_outer(m, k, 1) if first else A.shape[0]
                    compare_kskip(f"{kernel_id[m]} {m} k={k} {label} {name} seed {seed}"
                                  + (f", maxiter {maxiter} against float64" if first else ""),
                                  kskip_call(m, k, A, b, tol, maxiter),
                                  kskip_call(m, k, A, b, tol, maxiter, plain=True, plain64=first),
                                  **KSKIP_SMALL_TOLS[name, k])
        adv = advection(dev)
        A = type(adv)(adv.coef.to(dt), adv.stencil, adv.grid)
        for seed in (3, 4):
            b = torch.from_numpy(np.random.default_rng(seed).standard_normal(A.shape[0])).to(dev, dt)
            got = kskip_call("adaptivekskipmrr", 6, A, b, tol, 2000)
            want = kskip_call("adaptivekskipmrr", 6, A, b, tol, 2000, plain=True)
            compare_kskip(f"K5 adaptive rollback, advection 16x16 k=6 {name} seed {seed}", got, want,
                          **KSKIP_SMALL_TOLS[name, "rollback"])
            if not (int(got[7]) < 6 and int(want[7]) < 6):
                raise AssertionError(f"the advection case did not roll back ({name}, seed {seed})")

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
    launches = check_launched("main path", counted)

    A_csr = laplace2d_csr_f64(NX)
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

    # 5b. the k-skip path through solve(), counters from this run only
    counted_k = (fused_kskip.fused_kskipcg_solve_2d, fused_kskip.fused_kskipmrr_solve_2d)
    reset(counted_k)
    kres = {}
    for dt in (f64, f32):
        for m, k in KSKIP_RUNS.items():
            kres[m, dt] = krylov_tpu_torch.solve(ops[dt], b_np, method=m, k=k, tol=TOL, maxiter=MAXITER)
    klaunches = check_launched("k-skip path", counted_k)
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

    # 6. K2/K3 against their plain versions at the main-path shape, timed:
    # median of 3 fresh b
    ms, k23_err = {}, {}
    for dt in (f64, f32):
        coef2, st2, g2, sub = ops[dt].collapse_to_2d()
        kw = dict(stencil=st2, grid=g2, maxiter=MAXITER, sub=sub)
        for m, kern, plain in (("mrr", fused.fused_mrr_solve_2d, fused.fused_mrr_solve_2d_reference),
                               ("cg", fused.fused_cg_solve_2d, fused.fused_cg_solve_2d_reference)):
            t_k, t_p, errs = [], [], []
            for seed in (1, 2, 3):
                b = torch.from_numpy(np.random.default_rng(seed).standard_normal(NX * NX)).to(dev, dt)
                b_norm = torch.linalg.vector_norm(b)
                tp, want = cuda_ms(lambda: plain(coef2, b, TOL, b_norm, **kw))
                tk, got = cuda_ms(lambda: kern(coef2, b, TOL, b_norm, **kw))
                t_p.append(tp)
                t_k.append(tk)
                errs.append(compare_solves(f"K{'3' if m == 'cg' else '2'} {m} laplace2d({NX}, constant) "
                                           f"{dt} seed {seed}", got, want, **TOLS[str(dt).removeprefix("torch.")]))
            ms[m, dt] = (statistics.median(t_k), statistics.median(t_p))
            k23_err[m, dt] = max(errs)
            phase(f"time-to-solution {m} {dt} N={NX * NX}: kernel {ms[m, dt][0]:.3f} ms, "
                  f"plain {ms[m, dt][1]:.3f} ms (median of 3, CUDA events; "
                  f"{summary[m, dt]} iterations on seed 0)")
    spmv = {}
    for dt in (f64, f32):
        coef2, st2, g2, sub = ops[dt].collapse_to_2d()
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(NX * NX)).to(dev, dt)
        kw = dict(stencil=st2, grid=g2, sub=sub)
        stencil.stencil_matvec_2d(coef2, x, **kw)  # warm-up
        t_k = cuda_ms(lambda: stencil.stencil_matvec_2d(coef2, x, **kw), reps=200)[0]
        t_p = cuda_ms(lambda: stencil.stencil_matvec_2d_reference(coef2, x, **kw), reps=20)[0]
        spmv[dt] = (t_k, t_p)
        phase(f"K1 SpMV {dt} N={NX * NX}: kernel {t_k * 1e3:.3f} us ({ops[dt].nnz / (t_k * 1e-3) / 1e9:.3f} Gnnz/s), "
              f"plain {t_p * 1e3:.3f} us ({ops[dt].nnz / (t_p * 1e-3) / 1e9:.3f} Gnnz/s)")

    # 6b. K5/K6 against their plain versions at the main-path shape on
    # SEEDS, the kernel timed as the median over them, the plain version too;
    # static k-skip MrR k=8 stands beside adaptive k=8 as a witness that the
    # gap comes from k.  Then the whole float32 solves that are not held
    # (see KSKIP_FULL), printed side by side.
    kms, kerr = {}, {}
    for (m, k, name), tols in KSKIP_FULL.items():
        dt = getattr(torch, name)
        first = dt == f32 and k >= 4
        maxiter = first_outer(m, k, 1) if first else MAXITER
        t_k, t_p, errs = [], [], []
        for seed in SEEDS:
            b = torch.from_numpy(np.random.default_rng(seed).standard_normal(NX * NX)).to(dev, dt)
            tk, got = cuda_ms(lambda: kskip_call(m, k, ops[dt], b, TOL, maxiter))
            tp, want = cuda_ms(lambda: kskip_call(m, k, ops[dt], b, TOL, maxiter, plain=True, plain64=first))
            t_k.append(tk)
            t_p.append(tp)
            errs.append(compare_kskip(f"{kernel_id[m]} {m} k={k} laplace2d({NX}, constant) {name} seed {seed}"
                                      + (f", maxiter {maxiter} against float64" if first else ""),
                                      got, want, **tols))
        kms[m, k, name] = (statistics.median(t_k), statistics.median(t_p))
        kerr[m, k, name] = max(errs)
        blocks = fused_kskip.workspace(m.removeprefix("adaptive"), dt, NX * NX, max(k, 1))[0]
        phase(f"time-to-solution {m} k={k} {name} N={NX * NX}"
              + (f" maxiter {maxiter}" if first else "") + f": kernel {kms[m, k, name][0]:.3f} ms, "
              f"plain {kms[m, k, name][1]:.3f} ms (median over seeds {SEEDS}, CUDA events); "
              f"grid {blocks} blocks of 256 threads")
    for m, k in (("kskipcg", 4), ("kskipmrr", 4), ("adaptivekskipmrr", 8)):
        for seed in SEEDS:
            b = torch.from_numpy(np.random.default_rng(seed).standard_normal(NX * NX)).to(dev, f32)
            (_, t, _, _, i, c, idx, f), (_, tr, _, _, ir, cr, idr, fr) = (
                kskip_call(m, k, ops[f32], b, TOL, MAXITER), kskip_call(m, k, ops[f32], b, TOL, MAXITER, plain=True))
            last = fused_kskip.trace_length(MAXITER) - 1
            phase(f"  float32 whole solve, not held: {m} k={k} seed {seed}: kernel {int(i)} iterations, "
                  f"conv {bool(c)}, recurred res {float(t[min(int(idx), last)]):.6e}"
                  + ("" if f is None else f", final k {int(f)}") + f"; plain {int(ir)}, conv {bool(cr)}, "
                  f"recurred res {float(tr[min(int(idr), last)]):.6e}" + ("" if fr is None else f", final k {int(fr)}"))
    b64 = torch.from_numpy(np.random.default_rng(SEEDS[-1]).standard_normal(NX * NX)).to(dev)
    for m, k in KSKIP_RUNS.items():
        us = device_us(lambda: kskip_call(m, k, ops[f64], b64, TOL, MAXITER),
                       "kskipcg_fused_kernel" if m == "kskipcg" else "kskipmrr_fused_kernel", 1)
        phase(f"device time {m} k={k} float64 (torch.profiler, seed {SEEDS[-1]}): "
              f"{'not measured' if us is None else f'{us:.3f} us'}")

    # kernel time alone, from the profiler: a K1 call through the wrapper
    # costs host time too, and K2/K3 add the wrapper's few small launches
    for dt in (f64, f32):
        coef2, st2, g2, sub = ops[dt].collapse_to_2d()
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(NX * NX)).to(dev, dt)
        b_norm = torch.linalg.vector_norm(x)
        us = {
            "K1 stencil2d_kernel": device_us(
                lambda: stencil.stencil_matvec_2d(coef2, x, stencil=st2, grid=g2, sub=sub), "stencil2d_kernel", 50),
            "K2 mrr_fused_kernel": device_us(
                lambda: fused.fused_mrr_solve_2d(coef2, x, TOL, b_norm, stencil=st2, grid=g2, maxiter=MAXITER, sub=sub),
                "mrr_fused_kernel", 1),
            "K3 cg_fused_kernel": device_us(
                lambda: fused.fused_cg_solve_2d(coef2, x, TOL, b_norm, stencil=st2, grid=g2, maxiter=MAXITER, sub=sub),
                "cg_fused_kernel", 1),
        }
        blocks = {m: fused.workspace(m, dt, NX * NX)[0] for m in ("mrr", "cg")}
        phase(f"device time {dt} (torch.profiler): " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.3f} us'}" for k, v in us.items())
            + f"; cooperative grid blocks of 256 threads: {blocks}")

    fidelity(ops, b_np, A_csr, fused, stencil)
    hyb = irregular_system(dev)
    batched(ops, hyb, dev, fused)
    irregular(hyb, dev)
    row4b(dev)

    kernels = [
        {"name": "stencil_matvec_2d", "route": "cuda", "source": "krylov_tpu_torch/kernels/csrc/stencil.cu",
         "replaces": "krylov_tpu/kernels/stencil.py:89", "launches": launches["stencil_matvec_2d"],
         "max_abs_err": k1_err, "ms": spmv[f64][0], "plain_ms": spmv[f64][1]},
        {"name": "fused_mrr_solve_2d", "route": "cuda", "source": "krylov_tpu_torch/kernels/csrc/fused.cu",
         "replaces": "krylov_tpu/kernels/fused.py:344", "launches": launches["fused_mrr_solve_2d"],
         "max_abs_err": k23_err["mrr", f64], "ms": ms["mrr", f64][0], "plain_ms": ms["mrr", f64][1]},
        {"name": "fused_cg_solve_2d", "route": "cuda", "source": "krylov_tpu_torch/kernels/csrc/fused.cu",
         "replaces": "krylov_tpu/kernels/fused.py:259", "launches": launches["fused_cg_solve_2d"],
         "max_abs_err": k23_err["cg", f64], "ms": ms["cg", f64][0], "plain_ms": ms["cg", f64][1]},
        {"name": "fused_kskipmrr_solve_2d", "route": "cuda", "source": "krylov_tpu_torch/kernels/csrc/fused_kskip.cu",
         "replaces": "krylov_tpu/kernels/fused_kskip.py:528", "launches": klaunches["fused_kskipmrr_solve_2d"],
         "max_abs_err": max(kerr["kskipmrr", 4, "float64"], kerr["adaptivekskipmrr", 8, "float64"]),
         "ms": kms["kskipmrr", 4, "float64"][0], "plain_ms": kms["kskipmrr", 4, "float64"][1]},
        {"name": "fused_kskipcg_solve_2d", "route": "cuda", "source": "krylov_tpu_torch/kernels/csrc/fused_kskip.cu",
         "replaces": "krylov_tpu/kernels/fused_kskip.py:629", "launches": klaunches["fused_kskipcg_solve_2d"],
         "max_abs_err": kerr["kskipcg", 4, "float64"], "ms": kms["kskipcg", 4, "float64"][0],
         "plain_ms": kms["kskipcg", 4, "float64"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
