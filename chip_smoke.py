"""Smoke run of the PyTorch/CUDA port (krylov_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, then drives the main path:
``krylov_tpu_torch.solve`` with MrR and CG on the 2-D 5-point Laplacian at
N = 250,000 (constant-weight stencil form) in float64 and float32, and a
float64 MrR warm-started from the float32 answer.  It checks the float64
solves against a scipy/numpy float64 reference (same iteration count, true
residual below tol), holds the fused kernels against their plain versions
at that size in both dtypes while it times them with CUDA events, and
prints a JSON line of the kernels and last a JSON line with the device.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import numpy as np

    import krylov_tpu_torch
    from krylov_tpu_torch.kernels import _build, fused, stencil
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

    # 5. the main path through solve(), counters from this run only
    b_np = np.random.default_rng(0).standard_normal(NX * NX)
    runs = [("mrr", f64), ("cg", f64), ("mrr", f32), ("cg", f32)]
    ops = {dt: fixtures.laplace2d(NX, dtype=dt, constant=True, device=dev) for dt in (f64, f32)}
    counted = (stencil.stencil_matvec_2d, fused.fused_mrr_solve_2d, fused.fused_cg_solve_2d)
    for fn in counted:
        fn.launches = 0
    results = {}
    for m, dt in runs:
        results[m, dt] = krylov_tpu_torch.solve(ops[dt], b_np, method=m, tol=TOL, maxiter=MAXITER)
    # warm start: polish the float32 MrR answer in float64 (K1 forms b - A x0)
    x0_np = results["mrr", f32][0].double().cpu().numpy()
    results["mrr warm", f64] = krylov_tpu_torch.solve(ops[f64], b_np, method="mrr", x0=x0_np,
                                                      tol=TOL, maxiter=MAXITER)
    launches = {fn.__name__: fn.launches for fn in counted}
    phase(f"main path launches: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the main path never launched {name}")

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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
