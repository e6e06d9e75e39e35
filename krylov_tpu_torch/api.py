"""SciPy-compatible front door: :func:`solve`, :func:`solve_device`,
:func:`solve_batched` and the ``cg``/``mrr``/``kskipcg``/``kskipmrr``/
``adaptivekskipmrr``/``pcg``/``chronopoulos_gear``/``gropp``/``pipelined_cg``
wrappers, with the signatures of :mod:`krylov_tpu.api`.

A solve runs on the device of the operator's tensors; ``b`` and ``x0`` are
moved there.  A scipy or numpy operator lands on ``b``'s device when ``b``
is a tensor, else on the default device of :mod:`krylov_tpu_torch.device`
(the CUDA device unless the caller chose another).  2-D/3-D :class:`~krylov_tpu_torch.sparse.StencilMatrix`
systems take the fused whole-solve kernels (:mod:`.kernels.fused`,
:mod:`.kernels.fused_kskip`) for CG, MrR and the k-skip family; other
methods, other operators, a preconditioner ``M``, ``fused=False``,
``basis_norm=True`` or a wider ``scalar_dtype`` take the eager loops of
:mod:`.solvers`, whose stencil SpMV on the card is K1.  ``restarts=``
appends device-side defect corrections to a solve, ``refine=``
host-float64 iterative refinement.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from krylov_tpu_torch.context import Context
from krylov_tpu_torch.diagnostics import build_info, finish_banner, start_banner
from krylov_tpu_torch.kernels import _build
from krylov_tpu_torch.precond import lanczos_bounds
from krylov_tpu_torch.solvers import (
    SolveResult,
    adaptivekskipmrr_kernel,
    cacg_kernel,
    camrr_kernel,
    cg_kernel,
    chronopoulos_gear_kernel,
    gropp_kernel,
    kskipcg_kernel,
    kskipmrr_kernel,
    mrr_kernel,
    pcg_kernel,
    pipelined_cg_kernel,
)
from krylov_tpu_torch.solvers._common import check_square
from krylov_tpu_torch.sparse.convert import host64, host_matvec64
from krylov_tpu_torch.sparse.formats import StencilMatrix, as_operator, to_device

_METHOD_NAMES = {
    "cg": "CG",
    "mrr": "MrR",
    "kskipcg": "k-skip CG",
    "kskipmrr": "k-skip MrR",
    "adaptivekskipmrr": "Adaptive k-skip MrR",
    "cacg": "CA-CG (Chebyshev basis)",
    "camrr": "CA-MrR (Chebyshev basis)",
    "pcg": "Preconditioned CG",
    "chronopoulos_gear": "chronopoulos gear",
    "gropp": "gropp",
    "pipelined_cg": "pipeline",
}
_KERNELS = {
    "cg": cg_kernel,
    "mrr": mrr_kernel,
    "kskipcg": kskipcg_kernel,
    "kskipmrr": kskipmrr_kernel,
    "adaptivekskipmrr": adaptivekskipmrr_kernel,
    "cacg": cacg_kernel,
    "camrr": camrr_kernel,
    "pcg": pcg_kernel,
    "chronopoulos_gear": chronopoulos_gear_kernel,
    "gropp": gropp_kernel,
    "pipelined_cg": pipelined_cg_kernel,
}
_KSKIP_METHODS = ("kskipcg", "kskipmrr", "adaptivekskipmrr")
# Chebyshev-basis CA methods: the skip size through ``k`` (as s) and the
# spectral bounds
_CACG_METHODS = ("cacg", "camrr")
_PRECONDITIONED_METHODS = ("pcg", "chronopoulos_gear", "gropp", "pipelined_cg")
_FUSED_METHODS = ("cg", "mrr", *_KSKIP_METHODS)


def _check_options(method: str, mesh=None, M=None, spectral_bounds=None) -> None:
    """Raise on an unknown method, on ``mesh=`` (not ported yet, naming the
    ROADMAP queue-1 item that brings it), and on ``M=`` or
    ``spectral_bounds=`` given to a method that does not read them (the
    JAX package drops them silently)."""
    if method not in _KERNELS:
        raise ValueError(f"unknown method {method!r}; available: {sorted(_METHOD_NAMES)}")
    if mesh is not None:
        raise NotImplementedError("mesh= waits for the distributed port (ROADMAP queue 1, item 11)")
    if M is not None and method not in _PRECONDITIONED_METHODS:
        raise ValueError(f"M= is read by {_PRECONDITIONED_METHODS} only, not by method {method!r}")
    if spectral_bounds is not None and method not in _CACG_METHODS:
        raise ValueError(f"spectral_bounds= is read by {_CACG_METHODS} only, not by method {method!r}")


def _resolve_bounds(A, method: str, spectral_bounds):
    """``(lmin, lmax)`` of the Chebyshev-basis methods (None for the
    others): the given bounds as floats, else :func:`~krylov_tpu_torch.precond.lanczos_bounds`
    of ``A`` (16 SpMVs on its device), as :func:`krylov_tpu.api._resolve_bounds`."""
    if method not in _CACG_METHODS:
        return None
    if spectral_bounds is not None:
        lo, hi = spectral_bounds
        return float(lo), float(hi)
    return lanczos_bounds(A)


def _fused_eligible(A, method: str, M, scalar_dtype, fused) -> bool:
    """Take the fused whole-solve kernels for 2-D/3-D stencil systems.

    The TPU gates of the JAX package (backend, 32-bit dtype, VMEM size,
    8-row halo) do not apply: the kernels take float32 and float64, keep
    their vectors in device memory and read any row displacement."""
    if fused is False:
        return False
    ok = (
        method in _FUSED_METHODS
        and M is None
        and scalar_dtype in (None, A.dtype)
        and isinstance(A, StencilMatrix)
        and len(A.grid) in (2, 3)  # 3-D runs collapsed (collapse_to_2d)
    )
    if fused is True and not ok:
        raise ValueError(
            "fused=True requires a 2-D/3-D StencilMatrix system with method in "
            f"{_FUSED_METHODS} and no preconditioner"
        )
    return ok


def _run_fused(A: StencilMatrix, b, x0, tol, method: str, maxiter: int, k: int) -> SolveResult:
    from krylov_tpu_torch.kernels import fused, fused_kskip
    from krylov_tpu_torch.kernels.stencil import stencil_matvec

    # x0 shift: solve A dx = b - A x0, return x0 + dx.  The residual history
    # is the same (r0 = b - A x0 either way); b_norm stays that of the
    # ORIGINAL b.  A cold start (x0 None) solves for x directly.
    b_norm = torch.linalg.vector_norm(b)
    b_eff = b if x0 is None else b - stencil_matvec(A, x0)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    kw = dict(stencil=stencil2, grid=grid2, maxiter=maxiter, sub=sub)

    def shifted(dx):
        return dx if x0 is None else x0 + dx

    if method in ("cg", "mrr"):
        fn = fused.fused_cg_solve_2d if method == "cg" else fused.fused_mrr_solve_2d
        dx, trace, iters, conv = fn(coef2, b_eff, tol, b_norm, **kw)
        trace_len = min(maxiter, fused.TRACE_CAP) + 1
        return SolveResult(
            x=shifted(dx),
            residual_trace=trace,
            nosl_trace=torch.arange(trace_len, dtype=torch.int32, device=b.device),
            iterations=iters,
            # position of the final residual in the (possibly capped) trace
            index=torch.clamp(iters, max=trace_len - 1),
            converged=conv,
            trace_truncated=iters > trace_len - 1,
        )

    trace_len = fused_kskip.trace_length(maxiter)
    kw["k_max"] = max(k, 1)
    ktrace = final_k = None
    if method == "kskipcg":
        dx, trace, nosl, iters, conv, index = fused_kskip.fused_kskipcg_solve_2d(
            coef2, b_eff, tol, b_norm, k, **kw
        )
    else:
        adaptive = method == "adaptivekskipmrr"
        dx, trace, nosl, ktrace, iters, conv, index, final_k = fused_kskip.fused_kskipmrr_solve_2d(
            coef2, b_eff, tol, b_norm, k, adaptive=adaptive, **kw
        )
        if not adaptive:
            ktrace = final_k = None
    return SolveResult(
        x=shifted(dx),
        residual_trace=trace,
        nosl_trace=nosl,
        iterations=iters,
        index=torch.clamp(index, max=trace_len - 1),
        converged=conv,
        k_trace=ktrace,
        final_k=final_k,
        trace_truncated=index > trace_len - 1,
    )


def _prepare(A, b, x0, maxiter):
    """``b`` and ``x0`` (None stays None) as contiguous tensors on ``A``'s
    device and dtype, and the default ``maxiter``."""
    b = torch.as_tensor(b, device=A.device).to(A.dtype).contiguous()
    if b.ndim != 1:
        raise ValueError(f"b must be a vector, got shape {tuple(b.shape)}")
    n = check_square(A, b)
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=A.device).to(A.dtype).contiguous()
        if x0.shape != b.shape:
            raise ValueError(f"x0 has shape {tuple(x0.shape)}, b has shape {tuple(b.shape)}")
    return b, x0, n if maxiter is None else maxiter


def _run_base(A, b, x0, tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm, M=None,
              bounds=None) -> SolveResult:
    """One solve: the fused kernels, or the eager loop of ``method`` with
    the options it reads (``k``/``basis_norm``; ``s = max(k, 1)`` and the
    resolved ``bounds``; ``M``)."""
    if use_fused:
        return _run_fused(A, b, x0, tol, method, maxiter, k)
    ctx = Context(scalar_dtype=scalar_dtype)
    if x0 is None:
        x0 = torch.zeros_like(b)
    kw = dict(tol=tol, maxiter=maxiter, ctx=ctx)
    if method in _KSKIP_METHODS:
        kw.update(k=k, basis_norm=basis_norm)
    elif method in _CACG_METHODS:
        kw.update(s=max(k, 1), lmin=bounds[0], lmax=bounds[1])
    elif method in _PRECONDITIONED_METHODS:
        kw["M"] = M
    return _KERNELS[method](A, b, x0, **kw)


def _run_single(A, b, x0, tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm,
                restarts=0, M=None, bounds=None) -> SolveResult:
    """One solve, then ``restarts`` device-side defect-correction passes
    (:func:`krylov_tpu.api._run_single`).

    The solvers converge on the recurred residual, which in float32 drifts
    from the true one.  Each pass forms ``r = b - A x`` in working
    precision on the device and, while ``||r|| / ||b||`` is still at or
    above ``tol``, solves ``A d = r`` from zero to the equivalent relative
    tolerance (with a 5x margin, in ``[2e-7, 0.5]``), passed to the solver
    as a 0-d device tensor, and adds ``d`` to ``x``.  Where the JAX package
    decides with ``lax.cond`` on the device, this reads ``true_rel >= tol``
    on the host once a pass.  The result then carries ``true_residual``,
    and ``converged`` is ``true_residual < tol``."""
    result = _run_base(A, b, x0, tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm, M, bounds)
    if restarts == 0:
        return result
    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    b_norm = torch.linalg.vector_norm(b)
    x, iters = result.x, result.iterations
    for _ in range(restarts):
        r = b - A.matvec(x)
        r_norm = torch.linalg.vector_norm(r)
        # tol on the original system is tol * b_norm / r_norm on the defect
        inner_tol = torch.clamp(0.2 * tol_t * b_norm / torch.clamp(r_norm, min=1e-30), 2e-7, 0.5).to(b.dtype)
        if bool(r_norm / b_norm >= tol_t):
            res2 = _run_base(A, r, None, inner_tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm, M,
                             bounds)
            x, iters = x + res2.x, iters + res2.iterations
    true_final = torch.linalg.vector_norm(b - A.matvec(x)) / b_norm
    return dataclasses.replace(result, x=x, iterations=iters, converged=true_final < tol_t,
                               true_residual=true_final)


def _plan(A, b, x0, method, maxiter, M, scalar_dtype, fused, basis_norm):
    """Operator, ``b``, ``x0`` and ``maxiter`` on the operator's device, the
    route (fused or not), and ``basis_norm`` as the k-skip loops take it.

    ``basis_norm=True`` keeps a solve off the fused kernels and is read by
    the k-skip methods only, as in the JAX package."""
    if basis_norm and fused is True:
        raise ValueError(
            "basis_norm= is not supported by the fused whole-solve kernels; "
            "drop fused=True (the eager loops take it)"
        )
    A = as_operator(A, device=b.device if isinstance(b, torch.Tensor) else None)
    b, x0, maxiter = _prepare(A, b, x0, maxiter)
    use_fused = not basis_norm and _fused_eligible(A, method, M, scalar_dtype, fused)
    return A, b, x0, maxiter, use_fused, bool(basis_norm) and method in _KSKIP_METHODS


def solve_device(
    A, b, method: str = "cg", x0=None, tol: float = 1e-5,
    maxiter: Optional[int] = None, k: int = 0, M=None, mesh=None,
    scalar_dtype=None, fused=None, restarts: int = 0, basis_norm: bool = False,
    spectral_bounds=None,
) -> SolveResult:
    """Like :func:`solve` but returns the raw :class:`SolveResult` of device
    tensors (fixed-shape traces, no info dict; the solve itself syncs with
    the host only where its loop reads convergence).

    ``restarts``: device-side defect-correction passes appended to the
    solve (see :func:`_run_single`); the result then carries
    ``true_residual`` and ``converged`` reflects it."""
    _check_options(method, mesh, M, spectral_bounds)
    A, b, x0, maxiter, use_fused, basis_norm = _plan(
        A, b, x0, method, maxiter, M, scalar_dtype, fused, basis_norm
    )
    bounds = _resolve_bounds(A, method, spectral_bounds)
    return _run_single(A, b, x0, tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm, restarts, M,
                       bounds)


def solve(
    A, b, method: str = "cg", x0=None, tol: float = 1e-5,
    maxiter: Optional[int] = None, k: int = 0, M=None, mesh=None,
    scalar_dtype=None, fused=None, refine: int = 0, restarts: int = 0,
    chunk_iters: Optional[int] = None, basis_norm: bool = False,
    spectral_bounds=None, verbose: bool = False,
):
    """Solve the SPD system ``A x = b``; returns ``(x, info)``.

    ``A`` is one of this package's containers, a scipy sparse matrix or a
    2-D numpy array or tensor (a host input lands on ``b``'s device when
    ``b`` is a tensor, else on the default device, the CUDA device unless
    :func:`krylov_tpu_torch.set_default_device` chose another).  ``x`` is a
    tensor on the operator's device.  ``info`` holds ``time`` (the solve alone, between
    device synchronisations; a first call's kernel build is reported apart
    as ``compile_time``), ``nosl``, ``residual``, ``converged``,
    ``iterations``, for ``adaptivekskipmrr`` ``khistory`` and ``final_k``,
    and, when the fused path's trace ran past its capacity,
    ``residual_truncated``.  ``method`` is ``cg``, ``mrr``, ``kskipcg``,
    ``kskipmrr`` or ``adaptivekskipmrr`` (the k-skip methods take ``k``;
    ``basis_norm=True`` normalises their Krylov chains on the eager loops),
    ``pcg``, ``chronopoulos_gear``, ``gropp`` or ``pipelined_cg`` (these take
    the preconditioner ``M``, e.g. from :mod:`krylov_tpu_torch.precond`), or
    ``cacg`` or ``camrr`` (s = ``max(k, 1)``; ``spectral_bounds=(lmin,
    lmax)``, else :func:`~krylov_tpu_torch.precond.lanczos_bounds` of ``A``,
    resolved once before the timed solve).  ``M=`` or ``spectral_bounds=``
    given to a method that does not read them raises ``ValueError``.

    ``restarts=m`` appends ``m`` device-side defect corrections in working
    precision (:func:`_run_single`); ``info`` then holds ``true_residual``.
    ``refine=m`` runs host-float64 iterative refinement after the solve, as
    the JAX package does: while the float64 true residual is at or above
    ``tol`` (checked at most ``m`` times), the defect ``r = b - A x`` is
    formed in float64 on the host (:func:`~krylov_tpu_torch.sparse.convert.host_matvec64`),
    ``A d = r`` is solved in working precision through :func:`solve` with
    the same options, and ``x += d`` accumulates in float64.  ``info`` then
    holds ``true_residual`` and ``refinements``, its traces run on through
    the corrections (the residuals rescaled to the original system), and
    ``converged`` is ``true_residual < tol``.  The returned ``x`` is then a
    float64 tensor on the operator's device, where the JAX package returns
    a float64 numpy array.  ``chunk_iters`` at or above the effective
    ``maxiter`` runs one plain solve, as in the JAX package; below it, and
    ``mesh=``, raise ``NotImplementedError`` naming the ROADMAP item that
    ports them.
    """
    _check_options(method, mesh, M, spectral_bounds)
    b_in = b
    A, b, x0, maxiter_eff, use_fused, basis_norm_eff = _plan(
        A, b, x0, method, maxiter, M, scalar_dtype, fused, basis_norm
    )
    if chunk_iters is not None and chunk_iters < maxiter_eff:
        raise NotImplementedError(
            "chunk_iters= below maxiter waits for the port of chunked exact continuation (ROADMAP queue 1, item 10)"
        )
    if verbose:
        start_banner(_METHOD_NAMES[method], k if method in _KSKIP_METHODS else None)

    on_cuda = A.device.type == "cuda"
    compile_time = None
    if on_cuda and _build.build_seconds is None and (use_fused or isinstance(A, StencilMatrix)):
        _build.library()  # the fused kernels, or K1 for the eager loops
        compile_time = _build.build_seconds
    bounds = _resolve_bounds(A, method, spectral_bounds)  # set-up, before the timed solve
    if on_cuda:
        torch.cuda.synchronize(A.device)
    t0 = time.perf_counter()
    result = _run_single(A, b, x0, tol, method, maxiter_eff, k, scalar_dtype, use_fused, basis_norm_eff,
                         restarts, M, bounds)
    if on_cuda:
        torch.cuda.synchronize(A.device)
    elapsed = time.perf_counter() - t0

    info = build_info(result, elapsed)
    if compile_time:
        info["compile_time"] = compile_time
    x = result.x
    if refine:
        x = _refine(A, b_in, x, info, refine, tol, dict(
            method=method, maxiter=maxiter, k=k, M=M, mesh=mesh, scalar_dtype=scalar_dtype, fused=fused,
            chunk_iters=chunk_iters, basis_norm=basis_norm, spectral_bounds=bounds,
        ))
    if verbose:
        finish_banner(info["time"], info["converged"], info["iterations"], info["residual"][-1],
                      info.get("final_k"))
    return x, info


def _refine(A, b, x, info: dict, refine: int, tol: float, options: dict) -> torch.Tensor:
    """Host-float64 iterative refinement of ``x`` (the ``refine=`` path of
    :func:`krylov_tpu.api.solve`), merging each correction solve into
    ``info``.  Returns ``x`` as a float64 tensor on ``A``'s device."""
    A_host = to_device(A, "cpu")  # one copy; the float64 matvecs read it
    b64 = host64(b)
    b_norm = np.linalg.norm(b64)
    x64 = host64(x)
    refinements = 0
    true_rel = float(np.linalg.norm(b64 - host_matvec64(A_host, x64)) / b_norm)
    for _ in range(refine):
        if not np.isfinite(true_rel) or true_rel < tol:
            break
        r64 = b64 - host_matvec64(A_host, x64)
        r_norm = np.linalg.norm(r64)
        # tol on the original system is tol * b_norm / r_norm on the defect
        inner_tol = float(np.clip(tol * b_norm / r_norm, 1e-7, 0.1))
        d, seg = solve(A, r64, x0=None, tol=inner_tol, **options)
        x64 = x64 + host64(d)
        refinements += 1
        true_rel = float(np.linalg.norm(b64 - host_matvec64(A_host, x64)) / b_norm)
        info["time"] += seg["time"]
        info["nosl"] = np.concatenate([info["nosl"], seg["nosl"][1:] + info["nosl"][-1]])
        # the correction's residuals, rescaled to the original system
        info["residual"] = np.concatenate([info["residual"], seg["residual"][1:] * (r_norm / b_norm)])
        if "khistory" in info and "khistory" in seg:
            info["khistory"] = np.concatenate([info["khistory"], seg["khistory"][1:]])
        if "final_k" in seg:
            info["final_k"] = seg["final_k"]
        info["iterations"] += seg["iterations"]
    info["converged"] = bool(true_rel < tol)
    info["true_residual"] = true_rel
    info["refinements"] = refinements
    # float64: a cast back to the working dtype would floor ||b - A x|| again
    return torch.from_numpy(x64).to(A.device)


def solve_batched(
    A, B, method: str = "cg", X0=None, tol: float = 1e-5,
    maxiter: Optional[int] = None, k: int = 0, M=None, mesh=None,
    scalar_dtype=None, fused=None, basis_norm: bool = False,
    spectral_bounds=None,
) -> SolveResult:
    """Solve ``A x_i = b_i`` for a batch of right-hand sides ``B`` of shape
    ``(batch, N)``; returns the stacked :class:`SolveResult` of device
    tensors (``x`` of shape ``(batch, N)``, traces ``(batch, L)``, and
    ``iterations``, ``index``, ``converged`` and, where the method sets
    them, ``k_trace``/``final_k`` per member).  Each member keeps its own
    convergence point.

    On the fused route the members run one fused kernel each, back to back
    on one stream with no host sync in between (the JAX package's
    ``lax.map``).  On the eager route CG and MrR run the whole batch as one
    loop over ``(batch, N)`` blocks, each member freezing on its own (the
    JAX package's ``vmap``), through one K1 launch an SpMV on a stencil
    operator on the card; the other methods run member by member, with the
    spectral bounds of ``cacg``/``camrr`` resolved once."""
    _check_options(method, mesh, M, spectral_bounds)
    A = as_operator(A, device=B.device if isinstance(B, torch.Tensor) else None)
    B = torch.as_tensor(B, device=A.device).to(A.dtype).contiguous()
    if B.ndim != 2 or B.shape[1] != A.shape[0]:
        raise ValueError(f"B must be (batch, N={A.shape[0]}), got {tuple(B.shape)}")
    if X0 is not None:
        X0 = torch.as_tensor(X0, device=A.device).to(A.dtype).contiguous()
        if X0.shape != B.shape:
            raise ValueError(f"X0 has shape {tuple(X0.shape)}, B has shape {tuple(B.shape)}")
    A, _, _, maxiter, use_fused, basis_norm = _plan(
        A, B[0], None, method, maxiter, M, scalar_dtype, fused, basis_norm
    )
    # one tolerance tensor for the whole batch, in A's dtype as the JAX
    # package casts it: the fused kernels read it without a host transfer
    tol = torch.as_tensor(tol, dtype=A.dtype, device=A.device)
    if not use_fused and method in ("cg", "mrr"):
        X0 = torch.zeros_like(B) if X0 is None else X0
        return _KERNELS[method](A, B, X0, tol=tol, maxiter=maxiter, ctx=Context(scalar_dtype=scalar_dtype))
    bounds = _resolve_bounds(A, method, spectral_bounds)
    members = [
        _run_base(A, B[j], None if X0 is None else X0[j], tol, method, maxiter, k, scalar_dtype, use_fused,
                  basis_norm, M, bounds)
        for j in range(B.shape[0])
    ]
    return SolveResult(**{
        f.name: None if getattr(members[0], f.name) is None else torch.stack([getattr(m, f.name) for m in members])
        for f in dataclasses.fields(SolveResult)
    })


def _scipy_style(method: str):
    def f(A, b, x=None, tol=1e-05, maxiter=None, k=0, M=None, callback=None, atol=None, **kw):
        # callback/atol: accepted and unused, as in the JAX package
        return solve(A, b, method=method, x0=x, tol=tol, maxiter=maxiter, k=k, M=M, **kw)

    f.__name__ = method
    f.__doc__ = f"Reference-compatible wrapper for method={method!r}; see :func:`solve`."
    return f


cg = _scipy_style("cg")
mrr = _scipy_style("mrr")
kskipcg = _scipy_style("kskipcg")
kskipmrr = _scipy_style("kskipmrr")
adaptivekskipmrr = _scipy_style("adaptivekskipmrr")
pcg = _scipy_style("pcg")
chronopoulos_gear = _scipy_style("chronopoulos_gear")
gropp = _scipy_style("gropp")
pipelined_cg = _scipy_style("pipelined_cg")
