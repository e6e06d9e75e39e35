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
host-float64 iterative refinement, ``chunk_iters=`` splits it into bounded
chunks that carry the loops' state exactly.  ``mesh=`` (a 1-D
``DeviceMesh``, :func:`krylov_tpu_torch.dist.make_mesh`) runs the eager
loops row-partitioned over the ranks of a ``torch.distributed`` world
(:mod:`krylov_tpu_torch.dist`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from krylov_tpu_torch import tracing
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
# methods whose eager loops take carry_in/emit_carry: chunk_iters is exact
# for them
_CARRY_METHODS = ("cg", "mrr", *_KSKIP_METHODS, *_CACG_METHODS)


def _check_options(method: str, mesh=None, M=None, spectral_bounds=None) -> None:
    """Raise on an unknown method, on a ``mesh`` that is not a
    one-dimensional ``torch.distributed`` ``DeviceMesh`` (``TypeError``),
    and on ``M=`` or ``spectral_bounds=`` given to a method that does not
    read them (the JAX package drops them silently)."""
    if method not in _KERNELS:
        raise ValueError(f"unknown method {method!r}; available: {sorted(_METHOD_NAMES)}")
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not (isinstance(mesh, DeviceMesh) and mesh.ndim == 1):
            raise TypeError(
                "mesh= takes a one-dimensional torch.distributed DeviceMesh "
                f"(krylov_tpu_torch.dist.make_mesh), got {type(mesh).__name__}"
            )
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


def _zero_rows(b: torch.Tensor) -> list:
    """Which systems of ``b`` (a vector, or a ``(batch, n)`` block) have
    ``||b|| = 0``, read on the host: one device-to-host transfer."""
    zero = torch.linalg.vector_norm(b, dim=-1) == 0
    with tracing.host_read():
        return zero.reshape(-1).tolist()


def _zero_result(b: torch.Tensor, method: str, k: int, sdt, use_fused: bool, restarts: int = 0) -> SolveResult:
    """The result of systems whose ``b`` is 0, which the front door returns
    without running a kernel or a loop (scipy's rule: ``x = 0``, converged,
    no iteration): ``x`` zero in ``b``'s dtype and on its device, a one-slot
    residual trace holding 0, ``iterations`` and ``index`` 0, and the
    fields the route would set (the count dtype of the route, the adaptive
    ``k_trace = [k]`` and ``final_k = k``, ``trace_truncated`` False on the
    fused route, ``true_residual`` 0 after ``restarts=``).  ``b`` may carry
    a leading batch axis."""
    batch, dev = b.shape[:-1], b.device
    count = torch.int32 if use_fused else torch.int64
    adaptive = method == "adaptivekskipmrr"
    return SolveResult(
        x=torch.zeros_like(b),
        residual_trace=torch.zeros(batch + (1,), dtype=sdt or b.dtype, device=dev),
        nosl_trace=torch.zeros(batch + (1,), dtype=torch.int32, device=dev),
        iterations=torch.zeros(batch, dtype=count, device=dev),
        index=torch.zeros(batch, dtype=count, device=dev),
        converged=torch.ones(batch, dtype=torch.bool, device=dev),
        k_trace=torch.full(batch + (1,), k, dtype=torch.int32, device=dev) if adaptive else None,
        final_k=torch.full(batch, k, dtype=count, device=dev) if adaptive else None,
        true_residual=torch.zeros(batch, dtype=b.dtype, device=dev) if restarts else None,
        trace_truncated=torch.zeros(batch, dtype=torch.bool, device=dev) if use_fused else None,
    )


def _skip_zero_members(run, B: torch.Tensor, X0, zero: list, method: str, k: int, sdt,
                       use_fused: bool) -> SolveResult:
    """``run(B, X0)`` on the members of the batch whose ``b`` is not 0, the
    zero members' results (:func:`_zero_result`) put back into their rows.
    The members that run form a batch of their own, each keeping the bits
    of its solo solve, and it runs as long as its longest member."""
    keep = [j for j, z in enumerate(zero) if not z]
    if len(keep) == len(zero):
        return run(B, X0)
    if not keep:
        return _zero_result(B, method, k, sdt, use_fused)
    idx = torch.tensor(keep, device=B.device)
    sub = run(B.index_select(0, idx), None if X0 is None else X0.index_select(0, idx))
    rows = torch.ones(len(zero), dtype=torch.bool, device=B.device)
    rows[idx] = False  # the zero members
    fields = {}
    for f in dataclasses.fields(SolveResult):
        v = getattr(sub, f.name)
        if not isinstance(v, torch.Tensor):
            fields[f.name] = v
            continue
        full = torch.zeros((len(zero),) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        full.index_copy_(0, idx, v)
        fields[f.name] = full
    fields["converged"][rows] = True
    if fields["k_trace"] is not None:
        fields["k_trace"][rows, :2] = k
        fields["final_k"][rows] = k
    return SolveResult(**fields)


def _run_base(A, b, x0, tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm, M=None,
              bounds=None, carry=None, ctx=None) -> SolveResult:
    """One solve: the fused kernels, or the eager loop of ``method`` with
    the options it reads (``k``/``basis_norm``; ``s = max(k, 1)`` and the
    resolved ``bounds``; ``M``).  ``carry`` (eager loops of
    ``_CARRY_METHODS`` only): ``None`` runs the loop as it is; a pair
    ``(state, valid)`` resumes from ``state`` when ``valid``, and the
    result then carries the loop's state after it in ``result.carry``.
    ``ctx`` (default: single-device with ``scalar_dtype``) is the loop's
    :class:`~krylov_tpu_torch.context.Context`: the distributed one of
    :func:`krylov_tpu_torch.dist.solve_sharded`."""
    if use_fused:
        with tracing.span("run_fused"):
            return _run_fused(A, b, x0, tol, method, maxiter, k)
    if ctx is None:
        ctx = Context(scalar_dtype=scalar_dtype)
    if x0 is None:
        x0 = torch.zeros_like(b)
    kw = dict(tol=tol, maxiter=maxiter, ctx=ctx)
    if carry is not None:
        kw.update(carry_in=carry, emit_carry=True)
    if method in _KSKIP_METHODS:
        kw.update(k=k, basis_norm=basis_norm)
    elif method in _CACG_METHODS:
        kw.update(s=max(k, 1), lmin=bounds[0], lmax=bounds[1])
    elif method in _PRECONDITIONED_METHODS:
        kw["M"] = M
    with tracing.span("eager_loop"):
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
    with tracing.span("restarts"):
        tol_t = tracing.scalar_on(tol, b.dtype, b.device)
        b_norm = torch.linalg.vector_norm(b)
        x, iters = result.x, result.iterations
        for _ in range(restarts):
            r = b - A.matvec(x)
            r_norm = torch.linalg.vector_norm(r)
            # tol on the original system is tol * b_norm / r_norm on the defect
            inner_tol = torch.clamp(0.2 * tol_t * b_norm / torch.clamp(r_norm, min=1e-30), 2e-7, 0.5).to(b.dtype)
            with tracing.host_read():
                again = bool(r_norm / b_norm >= tol_t)
            if again:
                res2 = _run_base(A, r, None, inner_tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm,
                                 M, bounds)
                x, iters = x + res2.x, iters + res2.iterations
        true_final = torch.linalg.vector_norm(b - A.matvec(x)) / b_norm
    return dataclasses.replace(result, x=x, iterations=iters, converged=true_final < tol_t,
                               true_residual=true_final)


def _solve_chunked(A, b, x0, tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm, M, bounds,
                   chunk_iters: int):
    """A solve in chunks of ``chunk_iters`` iterations, as
    :func:`krylov_tpu.api._solve_chunked`; returns the last chunk's
    :class:`SolveResult` and the merged ``info``.

    Without ``use_fused`` (the caller's ``fused=True``) the methods of
    ``_CARRY_METHODS`` chunk on their eager loops, each chunk resuming from
    the state the one before left (``carry_in``/``emit_carry``), so the
    iterations are exactly those of the unbroken eager solve.  The others,
    and fused chunks (one K2/K3/K5/K6 launch each, shifted to ``x0 = x``
    through K1), warm-restart from the iterate.  A chunk always
    runs whole, so the last may overshoot ``maxiter`` by up to
    ``chunk_iters - 1``.  The solve stops on convergence, at ``maxiter``,
    on a chunk without progress or on a non-finite residual.  ``time``
    sums the chunks (each between device synchronisations), the traces
    concatenate, and ``info["chunks"]`` counts the chunks.  The iterate
    stays on the device between chunks.  ``valid`` is a host bool, so the
    first chunk runs from ``x0`` with an invalid carry and no zero state
    is built."""
    exact = method in _CARRY_METHODS and not use_fused
    carry = (None, False) if exact else None
    x_cur, merged, iters_done, chunks = x0, None, 0, 0
    on_cuda = b.is_cuda
    while True:
        if on_cuda:
            torch.cuda.synchronize(b.device)
        t0 = time.perf_counter()
        result = _run_base(A, b, x_cur, tol, method, chunk_iters, k, scalar_dtype, use_fused, basis_norm, M,
                           bounds, carry)
        if on_cuda:
            torch.cuda.synchronize(b.device)
        seg = build_info(result, time.perf_counter() - t0)
        if exact:
            carry = (result.carry, True)
            result = dataclasses.replace(result, carry=None)
        chunks += 1
        if merged is None:
            merged = seg
        else:
            merged["time"] += seg["time"]
            merged["nosl"] = np.concatenate([merged["nosl"], seg["nosl"][1:] + merged["nosl"][-1]])
            merged["residual"] = np.concatenate([merged["residual"], seg["residual"][1:]])
            if "khistory" in merged and "khistory" in seg:
                merged["khistory"] = np.concatenate([merged["khistory"], seg["khistory"][1:]])
            if "final_k" in seg:
                merged["final_k"] = seg["final_k"]
            if seg.get("residual_truncated"):
                merged["residual_truncated"] = True
            merged["iterations"] += seg["iterations"]
            merged["converged"] = seg["converged"]
        iters_done += seg["iterations"]
        x_cur = result.x
        if (seg["converged"] or iters_done >= maxiter or seg["iterations"] == 0
                or not np.isfinite(seg["residual"][-1])):
            break
    merged["chunks"] = chunks
    return result, merged


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


def _check_mesh_options(restarts: int = 0, chunk_iters=None, fused=None) -> None:
    """The options ``mesh=`` does not take, with the JAX package's errors."""
    if restarts:
        raise ValueError("restarts= is single-device only (use refine= with mesh)")
    if chunk_iters is not None:
        raise ValueError("chunk_iters= is single-device only")
    if fused:
        raise ValueError("fused= and mesh= are mutually exclusive")


@tracing.entry_point
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
    ``true_residual`` and ``converged`` reflects it.  Single-device only.

    With ``mesh=`` every rank calls it with the whole system; ``x`` is then
    this rank's rows of the solution (the JAX package returns one global
    array sharded over the mesh; a plain tensor a rank is its counterpart
    here), and the traces are the same on every rank."""
    with tracing.span("plan"):
        _check_options(method, mesh, M, spectral_bounds)
        if mesh is not None:
            _check_mesh_options(restarts=restarts, fused=fused)
            fused = False
        A, b, x0, maxiter, use_fused, basis_norm = _plan(A, b, x0, method, maxiter, M, scalar_dtype, fused,
                                                         basis_norm)
    if mesh is not None:
        from krylov_tpu_torch.dist import solve_sharded

        return solve_sharded(A, b, x0, tol=tol, method=method, maxiter=maxiter, k=k, M=M, mesh=mesh,
                             scalar_dtype=scalar_dtype, basis_norm=basis_norm, spectral_bounds=spectral_bounds,
                             gather=False)
    if _zero_rows(b)[0]:
        return _zero_result(b, method, k, scalar_dtype, use_fused, restarts)
    bounds = _resolve_bounds(A, method, spectral_bounds)
    return _run_single(A, b, x0, tol, method, maxiter, k, scalar_dtype, use_fused, basis_norm, restarts, M,
                       bounds)


@tracing.entry_point
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
    ``maxiter`` runs one plain solve, as in the JAX package; below it the
    solve runs in chunks (:func:`_solve_chunked`).

    ``mesh=`` (a 1-D ``DeviceMesh`` from :func:`krylov_tpu_torch.dist.make_mesh`,
    called on every rank of an initialised ``torch.distributed`` world with
    the whole system) partitions the rows over the ranks and runs the eager
    loop of ``method`` on each rank's block (:func:`krylov_tpu_torch.dist.solve_sharded`):
    every reduction is one all-reduce, every SpMV one halo or all-gather
    exchange, a stencil's through K1 on the rank's slab.  ``x`` is then the
    whole solution on every rank, and ``info`` the same on every rank; its
    ``time`` starts after a barrier of the ranks.  ``restarts=``,
    ``chunk_iters=`` and ``fused=True`` raise ``ValueError`` with it;
    ``refine=`` takes its host-float64 defect on the whole operator and
    ``x``.
    """
    b_in = b
    with tracing.span("plan"):
        _check_options(method, mesh, M, spectral_bounds)
        if mesh is not None:
            _check_mesh_options(restarts, chunk_iters, fused)
            fused = False
        A, b, x0, maxiter_eff, use_fused, basis_norm_eff = _plan(
            A, b, x0, method, maxiter, M, scalar_dtype, fused, basis_norm
        )
    chunked = chunk_iters is not None and chunk_iters < maxiter_eff
    if chunked:
        if chunk_iters < 1:
            raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
        if restarts:
            raise ValueError(
                "chunk_iters= and restarts= are mutually exclusive (restarts already re-dispatches; "
                "chunk the outer solve OR defect-correct, not both)"
            )
    if verbose:
        start_banner(_METHOD_NAMES[method], k if method in _KSKIP_METHODS else None)

    on_cuda = A.device.type == "cuda"
    compile_time = bounds = None
    # b = 0: x = 0 at once (the mesh path decides on its all-reduced norm)
    if mesh is None and _zero_rows(b)[0]:
        result = _zero_result(b, method, k, scalar_dtype, use_fused, restarts)
        info = build_info(result, 0.0)
        if chunked:
            info["chunks"] = 0
    else:
        if on_cuda and _build.build_seconds is None and (use_fused or isinstance(A, StencilMatrix)):
            _build.library()  # the fused kernels, or K1 for the eager loops
            compile_time = _build.build_seconds
        bounds = _resolve_bounds(A, method, spectral_bounds)  # set-up, before the timed solve
        if mesh is not None:
            from krylov_tpu_torch.dist import solve_sharded

            result, elapsed = solve_sharded(
                A, b, x0, tol=tol, method=method, maxiter=maxiter_eff, k=k, M=M, mesh=mesh,
                scalar_dtype=scalar_dtype, basis_norm=basis_norm_eff, spectral_bounds=bounds, return_times=True)
            info = build_info(result, elapsed)
        elif chunked:
            # the chunks run fused only where the caller forced it: the carry
            # methods chunk exactly on their eager loops otherwise
            result, info = _solve_chunked(A, b, x0, tol, method, maxiter_eff, k, scalar_dtype, fused is True,
                                          basis_norm_eff, M, bounds, chunk_iters)
        else:
            if on_cuda:
                torch.cuda.synchronize(A.device)
            t0 = time.perf_counter()
            result = _run_single(A, b, x0, tol, method, maxiter_eff, k, scalar_dtype, use_fused, basis_norm_eff,
                                 restarts, M, bounds)
            if on_cuda:
                torch.cuda.synchronize(A.device)
            info = build_info(result, time.perf_counter() - t0)
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
    b64 = host64(b)
    b_norm = np.linalg.norm(b64)
    x64 = host64(x)
    if b_norm == 0:  # x is the front door's 0, exact
        info.update(converged=True, true_residual=0.0, refinements=0)
        return torch.from_numpy(x64).to(A.device)
    A_host = to_device(A, "cpu")  # one copy; the float64 matvecs read it
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


@tracing.entry_point
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
    ``lax.map``).  On the eager route every method runs the whole batch as
    one loop over ``(batch, N)`` blocks, each member freezing on its own
    (the JAX package's ``vmap``), through one K1 launch an SpMV on a
    stencil operator on the card (d launches a Chebyshev application of
    ``M``, for the whole block).  The loops that read the host (the
    adaptive k-skip guard, the ``cacg``/``camrr`` divergence guard) read
    the whole batch's flags at once, once an outer iteration; the adaptive
    loop steps its members grouped by their current k, and the CA loops
    run the advance on the members that advance and the rollback on those
    that roll back.  The spectral bounds of ``cacg``/``camrr`` are
    resolved once for the batch.  ``mesh=`` runs the batch
    row-partitioned, as one ``(batch, n_local)`` loop (one all-reduce a
    reduction for the whole batch), and returns the whole ``x`` on every
    rank; ``fused=True`` raises with it."""
    with tracing.span("plan"):
        _check_options(method, mesh, M, spectral_bounds)
        if mesh is not None:
            _check_mesh_options(fused=fused)
            fused = False
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
    tol = tracing.scalar_on(tol, A.dtype, A.device)
    if mesh is not None:
        from krylov_tpu_torch.dist import solve_sharded

        return solve_sharded(A, B, X0, tol=tol, method=method, maxiter=maxiter, k=k, M=M, mesh=mesh,
                             scalar_dtype=scalar_dtype, basis_norm=basis_norm, spectral_bounds=spectral_bounds)
    zero = _zero_rows(B)  # one host read for the batch, before any launch
    if not use_fused:
        bounds = None if all(zero) else _resolve_bounds(A, method, spectral_bounds)

        def run(B_, X0_):
            return _run_base(A, B_, X0_, tol, method, maxiter, k, scalar_dtype, False, basis_norm, M, bounds)
    else:
        def run(B_, X0_):
            return _stack_members([
                _run_base(A, B_[j], None if X0_ is None else X0_[j], tol, method, maxiter, k, scalar_dtype, True,
                          basis_norm)
                for j in range(B_.shape[0])
            ])
    return _skip_zero_members(run, B, X0, zero, method, k, scalar_dtype, use_fused)


def _stack_members(members: list) -> SolveResult:
    """The members' results stacked along a leading batch axis."""
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
