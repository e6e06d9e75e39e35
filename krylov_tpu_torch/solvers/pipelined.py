"""The preconditioned and communication-hiding CG family as eager loops:
preconditioned CG, Chronopoulos–Gear, Gropp and Ghysels–Vanroose
pipelined CG.

Numerics follow :mod:`krylov_tpu.solvers.pipelined` (the textbook
algorithms, with ``gamma`` carried and ``m = M^-1 w``); ``M`` is any
operator (a container, a :class:`~krylov_tpu_torch.precond.ChebyshevPreconditioner`)
or None, applied through ``ctx.matvec``.  Each loop keeps the JAX
package's per-iteration state and its freeze once converged, and reads
convergence on the host every :data:`~krylov_tpu_torch.solvers._common.SYNC_EVERY`
iterations.  Chronopoulos–Gear and Gropp still move ``x``, ``r`` and the
counter on the step that converges, as the JAX package's loops do, so once
a member has converged, every later body keeps all of its state.  ``b`` and
``x0`` may carry a leading batch axis, as in :mod:`krylov_tpu_torch.solvers.cg`.
"""

from __future__ import annotations

import torch

from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import (
    SolveResult,
    record_final,
    safe_div,
    scalar_dtype_of,
    scale,
    set_at,
    synced_done,
    tree_select,
)


def _apply_M(ctx, M, v):
    return v if M is None else ctx.matvec(M, v)


def _start(b: torch.Tensor, maxiter: int, sdt):
    """The residual trace, the update counter and the convergence flag."""
    batch, dev = b.shape[:-1], b.device
    return (torch.zeros(batch + (maxiter + 1,), dtype=sdt, device=dev),
            torch.zeros(batch, dtype=torch.int64, device=dev),
            torch.zeros(batch, dtype=torch.bool, device=dev))


def _finish(ctx, b_norm, maxiter, x, r, i, conv, trace) -> SolveResult:
    """Shared tail: the diverged exit's residual, the result."""
    record_final(trace, i, conv, ctx.norm(r) / b_norm)
    return SolveResult(
        x=x,
        residual_trace=trace,
        nosl_trace=torch.arange(maxiter + 1, dtype=torch.int32, device=x.device).expand_as(trace),
        iterations=i,
        index=i,
        converged=conv,
    )


def pcg_kernel(A, b, x0, *, tol=1e-5, maxiter: int, M=None, ctx: Context = DEFAULT_CONTEXT) -> SolveResult:
    """Preconditioned CG; with ``M=None`` the same bits as
    :func:`~krylov_tpu_torch.solvers.cg.cg_kernel`."""
    b_norm = ctx.norm(b)
    x = x0
    r = b - ctx.matvec(A, x0)
    u = _apply_M(ctx, M, r)
    p = u
    ru = ctx.dot(r, u)
    trace, i, conv = _start(b, maxiter, scalar_dtype_of(ctx, b))
    for step in range(maxiter):
        res = torch.sqrt(ctx.dot(r, r)) / b_norm
        set_at(trace, i, res)
        conv = res < tol

        s = ctx.matvec(A, p)
        alpha = safe_div(ru, ctx.dot(s, p))
        x_n = x + scale(alpha, p)
        r_n = r - scale(alpha, s)
        u_n = _apply_M(ctx, M, r_n)
        ru_n = ctx.dot(r_n, u_n)
        p_n = u_n + scale(safe_div(ru_n, ru), p)

        x, r, u, p, ru = tree_select(conv, (x, r, u, p, ru), (x_n, r_n, u_n, p_n, ru_n))
        i = i + (~conv).to(i.dtype)
        if synced_done(step, conv):
            break
    return _finish(ctx, b_norm, maxiter, x, r, i, conv, trace)


def chronopoulos_gear_kernel(A, b, x0, *, tol=1e-5, maxiter: int, M=None,
                             ctx: Context = DEFAULT_CONTEXT) -> SolveResult:
    """Chronopoulos–Gear CG: one bundle of three inner products an
    iteration."""
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    x = x0
    r = b - ctx.matvec(A, x0)
    u = _apply_M(ctx, M, r)
    w = ctx.matvec(A, u)
    gamma, delta, rr = ctx.dot_bundle([(r, u), (w, u), (r, r)])
    # safe_div: an exact warm start (r0 = 0) gives 0 / 0 here
    alpha = safe_div(gamma, delta)
    beta = torch.zeros_like(gamma)
    p = torch.zeros_like(r)
    s = torch.zeros_like(r)
    trace, i, conv = _start(b, maxiter, sdt)
    trace[..., 0] = torch.sqrt(rr) / b_norm
    # the loop tests the residual after each step; r0 is tested here, so a
    # start already below tol keeps x0 and takes no step
    conv = trace[..., 0] < tol
    for step in range(maxiter):
        p_n = u + scale(beta, p)
        s_n = w + scale(beta, s)
        x_n = x + scale(alpha, p_n)
        r_n = r - scale(alpha, s_n)
        u_n = _apply_M(ctx, M, r_n)
        w_n = ctx.matvec(A, u_n)
        gamma_n, delta_n, rr_n = ctx.dot_bundle([(r_n, u_n), (w_n, u_n), (r_n, r_n)])
        res = torch.sqrt(rr_n) / b_norm
        set_at(trace, i + 1, res, keep=conv)
        conv_n = res < tol

        beta_n = safe_div(gamma_n, gamma)
        alpha_n = safe_div(gamma_n, delta_n - beta_n * safe_div(gamma_n, alpha))
        # the converging step moves x and r only
        u_n, w_n, p_n, s_n, gamma_n, alpha_n, beta_n = tree_select(
            conv_n, (u, w, p, s, gamma, alpha, beta), (u_n, w_n, p_n, s_n, gamma_n, alpha_n, beta_n))
        x, r, u, w, p, s, gamma, alpha, beta = tree_select(
            conv, (x, r, u, w, p, s, gamma, alpha, beta), (x_n, r_n, u_n, w_n, p_n, s_n, gamma_n, alpha_n, beta_n))
        i = i + (~conv).to(i.dtype)
        conv = conv | conv_n
        if synced_done(step, conv):
            break
    return _finish(ctx, b_norm, maxiter, x, r, i, conv, trace)


def gropp_kernel(A, b, x0, *, tol=1e-5, maxiter: int, M=None, ctx: Context = DEFAULT_CONTEXT) -> SolveResult:
    """Gropp's asynchronous CG: <p, s> and <r, u> at different points of
    the iteration."""
    b_norm = ctx.norm(b)
    x = x0
    r = b - ctx.matvec(A, x0)
    u = _apply_M(ctx, M, r)
    p = u
    s = ctx.matvec(A, p)
    gamma = ctx.dot(r, u)
    trace, i, conv = _start(b, maxiter, scalar_dtype_of(ctx, b))
    trace[..., 0] = ctx.norm(r) / b_norm
    for step in range(maxiter):
        delta = ctx.dot(p, s)
        q = _apply_M(ctx, M, s)
        alpha = safe_div(gamma, delta)
        x_n = x + scale(alpha, p)
        r_n = r - scale(alpha, s)
        u_n = u - scale(alpha, q)
        gamma_n, rr_n = ctx.dot_bundle([(r_n, u_n), (r_n, r_n)])
        w = ctx.matvec(A, u_n)
        res = torch.sqrt(rr_n) / b_norm
        set_at(trace, i + 1, res, keep=conv)
        conv_n = res < tol

        beta = safe_div(gamma_n, gamma)
        p_n = u_n + scale(beta, p)
        s_n = w + scale(beta, s)
        u_n, p_n, s_n, gamma_n = tree_select(conv_n, (u, p, s, gamma), (u_n, p_n, s_n, gamma_n))
        x, r, u, p, s, gamma = tree_select(conv, (x, r, u, p, s, gamma), (x_n, r_n, u_n, p_n, s_n, gamma_n))
        i = i + (~conv).to(i.dtype)
        conv = conv | conv_n
        if synced_done(step, conv):
            break
    return _finish(ctx, b_norm, maxiter, x, r, i, conv, trace)


def pipelined_cg_kernel(A, b, x0, *, tol=1e-5, maxiter: int, M=None, ctx: Context = DEFAULT_CONTEXT,
                        replace_every: int = 25) -> SolveResult:
    """Ghysels–Vanroose pipelined CG: one bundle an iteration, beside the
    preconditioner and the SpMV on ``w``.

    ``replace_every``: every that many iterations (0: never) the recurred
    vectors are recomputed from their definitions (``r = b - A x``,
    ``u = M r``, ``w = A u``, ``s = A p``, ``q = M s``, ``z = A q``), as
    in the JAX package.  Its ``lax.cond`` on ``(i + 1) % replace_every == 0``
    and not converged is read here from the loop's step: a member's ``i``
    equals the step until it converges, and a converged member keeps its
    state whatever the step computed."""
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    x = x0
    r = b - ctx.matvec(A, x0)
    u = _apply_M(ctx, M, r)
    w = ctx.matvec(A, u)
    zv = q = s = p = torch.zeros_like(r)
    trace, i, conv = _start(b, maxiter, sdt)
    gamma = torch.ones(b.shape[:-1], dtype=sdt, device=b.device)
    alpha = torch.ones_like(gamma)
    zero = torch.zeros_like(gamma)
    for step in range(maxiter):
        gamma_n, delta, rr = ctx.dot_bundle([(r, u), (w, u), (r, r)])
        m = _apply_M(ctx, M, w)
        nvec = ctx.matvec(A, m)
        res = torch.sqrt(rr) / b_norm
        set_at(trace, i, res)
        conv = res < tol

        first = i == 0
        beta = torch.where(first, zero, safe_div(gamma_n, gamma))
        alpha_n = torch.where(first, safe_div(gamma_n, delta),
                              safe_div(gamma_n, delta - beta * safe_div(gamma_n, alpha)))
        z_n = nvec + scale(beta, zv)
        q_n = m + scale(beta, q)
        s_n = w + scale(beta, s)
        p_n = u + scale(beta, p)
        x_n = x + scale(alpha_n, p_n)
        r_n = r - scale(alpha_n, s_n)
        u_n = u - scale(alpha_n, q_n)
        w_n = w - scale(alpha_n, z_n)
        if replace_every and (step + 1) % replace_every == 0:
            r_n = b - ctx.matvec(A, x_n)
            u_n = _apply_M(ctx, M, r_n)
            w_n = ctx.matvec(A, u_n)
            s_n = ctx.matvec(A, p_n)
            q_n = _apply_M(ctx, M, s_n)
            z_n = ctx.matvec(A, q_n)

        x, r, u, w, zv, q, s, p, gamma, alpha = tree_select(
            conv, (x, r, u, w, zv, q, s, p, gamma, alpha), (x_n, r_n, u_n, w_n, z_n, q_n, s_n, p_n, gamma_n, alpha_n))
        i = i + (~conv).to(i.dtype)
        if synced_done(step, conv):
            break
    return _finish(ctx, b_norm, maxiter, x, r, i, conv, trace)
