"""Conjugate gradient as an eager loop (any operator with ``matvec``).

Numerics follow :func:`krylov_tpu.solvers.cg.cg_kernel`: per iteration one
SpMV, ``sigma = <p, Ap>``, ``alpha = gamma/sigma``, ``x += alpha p``,
``r -= alpha v``, ``beta = gamma'/gamma``, ``p = r + beta p``, with
convergence on ``||r||/||b|| < tol`` checked before the update.

``b`` and ``x0`` may carry a leading batch axis ``(batch, n)``: the batch
then runs as one loop over ``(batch, n)`` blocks, each member with its own
counters, trace row and convergence point, as ``jax.vmap`` of the JAX
solver gives them.

``carry_in=((x, r, p, gamma), valid)`` resumes the recurrence exactly from
a previous chunk's ``result.carry`` when the host bool ``valid`` is true;
``emit_carry=True`` returns the state after the loop in ``result.carry``
(``solve(chunk_iters=)``).
"""

from __future__ import annotations

import torch

from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import (
    SolveResult,
    carried,
    record_final,
    run_bodies,
    safe_div,
    scalar_dtype_of,
    scale,
    set_at,
    tree_select,
)


def cg_kernel(
    A, b: torch.Tensor, x0: torch.Tensor, *, tol: float = 1e-5, maxiter: int,
    ctx: Context = DEFAULT_CONTEXT, carry_in=None, emit_carry: bool = False,
) -> SolveResult:
    dev = b.device
    b_norm = ctx.norm(b)
    state = carried(carry_in)
    if state is not None:
        x, r, p, gamma = state
    else:
        x = x0
        r = b - ctx.matvec(A, x0)
        p = r
        gamma = ctx.dot(r, r)

    batch = b.shape[:-1]
    trace = torch.zeros(batch + (maxiter + 1,), dtype=scalar_dtype_of(ctx, b), device=dev)
    i = torch.zeros(batch, dtype=torch.int64, device=dev)
    conv = torch.zeros(batch, dtype=torch.bool, device=dev)

    def body(state):
        tol, b_norm, x, r, p, gamma, trace, i, conv = state
        res = torch.sqrt(gamma) / b_norm
        set_at(trace, i, res)
        conv = res < tol

        v = ctx.matvec(A, p)
        alpha = safe_div(gamma, ctx.dot(p, v))
        x_n = x + scale(alpha, p)
        r_n = r - scale(alpha, v)
        gamma_n = ctx.dot(r_n, r_n)
        p_n = r_n + scale(safe_div(gamma_n, gamma), p)

        x, r, p, gamma = tree_select(conv, (x, r, p, gamma), (x_n, r_n, p_n, gamma_n))
        i = i + (~conv).to(i.dtype)
        return tol, b_norm, x, r, p, gamma, trace, i, conv

    *_, x, r, p, gamma, trace, i, conv = run_bodies(body, (tol, b_norm, x, r, p, gamma, trace, i, conv), maxiter,
                                                    ctx)
    record_final(trace, i, conv, torch.sqrt(gamma) / b_norm)
    return SolveResult(
        x=x,
        residual_trace=trace,
        nosl_trace=torch.arange(maxiter + 1, dtype=torch.int32, device=dev).expand_as(trace),
        iterations=i,
        index=i,
        converged=conv,
        carry=(x, r, p, gamma) if emit_carry else None,
    )
