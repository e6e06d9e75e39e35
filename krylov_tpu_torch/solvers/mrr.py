"""MrR (minimum-residual 2-term recurrence) as an eager loop.

Numerics follow :func:`krylov_tpu.solvers.mrr.mrr_kernel`: an initial
half-iteration sets ``zeta = <r,Ar>/<Ar,Ar>``, ``y = zeta Ar``,
``z = -zeta r``; each iteration then computes ``gamma = <y,Ar>/<y,y>``,
``s = Ar - gamma y``, ``zeta = <r,s>/<s,s>``, ``eta = -zeta gamma`` and
updates ``y, z, r, x`` by the 2-term recurrences.  ``b`` and ``x0`` may
carry a leading batch axis, as in :mod:`krylov_tpu_torch.solvers.cg`.

``carry_in=((x, r, y, z), valid)`` (``valid`` a host bool) resumes from a
previous chunk's ``result.carry``: the loop skips the half-iteration and
starts its update count and trace at 0, so the body records the carried
residual in slot 0.  ``emit_carry=True`` returns the state after the loop.
"""

from __future__ import annotations

import torch

from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import (
    SolveResult,
    bcast,
    carried,
    record_final,
    safe_div,
    scalar_dtype_of,
    scale,
    set_at,
    synced_done,
    tree_select,
)


def mrr_kernel(
    A, b: torch.Tensor, x0: torch.Tensor, *, tol: float = 1e-5, maxiter: int,
    ctx: Context = DEFAULT_CONTEXT, carry_in=None, emit_carry: bool = False,
) -> SolveResult:
    dev, dt = b.device, b.dtype
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    batch = b.shape[:-1]
    trace = torch.zeros(batch + (maxiter + 1,), dtype=sdt, device=dev)

    state = carried(carry_in)
    if state is not None:
        x, r, y, z = state
        i0 = 0
    else:
        # initial residual + half-iteration
        r = b - ctx.matvec(A, x0)
        trace[..., 0] = ctx.norm(r) / b_norm
        Ar = ctx.matvec(A, r)
        rAr, ArAr = ctx.dot_bundle([(r, Ar), (Ar, Ar)])
        zeta = safe_div(rAr, ArAr)
        y = scale(zeta, Ar)
        z = scale(-zeta, r)
        r = r - y
        x = x0 - z
        i0 = 1

    i = torch.full(batch, i0, dtype=torch.int64, device=dev)
    conv = torch.zeros(batch, dtype=torch.bool, device=dev)
    for step in range(maxiter - i0):
        Ar = ctx.matvec(A, r)
        rr, mu, nu = ctx.dot_bundle([(r, r), (y, y), (y, Ar)])
        res = torch.sqrt(rr) / b_norm
        set_at(trace, i, res)
        conv = res < tol

        gamma = safe_div(nu, mu)
        s = Ar - scale(gamma, y)
        rs, ss = ctx.dot_bundle([(r, s), (s, s)])
        zeta = safe_div(rs, ss)
        eta = -zeta * gamma
        eta, zeta = bcast(eta, y), bcast(zeta, y)
        y_n = (eta * y.to(sdt) + zeta * Ar.to(sdt)).to(dt)
        z_n = (eta * z.to(sdt) - zeta * r.to(sdt)).to(dt)
        r_n = r - y_n
        x_n = x - z_n

        x, r, y, z = tree_select(conv, (x, r, y, z), (x_n, r_n, y_n, z_n))
        i = i + (~conv).to(i.dtype)
        if synced_done(step, conv):
            break

    record_final(trace, i, conv, ctx.norm(r) / b_norm)
    return SolveResult(
        x=x,
        residual_trace=trace,
        nosl_trace=torch.arange(maxiter + 1, dtype=torch.int32, device=dev).expand_as(trace),
        iterations=i,
        index=i,
        converged=conv,
        carry=(x, r, y, z) if emit_carry else None,
    )
