"""Communication-avoiding k-skip MrR as an eager loop.

Numerics follow :func:`krylov_tpu.solvers.kskip_mrr.kskipmrr_kernel`: an
MrR init half-step, then outer iterations that build the bases
``Ar[0..k+1]`` and ``Ay[0..k]``, read the bundle

    alpha[j] = <Ar[j//2], Ar[j//2 + j%2]>   j = 0..2k+2
    beta[j]  = <Ay[j//2], Ar[j//2 + j%2]>   j = 1..2k+1   (beta[0] = 0)
    delta[j] = <Ay[j//2], Ay[j//2 + j%2]>   j = 0..2k

out of one Gram matrix of the stacked basis, and take k+1 MrR steps by
scalar recurrences, each with one SpMV ``Ar[1] = A r``.  ``Ar[1]`` is
carried across outer iterations (seeded by one SpMV after the init step),
so an outer iteration does not recompute it.  ``basis_norm=True`` scales
the chains by powers of two as in :mod:`.kskip_cg`.

``b`` and ``x0`` may carry a leading batch axis, as in :mod:`.kskip_cg`.
``carry_in=((x, r, y, z, Ar1), valid)`` (``valid`` a host bool) resumes
from a previous chunk's ``result.carry``, ``Ar1`` included so the chunk
does not recompute it: the loop skips the init half-step and starts its
update and outer counts at 0.  ``emit_carry=True`` returns that state.
"""

from __future__ import annotations

from typing import Optional

import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import (
    SolveResult,
    bcast,
    carried,
    pow2_scale,
    record_final,
    run_bodies,
    safe_div,
    scalar_dtype_of,
    scale,
    set_at,
    tree_select,
)
from krylov_tpu_torch.solvers.kskip_cg import inv_pow2, scaled_gram


def mrr_half_step(ctx, A, b, x_in):
    """The MrR init half-step from ``x_in``: ``zeta = <r,Ar>/<Ar,Ar>``,
    ``y = zeta Ar``, ``z = -zeta r``, then ``r -= y``, ``x = x_in - z`` and
    the carried ``Ar[1] = A r``.  Returns ``(x, r, y, z, Ar1, r_in)`` with
    ``r_in = b - A x_in``."""
    r_in = b - ctx.matvec(A, x_in)
    Ar1 = ctx.matvec(A, r_in)
    rAr, ArAr = ctx.dot_bundle([(r_in, Ar1), (Ar1, Ar1)])
    zeta = safe_div(rAr, ArAr)
    y = scale(zeta, Ar1)
    z = scale(-zeta, r_in)
    r = r_in - y
    return x_in - z, r, y, z, ctx.matvec(A, r), r_in


def mrr_step_scalars(alpha: list, beta: list, delta: list, k: int) -> list:
    """``(zeta, eta)`` of the k+1 MrR steps of one outer iteration, from
    the bundle lists (``beta[0]`` must be 0; all three are advanced in place
    by the recurrences, which read no vector).  Each step advances the
    entries ``2 <= l < 2(k - j) + 1`` together, as stacked tensors: the
    same operations on each entry, in the same order, as one entry at a
    time."""

    def coefs():
        d = alpha[2] * delta[0] - beta[1] ** 2
        return safe_div(alpha[1] * delta[0], d), -safe_div(alpha[1] * beta[1], d)

    out = [coefs()]
    for j in range(k):
        zeta, eta = out[-1]
        delta[0] = zeta**2 * alpha[2] + eta * zeta * beta[1]
        alpha[0] = alpha[0] - zeta * alpha[1]
        delta[1] = eta**2 * delta[1] + 2 * eta * zeta * beta[2] + zeta**2 * alpha[3]
        beta[1] = eta * beta[1] + zeta * alpha[2] - delta[1]
        alpha[1] = -beta[1]
        n = 2 * (k - j) + 1
        dl, bl, al = torch.stack(delta[2:n]), torch.stack(beta[2:n + 1]), torch.stack(alpha[2:n + 2])
        delta_n = eta**2 * dl + 2 * eta * zeta * bl[1:] + zeta**2 * al[2:]
        tau = eta * bl[:-1] + zeta * al[1:-1]
        beta_n = tau - delta_n
        alpha_n = al[:-2] - tau - beta_n
        delta[2:n], beta[2:n], alpha[2:n] = delta_n.unbind(0), beta_n.unbind(0), alpha_n.unbind(0)
        out.append(coefs())
    return out


def _vector_step(ctx, A, sdt, zeta, eta, x, r, y, z, Ar1):
    vdt = r.dtype
    zeta, eta = bcast(zeta, r), bcast(eta, r)
    y = (eta * y.to(sdt) + zeta * Ar1.to(sdt)).to(vdt)
    z = (eta * z.to(sdt) - zeta * r.to(sdt)).to(vdt)
    r = r - y
    return x - z, r, y, z, ctx.matvec(A, r)


def kskipmrr_outer(ctx, A, k: int, basis_norm: bool, state):
    """One outer iteration from ``state = (x, r, y, z, Ar1)``: the bundle,
    then k+1 MrR steps.  Returns ``(alpha[0], new state)``; ``alpha[0]`` is
    ``<r, r>`` of the incoming ``r``."""
    x, r, y, z, Ar1 = state
    sdt = scalar_dtype_of(ctx, r)
    if basis_norm:
        # unit-scale chains with their cumulative power-of-two scales; the
        # rescaled Gram equals the Gram of the true bases exactly
        s2 = ctx.dot_bundle([(r, r), (Ar1, Ar1), (y, y)])
        s_r0, s_r1, s_y0 = (pow2_scale(torch.sqrt(s2[j])) for j in range(3))
        Vr, Vy = [r * inv_pow2(s_r0, r), Ar1 * inv_pow2(s_r1, r)], [y * inv_pow2(s_y0, r)]
        c_r, c_y = [s_r0, s_r1], [s_y0]
        for _ in range(k):
            Wr, Wy = ctx.matvec(A, Vr[-1]), ctx.matvec(A, Vy[-1])
            n2 = ctx.dot_bundle([(Wr, Wr), (Wy, Wy)])
            nr, ny = pow2_scale(torch.sqrt(n2[0])), pow2_scale(torch.sqrt(n2[1]))
            Vr.append(Wr * inv_pow2(nr, r))
            c_r.append(c_r[-1] * nr)
            Vy.append(Wy * inv_pow2(ny, r))
            c_y.append(c_y[-1] * ny)
        G = scaled_gram(ctx, Vr + Vy, c_r + c_y)
    else:
        Ar = [r, Ar1]  # Ar[1] carried: 2k SpMVs
        for _ in range(k):
            Ar.append(ctx.matvec(A, Ar[-1]))
        Ay = [y]
        for _ in range(k):
            Ay.append(ctx.matvec(A, Ay[-1]))
        G = ctx.gram(torch.stack(Ar + Ay, -2))

    KA = k + 2  # offset of the Ay block in the stacked basis
    alpha = [G[..., j // 2, j // 2 + j % 2] for j in range(2 * k + 3)]
    beta = [torch.zeros_like(alpha[0])] + [G[..., KA + j // 2, j // 2 + j % 2] for j in range(1, 2 * k + 2)]
    delta = [G[..., KA + j // 2, KA + j // 2 + j % 2] for j in range(2 * k + 1)]
    alpha0 = alpha[0]
    for zeta, eta in mrr_step_scalars(alpha, beta, delta, k):
        state = _vector_step(ctx, A, sdt, zeta, eta, *state)
    return alpha0, state


def kskipmrr_kernel(
    A, b: torch.Tensor, x0: torch.Tensor, *, tol: float = 1e-5, maxiter: int,
    k: int = 0, ctx: Context = DEFAULT_CONTEXT, basis_norm: bool = False,
    b_norm: Optional[torch.Tensor] = None, carry_in=None, emit_carry: bool = False,
) -> SolveResult:
    # b_norm divides the residuals (default ||b||): the plain K5/K6 pass
    # that of the unshifted b
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    dev = b.device
    sdt = scalar_dtype_of(ctx, b)
    tol_t = tracing.scalar_on(tol, b.dtype, dev)
    b_norm = ctx.norm(b) if b_norm is None else b_norm

    # index grows by 1 an outer iteration, i by k+1; both start at 1 (0
    # with a carry)
    batch = b.shape[:-1]
    max_index = 1 + max(0, -(-(maxiter - 1) // (k + 1))) if maxiter > 0 else 1
    rtrace = torch.zeros(batch + (max_index + 1,), dtype=sdt, device=dev)
    ntrace = torch.zeros(batch + (max_index + 1,), dtype=torch.int32, device=dev)
    state = carried(carry_in)
    if state is not None:
        i0 = 0
    else:
        *state, r0 = mrr_half_step(ctx, A, b, x0)
        rtrace[..., 0] = ctx.norm(r0) / b_norm
        ntrace[..., 1] = 1
        i0 = 1

    i = torch.full(batch, i0, dtype=torch.int64, device=dev)
    index = torch.full(batch, i0, dtype=torch.int64, device=dev)
    conv = torch.zeros(batch, dtype=torch.bool, device=dev)

    def body(loop):
        tol_t, b_norm, *state, rtrace, ntrace, i, index, conv = loop
        alpha0, new = kskipmrr_outer(ctx, A, k, basis_norm, state)
        res = torch.sqrt(alpha0) / b_norm
        set_at(rtrace, index, res)
        conv = res < tol_t
        state = tree_select(conv, state, new)
        i = torch.where(conv, i, i + (k + 1))
        index = torch.where(conv, index, index + 1)
        set_at(ntrace, index, i, keep=conv)
        return tol_t, b_norm, *state, rtrace, ntrace, i, index, conv

    outer = max(0, -(-(maxiter - i0) // (k + 1)))  # while i < maxiter
    _, _, *state, rtrace, ntrace, i, index, conv = run_bodies(
        body, (tol_t, b_norm, *state, rtrace, ntrace, i, index, conv), outer, ctx)

    x, r = state[0], state[1]
    record_final(rtrace, index, conv, ctx.norm(r) / b_norm)
    return SolveResult(
        x=x, residual_trace=rtrace, nosl_trace=ntrace, iterations=i, index=index, converged=conv,
        carry=tuple(state) if emit_carry else None,
    )
