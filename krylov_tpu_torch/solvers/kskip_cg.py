"""Communication-avoiding k-skip CG as an eager loop.

Numerics follow :func:`krylov_tpu.solvers.kskip_cg.kskipcg_kernel`: each
outer iteration builds the Krylov bases ``Ar[0..k]`` and ``Ap[0..k+1]``,
reads the coefficient bundle

    a[j] = <Ar[j//2], Ar[j//2 + j%2]>      j = 0..2k
    f[j] = <Ap[j//2], Ap[j//2 + j%2]>      j = 0..2k+2   (f[2k+3] = 0, unread)
    c[j] = <Ar[j//2], Ap[j//2 + j%2]>      j = 0..2k+1

out of one Gram matrix of the stacked basis, and takes k+1 CG steps whose
inner products advance by scalar recurrences only.  The convergence test
reads ``sqrt(a[0]) = ||r||`` from the Gram.  ``basis_norm=True`` scales
each basis vector by a power of two of its norm and carries the scales in
the scalar dtype, rescaling the Gram so the bundle takes its exact values.

``b`` and ``x0`` may carry a leading batch axis ``(batch, n)``, as in
:mod:`krylov_tpu_torch.solvers.cg`: the Gram is then one batched product
``(batch, m, n) @ (batch, n, m)`` and every member freezes on its own.
``carry_in=((x, r, p), valid)`` (``valid`` a host bool) resumes from a
previous chunk's ``result.carry``; ``emit_carry=True`` returns it.
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
    safe_div,
    scalar_dtype_of,
    scale,
    set_at,
    synced_done,
    tree_select,
)


def inv_pow2(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``1 / s`` in ``v``'s dtype, shaped to scale ``v`` (a value per batch
    member); exact, as ``s`` is a power of two."""
    return bcast((1.0 / s).to(v.dtype), v)


def scaled_gram(ctx, V: list, scales: list) -> torch.Tensor:
    """The Gram of the true basis from its unit-scale rows ``V`` and their
    cumulative power-of-two ``scales`` (one per row and batch member):
    ``G(V) * outer(scales, scales)``, exact since the scales are powers of
    two."""
    cs = torch.stack(scales, -1)
    return ctx.gram(torch.stack(V, -2)) * (cs[..., :, None] * cs[..., None, :])


def cg_step_scalars(a: list, f: list, c: list, k: int) -> list:
    """``(alpha, beta)`` of the k+1 CG steps of one outer iteration, from
    the bundle lists ``a``/``f``/``c``.  The recurrences read no vector, so
    every step's scalars are known before the first vector update.  Each
    step advances the bundle entries ``l < 2(k - j) + 1`` together, as
    stacked tensors: the same operations on each entry, in the same order,
    as one entry at a time, for a few launches a step instead of a dozen an
    entry."""
    a, f, c = torch.stack(a), torch.stack(f), torch.stack(c)
    alpha = safe_div(a[0], f[1])
    out = [(alpha, safe_div(alpha**2 * f[2], a[0]) - 1)]
    for j in range(k):
        alpha, beta = out[-1]
        n = 2 * (k - j) + 1
        a_n = a[:n] + alpha * (alpha * f[2:n + 2] - 2 * c[1:n + 1])
        d = c[:n] - alpha * f[1:n + 1]
        c_n = a_n + d * beta
        f_n = c_n + beta * (d + beta * f[:n])
        a, c, f = torch.cat([a_n, a[n:]]), torch.cat([c_n, c[n:]]), torch.cat([f_n, f[n:]])
        alpha = safe_div(a[0], f[1])
        out.append((alpha, safe_div(alpha**2 * f[2], a[0]) - 1))
    return out


def kskipcg_kernel(
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
    state = carried(carry_in)
    if state is not None:
        x, r, p = state
    else:
        x = x0
        r = b - ctx.matvec(A, x0)
        p = r

    batch = b.shape[:-1]
    max_outer = -(-maxiter // (k + 1))  # i advances by k+1 an outer iteration
    rtrace = torch.zeros(batch + (max_outer + 1,), dtype=sdt, device=dev)
    ntrace = torch.zeros(batch + (max_outer + 1,), dtype=torch.int32, device=dev)
    i = torch.zeros(batch, dtype=torch.int64, device=dev)
    index = torch.zeros(batch, dtype=torch.int64, device=dev)
    conv = torch.zeros(batch, dtype=torch.bool, device=dev)
    K = k + 1  # offset of the Ap block in the stacked basis
    for step in range(max_outer):
        if basis_norm:
            # 1 + 2k SpMVs, as the raw chains; the rescaled Gram equals the
            # Gram of the true bases exactly
            Ap1 = ctx.matvec(A, p)
            s2 = ctx.dot_bundle([(r, r), (p, p), (Ap1, Ap1)])
            s_r0, s_p0, s_p1 = (pow2_scale(torch.sqrt(s2[j])) for j in range(3))
            Vr, Vp = [r * inv_pow2(s_r0, r)], [p * inv_pow2(s_p0, p), Ap1 * inv_pow2(s_p1, p)]
            c_r, c_p = [s_r0], [s_p0, s_p1]
            for _ in range(k):
                Wr, Wp = ctx.matvec(A, Vr[-1]), ctx.matvec(A, Vp[-1])
                n2 = ctx.dot_bundle([(Wr, Wr), (Wp, Wp)])
                nr, np_ = pow2_scale(torch.sqrt(n2[0])), pow2_scale(torch.sqrt(n2[1]))
                Vr.append(Wr * inv_pow2(nr, r))
                c_r.append(c_r[-1] * nr)
                Vp.append(Wp * inv_pow2(np_, p))
                c_p.append(c_p[-1] * np_)
            G = scaled_gram(ctx, Vr + Vp, c_r + c_p)
            Ap = [p, Ap1]  # the vector updates take the true p and A p
        else:
            Ar = [r]
            for _ in range(k):
                Ar.append(ctx.matvec(A, Ar[-1]))
            Ap = [p]
            for _ in range(k + 1):
                Ap.append(ctx.matvec(A, Ap[-1]))
            G = ctx.gram(torch.stack(Ar + Ap, -2))

        a = [G[..., j // 2, j // 2 + j % 2] for j in range(2 * k + 1)]
        f = [G[..., K + j // 2, K + j // 2 + j % 2] for j in range(2 * k + 3)]
        f.append(torch.zeros_like(f[0]))  # f[2k+3], unread
        cc = [G[..., j // 2, K + j // 2 + j % 2] for j in range(2 * k + 2)]

        res = torch.sqrt(a[0]) / b_norm
        set_at(rtrace, index, res)
        conv = res < tol_t

        # k+1 CG steps driven by the scalar recurrences
        x_n, r_n, p_cur, Ap_cur = x, r, Ap[0], Ap[1]
        for t, (alpha, beta) in enumerate(cg_step_scalars(a, f, cc, k)):
            if t:
                Ap_cur = ctx.matvec(A, p_cur)
            x_n = x_n + scale(alpha, p_cur)
            r_n = r_n - scale(alpha, Ap_cur)
            p_cur = r_n + scale(beta, p_cur)

        x, r, p = tree_select(conv, (x, r, p), (x_n, r_n, p_cur))
        i = torch.where(conv, i, i + (k + 1))
        index = torch.where(conv, index, index + 1)
        set_at(ntrace, index, i, keep=conv)
        if synced_done(step, conv):
            break

    record_final(rtrace, index, conv, ctx.norm(r) / b_norm)
    return SolveResult(
        x=x, residual_trace=rtrace, nosl_trace=ntrace, iterations=i, index=index, converged=conv,
        carry=(x, r, p) if emit_carry else None,
    )
