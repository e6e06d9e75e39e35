"""Communication-avoiding CG and MrR with a Chebyshev s-step basis, as
eager loops: ``cacg`` and ``camrr``.

Numerics follow :mod:`krylov_tpu.solvers.cacg`.  Each outer iteration
builds shifted-scaled Chebyshev chains on ``[lmin, lmax]`` (or the raw
monomial chains, ``basis="monomial"``), takes ONE Gram matrix of the
stacked basis (``ctx.gram``), runs s CG (or MrR) steps on coefficient
vectors through the host-built change-of-basis matrix ``T``, recovers the
iterates as combinations of the basis rows and replaces the residual by
``b - A x``.

The divergence guard of the JAX package: an outer iteration whose entry
residual is not finite or above ``_GUARD_GROWTH`` times the best one seen
rolls back to the best iterate and restarts from its true residual, and an
exhausted solve returns the best iterate.  Its ``lax.cond`` becomes a
branch on the host: the guard and the convergence test are read together,
one host read an outer iteration, and only the branch taken runs (the
loops are host-bound, so a sync costs less than the launches of the branch
not taken).  A rollback outer iteration still advances the update count
by s, as in the JAX package.

The small products of the s steps and the recovery combinations multiply
and sum elementwise, and the Gram goes through
:meth:`~krylov_tpu_torch.context.Context.gram`, so a float32 solve on the
card does not depend on ``torch.backends.cuda.matmul.allow_tf32`` (the JAX
package pins ``Precision.HIGHEST``).

``carry_in=(state, valid)`` (``valid`` a host bool) resumes from a
previous chunk's ``result.carry``: ``(x, r, p, x_best, res_best)`` for
cacg, ``(x, r, y, z, x_best, res_best)`` for camrr, so the guard's best
iterate crosses the chunk boundary; camrr then skips its half-step and
starts its counts at 0.  ``emit_carry=True`` returns the state after the
loop (before the best-iterate exit).
"""

from __future__ import annotations

import numpy as np
import torch

from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import (
    SolveResult,
    carried,
    record_final,
    safe_div,
    scalar_dtype_of,
    scale,
    tree_select,
)

# an outer iteration whose entry residual exceeds this multiple of the best
# one seen rolls back (krylov_tpu.solvers.cacg._GUARD_GROWTH)
_GUARD_GROWTH = 10.0


def _chebyshev_T(m: int, blocks, lmin: float, lmax: float) -> np.ndarray:
    """Change-of-basis matrix of shifted-scaled Chebyshev chains: ``blocks``
    lists ``(offset, n_applied)`` per chain, and ``T[:, j]`` holds the
    coefficients of ``A V[j]`` in the basis, from ``A rho_0 = c rho_1 +
    d rho_0`` and ``A rho_j = (c/2) rho_{j+1} + d rho_j + (c/2) rho_{j-1}``
    with ``d = (lmax + lmin)/2``, ``c = (lmax - lmin)/2``."""
    d = 0.5 * (lmax + lmin)
    c = 0.5 * (lmax - lmin)
    T = np.zeros((m, m), dtype=np.float64)
    for off, cols in blocks:
        if cols <= 0:
            continue
        T[off + 0, off + 0] = d
        T[off + 1, off + 0] = c
        for j in range(1, cols):
            T[off + j - 1, off + j] = 0.5 * c
            T[off + j, off + j] = d
            T[off + j + 1, off + j] = 0.5 * c
    return T


def _monomial_T(m: int, blocks) -> np.ndarray:
    """Change-of-basis matrix of the raw monomial chains (``A V_j =
    V_{j+1}``), the ablation."""
    T = np.zeros((m, m), dtype=np.float64)
    for off, cols in blocks:
        for j in range(cols):
            T[off + j + 1, off + j] = 1.0
    return T


def _basis(basis: str, m: int, blocks, lmin: float, lmax: float):
    """``(T, d, c)``: the change of basis and the Chebyshev shift and
    scale (0 for the monomial basis)."""
    if basis == "chebyshev":
        if not (lmax > lmin >= 0.0):
            raise ValueError(f"chebyshev basis needs spectral bounds lmax > lmin >= 0, got [{lmin}, {lmax}]")
        return _chebyshev_T(m, blocks, lmin, lmax), 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    if basis == "monomial":
        return _monomial_T(m, blocks), 0.0, 0.0
    raise ValueError(f"unknown basis {basis!r}")


def _chain(ctx, A, v0, length: int, chebyshev: bool, d: float, c: float) -> list:
    """``[rho_0(A) v0 .. rho_{length-1}(A) v0]`` by the 3-term recurrence
    (the monomial chain: powers of A)."""
    vdt = v0.dtype
    chain = [v0]
    if length >= 2:
        Av = ctx.matvec(A, v0)
        chain.append(((Av - d * v0) / c).to(vdt) if chebyshev else Av)
    for _ in range(length - 2):
        Av = ctx.matvec(A, chain[-1])
        chain.append(((2.0 / c) * (Av - d * chain[-1]) - chain[-2]).to(vdt) if chebyshev else Av)
    return chain


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` multiplied and summed elementwise (see the module note)."""
    return (M * v).sum(-1)


def _vdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(-1)


def _combine(coeffs: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``coeffs @ V``, a combination of the basis rows, elementwise."""
    return (coeffs.to(V.dtype)[:, None] * V).sum(0)


def _unit(m: int, j: int, sdt, dev) -> torch.Tensor:
    e = torch.zeros(m, dtype=sdt, device=dev)
    e[j] = 1.0
    return e


def _guard(res, res_best, x, x_best):
    """The divergence guard's reading of an outer iteration's entry
    residual: ``(bad, x_best, res_best)``."""
    bad = ~torch.isfinite(res) | (res > _GUARD_GROWTH * res_best)
    better = torch.isfinite(res) & (res < res_best)
    x_best, res_best = tree_select(better, (x, res), (x_best, res_best))
    return bad, x_best, res_best


def _read_guard(res, res_best, x, x_best, tol):
    """The outer iteration's one host read: ``(bad, converged, x_best,
    res_best)``, the guard's reading of the entry residual ``res``."""
    conv = res < tol
    bad, x_best, res_best = _guard(res, res_best, x, x_best)
    bad, conv = torch.stack((bad, conv)).tolist()
    return bad, conv, x_best, res_best


def _best_exit(ctx, b_norm, x, r, x_best, res_best, conv: bool, i: int, index: int, rtrace, ntrace,
               carry=None) -> SolveResult:
    """On exhaustion the best iterate, never a diverged one; the final
    residual written unless converged.  ``carry`` is the loop's state for
    ``emit_carry``."""
    dev = x.device
    conv = torch.tensor(conv, device=dev)
    index = torch.tensor(index, device=dev)
    final_res = ctx.norm(r) / b_norm
    use_best = ~conv & (res_best < final_res)
    x = torch.where(use_best, x_best, x)
    record_final(rtrace, index, conv, torch.where(use_best, res_best, final_res))
    return SolveResult(x=x, residual_trace=rtrace, nosl_trace=ntrace, iterations=torch.tensor(i, device=dev),
                       index=index, converged=conv, carry=carry)


def _check_s(s: int) -> None:
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")


def cacg_kernel(A, b, x0, *, tol: float = 1e-5, maxiter: int, s: int = 4, lmin: float = 0.0, lmax: float = 0.0,
                basis: str = "chebyshev", ctx: Context = DEFAULT_CONTEXT, carry_in=None,
                emit_carry: bool = False) -> SolveResult:
    """CA-CG: chains ``P = [rho_0(A) p .. rho_s(A) p]`` and ``R =
    [rho_0(A) r .. rho_{s-1}(A) r]`` (2s - 1 SpMVs), one Gram, s CG steps
    on ``(2s + 1)``-long coefficient vectors, then ``x += x̂ V``,
    ``p = p̂ V`` and ``r = b - A x``."""
    _check_s(s)
    m, o = 2 * s + 1, s + 1  # basis size, R-block offset
    T_np, d, c = _basis(basis, m, ((0, s), (s + 1, s - 1)), lmin, lmax)
    cheb = basis == "chebyshev"
    dev = b.device
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    T = torch.as_tensor(T_np, dtype=sdt, device=dev)

    state = carried(carry_in)
    if state is not None:
        x, r, p, x_best, res_best = state
    else:
        x = x_best = x0
        r = b - ctx.matvec(A, x0)
        p = r
        res_best = torch.tensor(float("inf"), dtype=sdt, device=dev)
    max_outer = -(-maxiter // s)
    rtrace = torch.zeros(max_outer + 1, dtype=sdt, device=dev)
    ntrace = torch.zeros(max_outer + 1, dtype=torch.int32, device=dev)
    i = index = 0
    conv = False
    for _ in range(max_outer):
        V = torch.stack(_chain(ctx, A, p, s + 1, cheb, d, c) + _chain(ctx, A, r, s, cheb, d, c))
        G = ctx.gram(V)  # one Gram an outer iteration

        res = torch.sqrt(G[o, o]) / b_norm
        rtrace[index] = res
        bad, conv, x_best, res_best = _read_guard(res, res_best, x, x_best, tol)
        if conv:
            break
        i, index = i + s, index + 1
        ntrace[index] = i
        if bad:
            # rollback: restart the chains from the best iterate's true residual
            r = b - ctx.matvec(A, x_best)
            x, p = x_best, r
            continue

        # advance: s CG steps on the coefficient vectors
        p_hat, r_hat = _unit(m, 0, sdt, dev), _unit(m, o, sdt, dev)
        x_hat = torch.zeros(m, dtype=sdt, device=dev)
        rGr = G[o, o]
        for _ in range(s):
            w = _mv(T, p_hat)
            alpha = safe_div(rGr, _vdot(p_hat, _mv(G, w)))
            x_hat = x_hat + alpha * p_hat
            r_hat = r_hat - alpha * w
            rGr_new = _vdot(r_hat, _mv(G, r_hat))
            p_hat = r_hat + safe_div(rGr_new, rGr) * p_hat
            rGr = rGr_new
        x = x + _combine(x_hat, V)
        p = _combine(p_hat, V)
        r = b - ctx.matvec(A, x)  # residual replacement

    return _best_exit(ctx, b_norm, x, r, x_best, res_best, conv, i, index, rtrace, ntrace,
                      (x, r, p, x_best, res_best) if emit_carry else None)


def camrr_kernel(A, b, x0, *, tol: float = 1e-5, maxiter: int, s: int = 4, lmin: float = 0.0, lmax: float = 0.0,
                 basis: str = "chebyshev", ctx: Context = DEFAULT_CONTEXT, carry_in=None,
                 emit_carry: bool = False) -> SolveResult:
    """CA-MrR: after MrR's initial half-step, chains from ``r`` and ``y``
    (s + 1 columns each, 2s SpMVs) plus ``z`` as one more basis column,
    one Gram, s MrR steps on ``(2s + 3)``-long coefficient vectors

        Ar = T r̂, gamma = <y, Ar>_G / <y, y>_G, s = Ar - gamma y,
        zeta = <r, s>_G / <s, s>_G, eta = -zeta gamma,
        ŷ <- eta ŷ + zeta Ar, ẑ <- eta ẑ - zeta r̂, r̂ <- r̂ - ŷ, x̂ <- x̂ - ẑ

    then the recovery of x, y and z and ``r = b - A x``.  A rollback
    restarts y and z by the half-step from the best iterate."""
    _check_s(s)
    m, o, oz = 2 * s + 3, s + 1, 2 * s + 2  # basis size, y-chain offset, z column
    T_np, d, c = _basis(basis, m, ((0, s), (o, s)), lmin, lmax)
    cheb = basis == "chebyshev"
    dev = b.device
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    T = torch.as_tensor(T_np, dtype=sdt, device=dev)

    def half_step(x_from):
        """MrR's initial half-iteration from ``x_from``: ``(x, r, y, z)``
        and the residual ``b - A x_from`` it started from."""
        r0 = b - ctx.matvec(A, x_from)
        Ar = ctx.matvec(A, r0)
        rAr, ArAr = ctx.dot_bundle([(r0, Ar), (Ar, Ar)])
        zeta = safe_div(rAr, ArAr)
        y, z = scale(zeta, Ar), scale(-zeta, r0)
        return (x_from - z, r0 - y, y, z), r0

    max_outer = 1 + -(-maxiter // s)
    rtrace = torch.zeros(max_outer + 1, dtype=sdt, device=dev)
    ntrace = torch.zeros(max_outer + 1, dtype=torch.int32, device=dev)
    state = carried(carry_in)
    if state is not None:
        x, r, y, z, x_best, res_best = state
        i = index = 0
    else:
        (x, r, y, z), r_start = half_step(x0)
        x_best = x
        res_best = torch.tensor(float("inf"), dtype=sdt, device=dev)
        rtrace[0] = ctx.norm(r_start) / b_norm
        ntrace[1] = 1
        i = index = 1
    conv = False
    for _ in range(max(0, -(-(maxiter - i) // s))):  # while i < maxiter, i = i0 + step * s
        V = torch.stack(_chain(ctx, A, r, s + 1, cheb, d, c) + _chain(ctx, A, y, s + 1, cheb, d, c) + [z])
        G = ctx.gram(V)  # one Gram an outer iteration

        res = torch.sqrt(G[0, 0]) / b_norm
        rtrace[index] = res
        bad, conv, x_best, res_best = _read_guard(res, res_best, x, x_best, tol)
        if conv:
            break
        i, index = i + s, index + 1
        ntrace[index] = i
        if bad:  # rollback: y and z restart by the half-step from the best iterate
            (x, r, y, z), _ = half_step(x_best)
            continue

        r_hat, y_hat, z_hat = _unit(m, 0, sdt, dev), _unit(m, o, sdt, dev), _unit(m, oz, sdt, dev)
        x_hat = torch.zeros(m, dtype=sdt, device=dev)
        for _ in range(s):
            Ar_hat = _mv(T, r_hat)
            Gy = _mv(G, y_hat)
            gamma = safe_div(_vdot(Ar_hat, Gy), _vdot(y_hat, Gy))
            s_hat = Ar_hat - gamma * y_hat
            Gs = _mv(G, s_hat)
            zeta = safe_div(_vdot(r_hat, Gs), _vdot(s_hat, Gs))
            eta = -zeta * gamma
            y_hat = eta * y_hat + zeta * Ar_hat
            z_hat = eta * z_hat - zeta * r_hat
            r_hat = r_hat - y_hat
            x_hat = x_hat - z_hat
        x = x + _combine(x_hat, V)
        y, z = _combine(y_hat, V), _combine(z_hat, V)
        r = b - ctx.matvec(A, x)  # residual replacement

    return _best_exit(ctx, b_norm, x, r, x_best, res_best, conv, i, index, rtrace, ntrace,
                      (x, r, y, z, x_best, res_best) if emit_carry else None)
