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

``b`` and ``x0`` may carry a leading batch axis ``(batch, n)``: the loop
is the JAX package's ``vmap`` of it.  The chains run on the whole block
(one SpMV a chain step), the basis stacks as ``(batch, m, n)`` and its
Gram goes through ``ctx.gram`` (one product a member, one all-reduce for
the stack).  The one host read gives every member's guard and convergence
flag; the members that advance and those that roll back each take their
branch on their own rows (``index_select`` in, ``index_copy`` out), and a
member that has converged or used its updates keeps its state, counts and
best iterate, as ``tree_select(conv, ...)`` keeps them in the JAX loop.
The loop ends when no member is left.  One system runs the same code on
its ``(n,)`` vectors and 0-d scalars, with no batch axis.

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
loop (before the best-iterate exit).  A carry takes one system: with a
batch either raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import (
    SolveResult,
    bcast,
    carried,
    guard_read,
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
    """``M @ v`` for each member's coefficient vector ``v`` (``(m,)`` or
    ``(batch, m)``), multiplied and summed elementwise (see the module
    note)."""
    return (M * (v if v.ndim == 1 else v.unsqueeze(-2))).sum(-1)


def _vdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(-1)


def _combine(coeffs: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``coeffs @ V`` per member, a combination of the basis rows,
    elementwise."""
    return (coeffs.to(V.dtype).unsqueeze(-1) * V).sum(-2)


def _unit(lead: tuple, m: int, j: int, sdt, dev) -> torch.Tensor:
    e = torch.zeros(lead + (m,), dtype=sdt, device=dev)
    e[..., j] = 1.0
    return e


def _lead(b: torch.Tensor, carry_in, emit_carry: bool):
    """``(lead, state)``: the batch shape, ``()`` for one system or
    ``(batch,)``, and the carried state, which only one system takes."""
    lead = tuple(b.shape[:-1])
    if len(lead) > 1:
        raise ValueError(f"b must be (n,) or (batch, n), got shape {tuple(b.shape)}")
    if lead and (carry_in is not None or emit_carry):
        raise ValueError(f"carry_in= and emit_carry= take one system, b of shape (n,); got {tuple(b.shape)}")
    return lead, carried(carry_in)


def _branch(fn, g: np.ndarray, state: tuple, nb: int, dev) -> tuple:
    """``state`` with the members ``g`` replaced by ``fn(take)``, a
    branch's new state for them.  ``take`` cuts a per-member tensor to the
    members ``g`` (``index_select`` in, ``index_copy`` out); a branch of the
    whole batch runs on it as it is."""
    if g.size == 0:
        return state
    if g.size == nb:
        return fn(lambda t: t)
    rows = torch.as_tensor(g, device=dev)
    new = fn(lambda t: t.index_select(0, rows))
    return tuple(t.index_copy(0, rows, v) for t, v in zip(state, new))


class _Outer:
    """The host side of the outer loop of a batch of shape ``lead`` (one
    system: ``()``, counted as one member): the update and outer counts
    ``i``/``index``, the convergence flags and the nosl trace as numpy
    arrays, one row a member, the residual trace on the device.  The live
    members share ``i`` and ``index``: they start together, each outer
    iteration advances every one that goes on, and a member that stops
    never runs again."""

    def __init__(self, lead: tuple, length: int, i0: int, sdt, dev):
        nb = lead[0] if lead else 1
        self.lead, self.dev = lead, dev
        self.rtrace = torch.zeros(lead + (length,), dtype=sdt, device=dev)
        self.ntrace = np.zeros((nb, length), np.int32)
        self.i = np.full(nb, i0, np.int64)
        self.index = np.full(nb, i0, np.int64)
        self.conv = np.zeros(nb, bool)
        self.live = self.i[:0]

    def rows(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.dev)

    def shaped(self, a: np.ndarray) -> torch.Tensor:
        """A per-member array as a device tensor of shape ``lead`` (and
        its trailing axes)."""
        return self.rows(a).reshape(self.lead + a.shape[1:])

    def running(self, maxiter: int) -> bool:
        """Whether a member still iterates: not converged, ``i < maxiter``."""
        self.live = np.flatnonzero(~self.conv & (self.i < maxiter))
        return self.live.size > 0

    def read(self, res, res_best, x, x_best, tol, s: int):
        """The entry of an outer iteration: the residual ``res`` written to
        the live members' trace slots, the guard's best iterate updated for
        them, then the one host read, of the guard (``bad``: ``res`` not
        finite or above ``_GUARD_GROWTH`` times the best) and of the
        convergence test together.  Each live member that has not
        converged counts s updates and one outer iteration.  Returns
        ``(advance, rollback, x_best, res_best)``: the members that take
        each branch."""
        live, nb = self.live, len(self.i)
        whole, k = live.size == nb, int(self.index[live[0]])
        if whole:
            self.rtrace[..., k] = res
        else:
            rows = self.rows(live)
            self.rtrace[rows, k] = res[rows]
        bad = ~torch.isfinite(res) | (res > _GUARD_GROWTH * res_best)
        better = torch.isfinite(res) & (res < res_best)
        if not whole:  # a frozen member keeps its best iterate
            better &= self.rows(np.isin(np.arange(nb), live))
        x_best, res_best = tree_select(better, (x, res), (x_best, res_best))
        bad_h, conv_h = guard_read(torch.stack((bad, res < tol))).reshape(2, nb)
        self.conv[live] = conv_h[live]
        step = live[~conv_h[live]]
        self.i[step] += s
        self.index[step] += 1
        self.ntrace[step, self.index[step]] = self.i[step]
        return step[~bad_h[step]], step[bad_h[step]], x_best, res_best

    def exit(self, ctx, b_norm, x, r, x_best, res_best, carry) -> SolveResult:
        """On exhaustion the best iterate, never a diverged one; the final
        residual written unless converged.  ``carry`` is the loop's state
        for ``emit_carry``."""
        conv, index = self.shaped(self.conv), self.shaped(self.index)
        final_res = ctx.norm(r) / b_norm
        use_best = ~conv & (res_best < final_res)
        x = torch.where(bcast(use_best, x), x_best, x)
        record_final(self.rtrace, index, conv, torch.where(use_best, res_best, final_res))
        return SolveResult(x=x, residual_trace=self.rtrace, nosl_trace=self.shaped(self.ntrace),
                           iterations=self.shaped(self.i), index=index, converged=conv, carry=carry)


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
    lead, state = _lead(b, carry_in, emit_carry)
    nb, dev = (lead[0] if lead else 1), b.device
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    T = torch.as_tensor(T_np, dtype=sdt, device=dev)

    if state is not None:
        x, r, p, x_best, res_best = state
    else:
        x = x_best = x0
        r = b - ctx.matvec(A, x0)
        p = r
        res_best = torch.full(lead, float("inf"), dtype=sdt, device=dev)
    out = _Outer(lead, -(-maxiter // s) + 1, 0, sdt, dev)

    def rollback(take):
        """Restart the chains from the best iterate's true residual."""
        x_rb = take(x_best)
        r_rb = take(b) - ctx.matvec(A, x_rb)
        return x_rb, r_rb, r_rb

    def advance(take):
        """s CG steps on the coefficient vectors, the recovery, the
        residual replacement."""
        V_, G_ = take(V), take(G)
        lead_ = tuple(V_.shape[:-2])
        p_hat, r_hat = _unit(lead_, m, 0, sdt, dev), _unit(lead_, m, o, sdt, dev)
        x_hat = torch.zeros(lead_ + (m,), dtype=sdt, device=dev)
        rGr = G_[..., o, o]
        for _ in range(s):
            w = _mv(T, p_hat)
            alpha = bcast(safe_div(rGr, _vdot(p_hat, _mv(G_, w))), p_hat)
            x_hat = x_hat + alpha * p_hat
            r_hat = r_hat - alpha * w
            rGr_new = _vdot(r_hat, _mv(G_, r_hat))
            p_hat = r_hat + bcast(safe_div(rGr_new, rGr), p_hat) * p_hat
            rGr = rGr_new
        x_n = take(x) + _combine(x_hat, V_)
        return x_n, take(b) - ctx.matvec(A, x_n), _combine(p_hat, V_)

    while out.running(maxiter):
        V = torch.stack(_chain(ctx, A, p, s + 1, cheb, d, c) + _chain(ctx, A, r, s, cheb, d, c), -2)
        G = ctx.gram(V)  # one Gram an outer iteration
        res = torch.sqrt(G[..., o, o]) / b_norm
        adv, rb, x_best, res_best = out.read(res, res_best, x, x_best, tol, s)
        x, r, p = _branch(advance, adv, (x, r, p), nb, dev)
        x, r, p = _branch(rollback, rb, (x, r, p), nb, dev)

    return out.exit(ctx, b_norm, x, r, x_best, res_best, (x, r, p, x_best, res_best) if emit_carry else None)


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
    lead, state = _lead(b, carry_in, emit_carry)
    nb, dev = (lead[0] if lead else 1), b.device
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    T = torch.as_tensor(T_np, dtype=sdt, device=dev)

    def half_step(b_, x_from):
        """MrR's initial half-iteration from ``x_from``: ``(x, r, y, z)``
        and the residual ``b_ - A x_from`` it started from."""
        r0 = b_ - ctx.matvec(A, x_from)
        Ar = ctx.matvec(A, r0)
        rAr, ArAr = ctx.dot_bundle([(r0, Ar), (Ar, Ar)])
        zeta = safe_div(rAr, ArAr)
        y, z = scale(zeta, Ar), scale(-zeta, r0)
        return (x_from - z, r0 - y, y, z), r0

    length = 2 + -(-maxiter // s)
    if state is not None:
        x, r, y, z, x_best, res_best = state
        out = _Outer(lead, length, 0, sdt, dev)
    else:
        (x, r, y, z), r_start = half_step(b, x0)
        x_best = x
        res_best = torch.full(lead, float("inf"), dtype=sdt, device=dev)
        out = _Outer(lead, length, 1, sdt, dev)
        out.rtrace[..., 0] = ctx.norm(r_start) / b_norm
        out.ntrace[:, 1] = 1

    def rollback(take):
        """y and z restart by the half-step from the best iterate."""
        return half_step(take(b), take(x_best))[0]

    def advance(take):
        """s MrR steps on the coefficient vectors, the recovery, the
        residual replacement."""
        V_, G_ = take(V), take(G)
        lead_ = tuple(V_.shape[:-2])
        r_hat, y_hat, z_hat = (_unit(lead_, m, j, sdt, dev) for j in (0, o, oz))
        x_hat = torch.zeros(lead_ + (m,), dtype=sdt, device=dev)
        for _ in range(s):
            Ar_hat = _mv(T, r_hat)
            Gy = _mv(G_, y_hat)
            gamma = bcast(safe_div(_vdot(Ar_hat, Gy), _vdot(y_hat, Gy)), y_hat)
            s_hat = Ar_hat - gamma * y_hat
            Gs = _mv(G_, s_hat)
            zeta = bcast(safe_div(_vdot(r_hat, Gs), _vdot(s_hat, Gs)), y_hat)
            eta = -zeta * gamma
            y_hat = eta * y_hat + zeta * Ar_hat
            z_hat = eta * z_hat - zeta * r_hat
            r_hat = r_hat - y_hat
            x_hat = x_hat - z_hat
        x_n = take(x) + _combine(x_hat, V_)
        return x_n, take(b) - ctx.matvec(A, x_n), _combine(y_hat, V_), _combine(z_hat, V_)

    while out.running(maxiter):
        V = torch.stack(_chain(ctx, A, r, s + 1, cheb, d, c) + _chain(ctx, A, y, s + 1, cheb, d, c) + [z], -2)
        G = ctx.gram(V)  # one Gram an outer iteration
        res = torch.sqrt(G[..., 0, 0]) / b_norm
        adv, rb, x_best, res_best = out.read(res, res_best, x, x_best, tol, s)
        x, r, y, z = _branch(advance, adv, (x, r, y, z), nb, dev)
        x, r, y, z = _branch(rollback, rb, (x, r, y, z), nb, dev)

    return out.exit(ctx, b_norm, x, r, x_best, res_best, (x, r, y, z, x_best, res_best) if emit_carry else None)
