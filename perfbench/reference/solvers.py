"""MrR and preconditioned CG as textbook loops in plain PyTorch, and the
Chebyshev polynomial preconditioner.

Each solver counts iterations as the program's loops define them and can
hand back its iterate after a given count (``snap``), so a program's ``x``
after ``m`` iterations can be held against the reference's after ``m``.
Convergence is read on the host every iteration.
"""

from __future__ import annotations

import torch


def _rel(r: torch.Tensor, b_norm: float) -> float:
    return float(torch.linalg.vector_norm(r)) / b_norm


def mrr(matvec, b: torch.Tensor, tol: float, maxiter: int, snap: int | None = None):
    """MrR from ``x0 = 0``: a half-iteration (``zeta = <r,Ar>/<Ar,Ar>``,
    ``y = zeta Ar``, ``z = -zeta r``), then each iteration ``gamma =
    <y,Ar>/<y,y>``, ``s = Ar - gamma y``, ``zeta = <r,s>/<s,s>``, ``eta =
    -zeta gamma``, ``y = eta y + zeta Ar``, ``z = eta z - zeta r``,
    ``r -= y``, ``x -= z``.  The half-iteration is iteration 1; the count
    is the first ``i`` whose recurred residual is below ``tol`` (or
    ``maxiter``).  Returns ``(count, x after snap iterations or at the
    count)``."""
    b_norm = float(torch.linalg.vector_norm(b))
    r = b.clone()
    Ar = matvec(r)
    zeta = torch.dot(r, Ar) / torch.dot(Ar, Ar)
    y, z = zeta * Ar, -zeta * r
    r = r - y
    x = -z
    i, count, x_snap = 1, None, None
    while True:
        if snap == i:
            x_snap = x.clone()
        if count is None and (_rel(r, b_norm) < tol or i >= maxiter):
            count = i
        if count is not None and (snap is None or i >= snap):
            break
        Ar = matvec(r)
        gamma = torch.dot(y, Ar) / torch.dot(y, y)
        s = Ar - gamma * y
        zeta = torch.dot(r, s) / torch.dot(s, s)
        eta = -zeta * gamma
        y = eta * y + zeta * Ar
        z = eta * z - zeta * r
        r = r - y
        x = x - z
        i += 1
    return count, x if x_snap is None else x_snap


def pcg(matvec, b: torch.Tensor, tol: float, maxiter: int, precond=None, snap: int | None = None):
    """Preconditioned CG from ``x0 = 0`` (plain CG when ``precond`` is
    None).  The count is the first ``i`` (from 0) whose recurred residual
    is below ``tol`` (or ``maxiter``).  Returns ``(count, x after snap
    iterations or at the count)``."""
    b_norm = float(torch.linalg.vector_norm(b))
    M = precond or (lambda v: v)
    x = torch.zeros_like(b)
    r = b.clone()
    u = M(r)
    p = u
    ru = torch.dot(r, u)
    i, count, x_snap = 0, None, None
    while True:
        if snap == i:
            x_snap = x.clone()
        if count is None and (_rel(r, b_norm) < tol or i >= maxiter):
            count = i
        if count is not None and (snap is None or i >= snap):
            break
        s = matvec(p)
        alpha = ru / torch.dot(s, p)
        x = x + alpha * p
        r = r - alpha * s
        u = M(r)
        ru_new = torch.dot(r, u)
        p = u + (ru_new / ru) * p
        ru = ru_new
        i += 1
    return count, x if x_snap is None else x_snap


def chebyshev(matvec, lmin: float, lmax: float, degree: int):
    """``v -> z``, ``z`` the degree-``degree`` Chebyshev iteration for
    ``A z = v`` from zero on ``[lmin, lmax]`` (Saad, Iterative Methods,
    Algorithm 12.1): ``degree`` SpMVs an application."""
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def apply(v: torch.Tensor) -> torch.Tensor:
        rho = 1.0 / sigma1
        z = torch.zeros_like(v)
        r = v
        d = r / theta
        for _ in range(degree):
            z = z + d
            r = r - matvec(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        return z

    return apply
