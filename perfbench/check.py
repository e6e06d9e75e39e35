"""The comparison that decides ``correct``: each sampled request's answer
held against the plain reference (:mod:`perfbench.reference`), worked out
again from the configuration's grid and the request's ``b``.

Numbers, each the worst over the sample:

- ``true_rel``: ``||b - A x|| / ||b||`` of the returned ``x`` in float64;
  its limit is the configuration's ``tol``, the guarantee it states;
- ``iters_gap``: how far the request's iteration count ``m`` lies outside
  what exact arithmetic allows against the plain method's count ``m_ref``
  on the same ``b``, over ``m_ref``.  The plain method and its k-skip forms
  make the same iterates, and a k-skip loop reads its residual once an
  outer iteration, so ``m`` may pass ``m_ref`` by up to ``k`` (the
  traffic's ``k``, 0 for a plain method): ``max(0, m - m_ref - k, m_ref -
  m) / m_ref``;
- ``x_err``: ``||x - x_ref(m)|| / ||x_ref(m)||`` against the plain
  method's iterate after the same ``m`` iterations.

A cell's check file names the numbers it holds and their limits.
"""

from __future__ import annotations

import torch

from perfbench.reference import solvers, stencil


def numbers(config: dict, traffic: dict, grid: tuple, b: torch.Tensor, x: torch.Tensor, iterations: int) -> dict:
    """The numbers of one request (``b`` as drawn, in float64; ``x`` whole,
    in the program's dtype), and the reference's count."""
    b, x = b.double(), x.double()

    def matvec(v):
        return stencil.apply(v, grid)

    b_norm = torch.linalg.vector_norm(b)
    true_rel = float(torch.linalg.vector_norm(b - matvec(x)) / b_norm)
    tol, maxiter = config["tol"], config["maxiter"]
    if traffic["reference"] == "mrr":
        count, x_ref = solvers.mrr(matvec, b, tol, maxiter, snap=iterations)
    else:
        pre = traffic.get("precond")
        M = None
        if pre:
            lmin, lmax = stencil.spectral_bounds(grid)
            M = solvers.chebyshev(matvec, lmin, lmax, pre["degree"])
        count, x_ref = solvers.pcg(matvec, b, tol, maxiter, M, snap=iterations)
    x_err = float(torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(x_ref))
    k = traffic["kwargs"].get("k", 0)
    gap = max(0, iterations - count - k, count - iterations) / count
    return {"true_rel": true_rel, "iters_gap": gap, "x_err": x_err,
            "ref_iterations": count}


def judge(rows: list, limits: dict, tol: float) -> tuple:
    """``(ok, {name: {"value": worst, "limit": limit}})`` over the sampled
    requests' numbers: ``true_rel`` below ``tol`` (a limit ``"tol"``), every
    other number at or below its limit."""
    out, ok = {}, bool(rows)
    for name, limit in limits.items():
        worst = max(r[name] for r in rows) if rows else None
        if limit == "tol":
            limit, good = tol, worst is not None and worst < tol
        else:
            good = worst is not None and worst <= limit
        ok = ok and good
        out[name] = {"value": worst, "limit": limit}
    return ok, out
