"""Preconditioners for the preconditioned and pipelined CG family.

The counterparts of :mod:`krylov_tpu.precond`: both are matvec-only.

- :func:`jacobi`: inverse-diagonal scaling, a one-diagonal
  :class:`~krylov_tpu_torch.sparse.DiaMatrix` on the operator's device;
- :class:`ChebyshevPreconditioner`: a degree-d Chebyshev polynomial
  approximation of ``A^{-1}`` on a spectral interval ``[lmin, lmax]``,
  d - 1 SpMVs an application (the JAX package's loop makes d, and never
  reads the last) and no inner product; on a stencil operator on the
  card, d - 1 fused launches an application (the Chebyshev step,
  :func:`krylov_tpu_torch.kernels.stencil.chebyshev_apply`).

The diagonal and the Gershgorin bounds are read on the host in numpy, as
the JAX package reads them, so both packages give the same bits.
:func:`lanczos_bounds` runs its SpMVs on the operator's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.kernels import _build
from krylov_tpu_torch.kernels.stencil import chebyshev_apply
from krylov_tpu_torch.sparse.formats import DenseMatrix, DiaMatrix, EllMatrix, HybMatrix, StencilMatrix


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def extract_diagonal(A) -> np.ndarray:
    """Host-side diagonal of any container (a numpy array)."""
    if isinstance(A, StencilMatrix):
        zero = tuple(0 for _ in A.grid)
        coef = _host(A.coef)
        out = np.zeros(A.shape[0], dtype=coef.dtype)
        for s, disp in enumerate(A.stencil):
            if tuple(disp) == zero:
                out += coef[s].reshape(-1)
        return out
    if isinstance(A, DiaMatrix):
        if 0 not in A.offsets:
            return np.zeros(A.shape[0], dtype=_host(A.data).dtype)
        return _host(A.data)[A.offsets.index(0)]
    if isinstance(A, EllMatrix):
        rows = np.arange(A.shape[0])[:, None]
        return np.where(_host(A.indices) == rows, _host(A.data), 0.0).sum(axis=1)
    if isinstance(A, HybMatrix):
        rows = np.arange(A.shape[0])[:, None]
        out = np.where(_host(A.ell_indices) == rows, _host(A.ell_data), 0.0).sum(axis=1)
        # tail chunks: the entries whose column is the chunk's row, duplicate
        # chunks of one long row accumulating as in the matvec
        t_rows = _host(A.tail_rows)
        diag = np.where(_host(A.tail_indices) == t_rows[:, None], _host(A.tail_data), 0.0).sum(axis=1)
        np.add.at(out, t_rows, diag)
        return out
    if isinstance(A, DenseMatrix):
        return np.diag(_host(A.data))
    raise TypeError(f"cannot extract diagonal from {type(A)}")


def jacobi(A) -> DiaMatrix:
    """M ≈ A^{-1} as inverse-diagonal scaling (1 where the diagonal is 0)."""
    d = extract_diagonal(A)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    n = A.shape[0]
    return DiaMatrix(torch.from_numpy(inv[None, :]).to(A.device), (0,), (n, n))


def gershgorin_bounds(A) -> Tuple[float, float]:
    """Cheap spectral interval for SPD A: lmax by Gershgorin row sums, lmin
    by the lmax/30 heuristic of the JAX package."""
    if isinstance(A, StencilMatrix):
        rowsum = np.abs(_host(A.coef)).sum(axis=0).reshape(-1)
    elif isinstance(A, DiaMatrix):
        rowsum = np.abs(_host(A.data)).sum(axis=0)
    elif isinstance(A, EllMatrix):
        rowsum = np.abs(_host(A.data)).sum(axis=1)
    elif isinstance(A, HybMatrix):
        rowsum = np.abs(_host(A.ell_data)).sum(axis=1)
        np.add.at(rowsum, _host(A.tail_rows), np.abs(_host(A.tail_data)).sum(axis=1))
    elif isinstance(A, DenseMatrix):
        rowsum = np.abs(_host(A.data)).sum(axis=1)
    else:
        raise TypeError(f"cannot bound spectrum of {type(A)}")
    lmax = float(rowsum.max())
    return lmax / 30.0, lmax


def lanczos_bounds(A, m: int = 16, seed: int = 0, safety: float = 1.05) -> Tuple[float, float]:
    """Spectral interval of SPD ``A`` from an m-step Lanczos run (m SpMVs on
    ``A``'s device), ``[theta_min / safety, theta_max * safety]`` from the
    Ritz values.

    As :func:`krylov_tpu.precond.lanczos_bounds`: ``v0`` is
    ``np.random.default_rng(seed).standard_normal(n)`` in ``A``'s dtype,
    every new vector is reorthogonalised against all earlier ones, and the
    tridiagonal's eigenvalues are taken in float64 on the host (one
    device-to-host copy).  The projections multiply and sum elementwise, so
    a float32 run does not depend on ``allow_tf32``."""
    n = A.shape[0]
    v0 = torch.as_tensor(np.random.default_rng(seed).standard_normal(n), dtype=A.dtype, device=A.device)
    V = torch.zeros((m + 1, n), dtype=A.dtype, device=A.device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    alphas = torch.zeros(m, dtype=A.dtype, device=A.device)
    betas = torch.zeros(m, dtype=A.dtype, device=A.device)
    for j in range(m):
        v = V[j]
        w = A.matvec(v)
        alpha = torch.dot(w, v)
        w = w - alpha * v
        # full reorthogonalisation against V[0..j] (the rows after j are
        # zero and add exact zeros in the JAX package's product)
        Vj = V[: j + 1]
        proj = (Vj * w).sum(-1)
        w = w - (proj[:, None] * Vj).sum(0)
        beta = torch.linalg.vector_norm(w)
        V[j + 1] = torch.where(beta > 0, w / torch.where(beta > 0, beta, torch.ones_like(beta)), w)
        alphas[j], betas[j] = alpha, beta
    with tracing.host_read():
        alphas, betas = _host(alphas), _host(betas)
    T = np.diag(alphas.astype(np.float64))
    off = betas.astype(np.float64)[: m - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    theta = np.linalg.eigvalsh(T)
    return max(float(theta[0]), 1e-30) / safety, float(theta[-1]) * safety


def chebyshev_schedule(lmin: float, lmax: float, degree: int) -> tuple:
    """``(theta, steps)`` of a degree-``degree`` application on
    ``[lmin, lmax]``: the centre ``theta`` and, for each of the
    ``degree - 1`` rounds after the first, the ``(c1, c2)`` that
    :func:`chebyshev_loop` multiplies ``d`` and ``r`` by (the JAX
    package's floats, formed in its order)."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    steps = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        steps.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, tuple(steps)


def chebyshev_loop(A, v: torch.Tensor, theta: float, steps, ctx) -> torch.Tensor:
    """The Chebyshev recurrence in torch's operations, each SpMV through
    ``ctx.matvec``: ``d = v / theta``, ``z = 0 + d``, then for each
    ``(c1, c2)`` of ``steps`` ``r = r - A d``, ``d = c1 d + c2 r``,
    ``z = z + d`` (``r`` from ``v``).  The JAX package's loop less its last
    SpMV and updates, whose results it never reads: the same ``z``, bit for
    bit.  What the Chebyshev step
    (:func:`krylov_tpu_torch.kernels.stencil.chebyshev_apply`) computes in
    one launch a step."""
    d = v / theta
    z = torch.zeros_like(v) + d
    r = v
    for c1, c2 in steps:
        r = r - ctx.matvec(A, d)
        d = c1 * d + c2 * r
        z = z + d
    return z


def fused_route(A, v: torch.Tensor, ctx) -> bool:
    """Whether a Chebyshev application on ``A`` runs on the Chebyshev step
    (:func:`krylov_tpu_torch.kernels.stencil.chebyshev_apply`): a 2-D or
    3-D :class:`StencilMatrix` of at most ``MAX_TERMS`` terms, ``v`` on its
    card in its dtype (float32 or float64), both contiguous, ``v`` of shape
    ``(n,)`` or ``(batch, n)``, and a ``ctx`` without a process group.
    Any other application runs :func:`chebyshev_loop`."""
    return (isinstance(A, StencilMatrix) and v.is_cuda and ctx.group is None and len(A.grid) in (2, 3)
            and len(A.stencil) <= _build.MAX_TERMS and v.dtype in (torch.float32, torch.float64)
            and A.coef.dtype == v.dtype and A.coef.device == v.device and v.is_contiguous()
            and A.coef.is_contiguous() and v.ndim in (1, 2) and v.shape[-1] == A.shape[0])


@dataclasses.dataclass(frozen=True)
class ChebyshevPreconditioner:
    """Apply ``z ≈ A^{-1} v`` by a degree-d Chebyshev recurrence
    (:func:`chebyshev_loop`, d - 1 SpMVs through ``ctx.matvec``; on the
    Chebyshev step where :func:`fused_route` says so).  Each application
    counts in ``tracing.totals.cheb_apply``."""

    A: object
    lmin: float
    lmax: float
    degree: int
    needs_ctx = True

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    def matvec(self, v: torch.Tensor, ctx) -> torch.Tensor:
        fused = self.degree >= 1 and fused_route(self.A, v, ctx)
        tracing.count("cheb_apply", "calls", *(("fused",) if fused else ()))
        if self.degree < 1:
            return torch.zeros_like(v)  # the empty polynomial
        theta, steps = chebyshev_schedule(self.lmin, self.lmax, self.degree)
        if fused:
            return chebyshev_apply(self.A, v, theta, steps)
        return chebyshev_loop(self.A, v, theta, steps, ctx)


def chebyshev(A, degree: int = 4, lmin: float | None = None, lmax: float | None = None,
              bounds: str = "auto") -> ChebyshevPreconditioner:
    """A Chebyshev polynomial preconditioner with estimated bounds.

    ``bounds``: ``"auto"`` (Lanczos, and the Gershgorin bounds where the
    Lanczos interval is degenerate: not finite, or not ``0 < lo < hi``),
    ``"lanczos"`` or ``"gershgorin"``.  Where the JAX package falls back on
    any exception of the Lanczos run, this one falls back only on the
    degenerate interval: a CUDA or launch error surfaces."""
    if lmin is None or lmax is None:
        if bounds == "gershgorin":
            lo, hi = gershgorin_bounds(A)
        elif bounds == "lanczos":
            lo, hi = lanczos_bounds(A)
        elif bounds == "auto":
            lo, hi = lanczos_bounds(A)
            if not (np.isfinite(lo) and np.isfinite(hi) and 0 < lo < hi):
                lo, hi = gershgorin_bounds(A)
        else:
            raise ValueError(f"bounds must be 'auto', 'lanczos' or 'gershgorin', got {bounds!r}")
        lmin = lo if lmin is None else lmin
        lmax = hi if lmax is None else lmax
    return ChebyshevPreconditioner(A=A, lmin=float(lmin), lmax=float(lmax), degree=int(degree))
