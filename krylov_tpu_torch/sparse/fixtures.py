"""SPD test problems: the 1-D Poisson, 2-D and 3-D Laplacian families, a
random diagonally dominant ELL matrix and a power-law graph Laplacian.

The same matrices as :mod:`krylov_tpu.sparse.fixtures`, from the same
seeds: coefficients are computed in numpy (scipy for the random families)
and moved to ``device`` once.  ``dtype`` is a torch or numpy dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from krylov_tpu_torch.sparse.formats import (
    DiaMatrix,
    EllMatrix,
    StencilMatrix,
    as_numpy_dtype,
    as_torch_dtype,
)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(as_torch_dtype(dtype))


def poisson1d(n: int, dtype=torch.float64, device="cpu") -> DiaMatrix:
    """1-D Poisson tridiagonal SPD matrix: diag 2, off-diagonals -1."""
    data = np.zeros((3, n))
    data[0, 1:] = -1.0  # A[i, i-1]
    data[1] = 2.0
    data[2, : n - 1] = -1.0  # A[i, i+1]
    return DiaMatrix(_tensor(data, dtype, device), (-1, 0, 1), (n, n))


def laplace2d(
    nx: int, ny: int | None = None, dtype=torch.float64, constant: bool = False,
    device="cpu",
) -> StencilMatrix:
    """2-D 5-point Laplacian on an ny*nx grid, row-major, Dirichlet
    boundaries; ``constant=True`` gives the per-term weight form."""
    ny = ny if ny is not None else nx
    stencil = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    if constant:
        w = np.array([-1.0, -1.0, 4.0, -1.0, -1.0])
        return StencilMatrix(_tensor(w, dtype, device), stencil, (ny, nx))
    iy = np.arange(ny)[:, None]
    ix = np.arange(nx)[None, :]
    shp = (ny, nx)
    north = -np.broadcast_to(iy > 0, shp).astype(np.float64)  # (i-1, j)
    south = -np.broadcast_to(iy < ny - 1, shp).astype(np.float64)
    west = -np.broadcast_to(ix > 0, shp).astype(np.float64)  # (i, j-1)
    east = -np.broadcast_to(ix < nx - 1, shp).astype(np.float64)
    coef = np.stack([north, west, np.full(shp, 4.0), east, south])
    return StencilMatrix(_tensor(coef, dtype, device), stencil, shp)


_STENCIL_3D = (
    (-1, 0, 0),
    (0, -1, 0),
    (0, 0, -1),
    (0, 0, 0),
    (0, 0, 1),
    (0, 1, 0),
    (1, 0, 0),
)


def laplace3d(
    nx: int, ny: int | None = None, nz: int | None = None,
    dtype=torch.float64, constant: bool = False, device="cpu",
) -> StencilMatrix:
    """3-D 7-point Laplacian on an nz*ny*nx grid, Dirichlet boundaries."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    shp = (nz, ny, nx)
    if constant:
        w = np.array([-1.0, -1.0, -1.0, 6.0, -1.0, -1.0, -1.0])
        return StencilMatrix(_tensor(w, dtype, device), _STENCIL_3D, shp)
    iz = np.arange(nz)[:, None, None]
    iy = np.arange(ny)[None, :, None]
    ix = np.arange(nx)[None, None, :]

    def edge(mask):
        return -np.broadcast_to(mask, shp).astype(np.float64)

    coef = np.stack([
        edge(iz > 0), edge(iy > 0), edge(ix > 0), np.full(shp, 6.0),
        edge(ix < nx - 1), edge(iy < ny - 1), edge(iz < nz - 1),
    ])
    return StencilMatrix(_tensor(coef, dtype, device), _STENCIL_3D, shp)


def random_spd_ell(n: int, row_nnz: int = 8, seed: int = 0, dtype=torch.float64, device="cpu") -> EllMatrix:
    """Random diagonally dominant SPD matrix in ELL storage: S + S^T with a
    diagonal of the absolute row sums plus one, from a random sparse S."""
    import scipy.sparse as sp

    from krylov_tpu_torch.sparse.convert import to_ell

    np_dtype = as_numpy_dtype(dtype)
    rng = np.random.default_rng(seed)
    half = max(1, row_nnz // 2)
    rows = np.repeat(np.arange(n), half)
    cols = rng.integers(0, n, size=rows.size)
    vals = rng.uniform(-1.0, 1.0, size=rows.size).astype(np_dtype)
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A = (S + S.T).tolil()
    A.setdiag(np.abs(A).sum(axis=1).A1 + 1.0)
    return to_ell(A.tocsr(), dtype=np_dtype, device=device)


def powerlaw_spd(
    n: int, avg_deg: int = 8, alpha: float = 2.1, max_deg: int | None = None,
    shift: float = 0.05, diag_scale_decades: float = 0.0, seed: int = 0, dtype=np.float64,
):
    """Power-law-degree sparse SPD matrix (a graph-Laplacian-like system
    with a few hub rows thousands wide), as scipy CSR.

    ``A = (1 + shift) I - D^{-1/2} W D^{-1/2}`` of a random symmetric
    graph ``W`` with Pareto degrees (floor 2, cap ``max_deg``, by default
    n // 64): its spectrum lies in ``[shift, 2 + shift]``.
    ``diag_scale_decades`` scales it symmetrically by a log-uniform diagonal
    ``S A S``, which spreads the spectrum over about twice that many
    decades (the graded systems that take CG hundreds of iterations)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    max_deg = max_deg if max_deg is not None else max(n // 64, 16)
    deg = 2 + (avg_deg - 2) * rng.pareto(alpha, size=n)
    deg = np.minimum(deg.astype(np.int64), max_deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = rng.integers(0, n, size=rows.size, dtype=np.int64)
    off = rows != cols  # drop self-loops
    w = rng.uniform(0.5, 1.5, size=rows.size)
    S = sp.coo_matrix((w[off], (rows[off], cols[off])), shape=(n, n)).tocsr()
    W = S + S.T
    d = np.asarray(W.sum(axis=1)).ravel()
    Dh = sp.diags(1.0 / np.sqrt(np.maximum(d, 1e-30)))
    A = sp.eye(n, format="csr") * (1.0 + shift) - Dh @ W @ Dh
    if diag_scale_decades:
        s = sp.diags(10.0 ** rng.uniform(0.0, diag_scale_decades, size=n))
        A = s @ A @ s
    return A.tocsr().astype(as_numpy_dtype(dtype))


def rhs_for_solution(A, x_true, device=None) -> torch.Tensor:
    """``b = A @ x_true`` for a known-solution test, as a tensor on
    ``device`` (by default the operator's, or the CPU for a scipy matrix).
    For a container, computed on the host in float64 and cast to
    ``x_true``'s dtype."""
    from krylov_tpu_torch.sparse.convert import host_matvec64
    from krylov_tpu_torch.sparse.formats import _host

    x = _host(x_true) if isinstance(x_true, torch.Tensor) else np.asarray(x_true)
    if hasattr(A, "matvec"):
        b, device = host_matvec64(A, x).astype(x.dtype), A.device if device is None else device
    else:
        b = np.asarray(A @ x)
    return torch.as_tensor(b, device=device)


def ones_rhs(n: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    return torch.ones(n, dtype=as_torch_dtype(dtype), device=device)
