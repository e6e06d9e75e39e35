"""Analytic SPD test problems (the 1-D Poisson, 2-D and 3-D Laplacian
families), built on the given device.

The same matrices as :mod:`krylov_tpu.sparse.fixtures`: coefficients are
computed in numpy and moved to ``device`` once.
"""

from __future__ import annotations

import numpy as np
import torch

from krylov_tpu_torch.sparse.formats import DiaMatrix, StencilMatrix


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)


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
