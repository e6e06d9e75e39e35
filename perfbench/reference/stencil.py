"""The constant-coefficient Dirichlet Laplacian of a configuration, applied
in plain PyTorch, and its spectral bounds in closed form."""

from __future__ import annotations

import math

import torch


def grid_of(fixture: str, args: dict) -> tuple:
    """The grid shape, leading axis first, of ``fixture(**args)``: the
    program's ``laplace2d(nx, ny)`` is ``(ny, nx)``, ``laplace3d(nx, ny,
    nz)`` is ``(nz, ny, nx)`` (a missing size is ``nx``)."""
    nx = args["nx"]
    ny = args.get("ny") or nx
    if fixture == "laplace2d":
        return (ny, nx)
    if fixture == "laplace3d":
        return (args.get("nz") or nx, ny, nx)
    raise ValueError(f"no reference for fixture {fixture!r}")


def terms(ndim: int) -> list:
    """``[(offset, weight), ...]`` of the (2 ndim + 1)-point Laplacian: the
    centre ``2 ndim``, each neighbour along each axis ``-1``."""
    out = [((0,) * ndim, 2.0 * ndim)]
    for axis in range(ndim):
        for step in (-1, 1):
            off = [0] * ndim
            off[axis] = step
            out.append((tuple(off), -1.0))
    return out


def apply(x: torch.Tensor, grid: tuple) -> torch.Tensor:
    """``A x`` for the Laplacian on ``grid``, zero outside the grid: the
    centre term, then each neighbour term added on the slices where the
    neighbour exists."""
    xg = x.view(grid)
    y = xg * (2.0 * len(grid))
    for axis in range(len(grid)):
        n = grid[axis]
        lo = [slice(None)] * len(grid)
        hi = [slice(None)] * len(grid)
        lo[axis], hi[axis] = slice(0, n - 1), slice(1, n)
        lo, hi = tuple(lo), tuple(hi)
        y[hi].sub_(xg[lo])  # neighbour at -1
        y[lo].sub_(xg[hi])  # neighbour at +1
    return y.view(-1)


def spectral_bounds(grid: tuple) -> tuple:
    """The least and largest eigenvalue of the Laplacian on ``grid``: the
    sums over the axes of ``4 sin^2(pi / (2 (n + 1)))`` and of
    ``4 cos^2(pi / (2 (n + 1)))``."""
    lo = sum(4.0 * math.sin(math.pi / (2 * (n + 1))) ** 2 for n in grid)
    hi = sum(4.0 * math.cos(math.pi / (2 * (n + 1))) ** 2 for n in grid)
    return lo, hi
