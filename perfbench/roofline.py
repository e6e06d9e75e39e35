"""Published peaks of the card and the counts of work the roofline metrics
divide by.

The counts read the work the mathematics needs, whatever implements it: a
change to how the program forms its vectors, or a blocking in time, moves
the program's time and never these counts.  Peaks: NVIDIA's H100 SXM data
sheet, dense rates outside the tensor cores, at the full 700 W limit.
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"float64": 8, "float32": 4}

# operations of one iteration of the plain method besides its SpMV, a row:
# MrR: five inner products (10), s = Ar - gamma y (2), y and z updates (3
# each), r -= y and x -= z (1 each); CG: two inner products (4), the x, r
# and p updates (2 each)
VECTOR_OPS = {"mrr": 20, "cg": 10}


def nnz(grid: tuple, rows: tuple | None = None) -> int:
    """Nonzeros of the Dirichlet Laplacian on ``grid`` in the rows whose
    leading-axis index lies in ``rows = (lo, hi)`` (all rows when None):
    the centre of each row, and each neighbour that lies inside the grid."""
    lo, hi = rows if rows is not None else (0, grid[0])
    planes = hi - lo
    rest = math.prod(grid[1:])
    total = planes * rest  # centre terms
    # neighbours along the leading axis: row i has i-1 when i > 0 and i+1
    # when i < grid[0] - 1
    total += (planes - (lo == 0)) * rest + (planes - (hi == grid[0])) * rest
    for axis in range(1, len(grid)):
        n = grid[axis]
        total += 2 * (n - 1) * (rest // n) * planes
    return total


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations at
    the published peak and the bytes at the published bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def whole_solve_bound_s(family: str, n: int, nnz_: int, iterations: int, dtype: str) -> float:
    """A whole solve from ``x0 = 0``: the plain method's operations an
    iteration (its SpMV's ``2 nnz`` and its vector operations) times the
    plain reference's iteration count; ``b`` read once and ``x`` written
    once."""
    flops = iterations * (2 * nnz_ + VECTOR_OPS[family] * n)
    return bound_s(flops, 2 * n * ITEMSIZE[dtype], dtype)


def spmv_bound_s(rows: int, nnz_: int, dtype: str) -> float:
    """One SpMV of ``rows`` rows with ``nnz_`` nonzeros of a constant
    stencil: ``2 nnz`` operations, ``x`` read once and ``y`` written once
    (the weights add nothing)."""
    return bound_s(2 * nnz_, 2 * rows * ITEMSIZE[dtype], dtype)
