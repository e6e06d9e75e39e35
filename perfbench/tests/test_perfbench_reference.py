"""The plain reference against dense NumPy, and the roofline counts on
hand-worked cases."""

import numpy as np
import pytest
import torch

from perfbench import roofline
from perfbench.reference import solvers, stencil


def dense_laplacian(grid):
    """The Dirichlet Laplacian on ``grid`` as a dense matrix: sums of
    Kronecker products of tridiag(-1, 2, -1)."""
    mats = [np.eye(n) for n in grid]
    A = np.zeros((int(np.prod(grid)),) * 2)
    for axis, n in enumerate(grid):
        T = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
        factors = mats[:axis] + [T] + mats[axis + 1:]
        K = factors[0]
        for f in factors[1:]:
            K = np.kron(K, f)
        A += K
    return A


@pytest.mark.parametrize("grid", [(7, 5), (4, 5, 6)])
def test_apply_and_bounds_match_dense(grid):
    A = dense_laplacian(grid)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    y = stencil.apply(torch.from_numpy(x.copy()), grid).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=1e-13, atol=1e-13)
    lo, hi = stencil.spectral_bounds(grid)
    ev = np.linalg.eigvalsh(A)
    assert lo == pytest.approx(ev[0], rel=1e-12) and hi == pytest.approx(ev[-1], rel=1e-12)


def test_grid_of_follows_the_fixtures():
    assert stencil.grid_of("laplace2d", {"nx": 500}) == (500, 500)
    assert stencil.grid_of("laplace2d", {"nx": 5, "ny": 3}) == (3, 5)
    assert stencil.grid_of("laplace3d", {"nx": 216, "ny": 216, "nz": 864}) == (864, 216, 216)


@pytest.mark.parametrize("method", ["mrr", "cg", "pcg-cheb"])
def test_solvers_match_dense_solve(method):
    grid = (9, 8)
    A = dense_laplacian(grid)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    x_true = np.linalg.solve(A, b)

    def mv(v):
        return stencil.apply(v, grid)

    bt = torch.from_numpy(b)
    if method == "mrr":
        count, x = solvers.mrr(mv, bt, 1e-12, 500)
    else:
        M = solvers.chebyshev(mv, *stencil.spectral_bounds(grid), 4) if method == "pcg-cheb" else None
        count, x = solvers.pcg(mv, bt, 1e-12, 500, M)
    assert count < 500
    np.testing.assert_allclose(x.numpy(), x_true, rtol=1e-9, atol=1e-9)


def test_snap_returns_the_iterate_after_m_iterations():
    grid = (6, 6)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(36))

    def mv(v):
        return stencil.apply(v, grid)

    count, x_conv = solvers.mrr(mv, b, 1e-8, 200)
    _, x_early = solvers.mrr(mv, b, 1e-8, 200, snap=3)
    _, x_late = solvers.mrr(mv, b, 1e-8, 200, snap=count + 2)
    _, x_same = solvers.mrr(mv, b, 1e-8, 200, snap=count)
    assert torch.equal(x_same, x_conv)
    assert not torch.equal(x_early, x_conv) and not torch.equal(x_late, x_conv)


def test_chebyshev_is_the_polynomial_of_its_degree():
    """Degree 1 is ``v / theta``; on an eigenvector the polynomial scales
    by the Chebyshev-iteration's value there, the same with any scaling."""
    grid = (5, 4)
    A = dense_laplacian(grid)
    lo, hi = stencil.spectral_bounds(grid)

    def mv(v):
        return stencil.apply(v, grid)

    v = torch.from_numpy(np.random.default_rng(3).standard_normal(20))
    z1 = solvers.chebyshev(mv, lo, hi, 1)(v)
    torch.testing.assert_close(z1, v / (0.5 * (lo + hi)), rtol=1e-15, atol=0)
    M = solvers.chebyshev(mv, lo, hi, 6)
    P = np.stack([M(torch.from_numpy(e)).numpy() for e in np.eye(20)], axis=1)
    np.testing.assert_allclose(P, P.T, atol=1e-12)  # a polynomial in A is symmetric
    np.testing.assert_allclose(P @ A, A @ P, atol=1e-12)  # and commutes with A


def test_nnz_hand_worked():
    # 3x3 grid: 9 centres, 2 * 2 * 3 neighbour pairs along each axis
    assert roofline.nnz((3, 3)) == 9 + 2 * (2 * 3) * 2 == 33
    assert roofline.nnz((3, 3)) == np.count_nonzero(dense_laplacian((3, 3)))
    A = dense_laplacian((8, 3, 4))
    assert roofline.nnz((8, 3, 4)) == np.count_nonzero(A)
    # rows of planes 2..5 of 8: their nonzeros, neighbour planes included
    assert roofline.nnz((8, 3, 4), (2, 6)) == np.count_nonzero(A[2 * 12: 6 * 12])
    assert roofline.nnz((8, 3, 4), (0, 2)) == np.count_nonzero(A[: 2 * 12])
    assert roofline.nnz((216, 216, 216)) == 7 * 216**3 - 6 * 216**2


def test_bounds_hand_worked():
    # K1 at N = 250k f64: 16 bytes a row at 3.35 TB/s beat 2 nnz at 34 TFLOP/s
    n, nnz = 250_000, 5 * 250_000 - 4 * 500
    assert roofline.spmv_bound_s(n, nnz, "float64") == pytest.approx(4e6 / 3.35e12)
    # a whole MrR solve of 10 iterations on a 3x3 grid: operations bound
    flops = 10 * (2 * 33 + 20 * 9)
    assert roofline.whole_solve_bound_s("mrr", 9, 33, 10, "float64") == pytest.approx(
        max(flops / 34e12, 2 * 9 * 8 / 3.35e12))
    assert roofline.whole_solve_bound_s("cg", 9, 33, 10, "float32") == pytest.approx(
        max(10 * (66 + 90) / 67e12, 2 * 9 * 4 / 3.35e12))
