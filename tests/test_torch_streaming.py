"""The port's large-system route on the CPU: BASELINE row 5's configuration
(adaptive k-skip MrR, k = 8, tol 1e-4, ``restarts=1``, maxiter 4000, a
constant-weight 3-D Laplacian) at a small size against the JAX package,
and the route plans that send row 5 and its neighbours to the streaming
kernels.

The JAX package runs on the CPU with x64 (tests/conftest.py).  The port
takes the plain version of its fused K5 on the CPU (the eager adaptive
loop on the stencil).  float64: equal iterations, ``nosl``, ``khistory``
and ``final_k``; the k-step recurrences amplify the rounding of the bundle
(summed in another order than XLA's), so residual histories agree to rtol
1e-5 (atol 1e-11), as in tests/test_torch_kskip_solve.py, and so does the
true residual (the ``restarts=`` pass's ``||b - A x|| / ||b||``).  At
k = 8 that rounding reaches x further than at the k <= 4 of that file's
rtol 1e-6 (atol 1e-9): on this system the two packages' x differ by up to
1.44e-6, 1.15e-6 of max |x| (residuals 4.4e-7 relative), so x is held to
``max |x - x_jax| <= X_REL * max |x_jax|``, about 9x above that reading.
"""

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.sparse.fixtures import laplace3d
from krylov_tpu_torch.kernels import fused, fused_kskip
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


ROW5 = dict(method="adaptivekskipmrr", k=8, tol=1e-4, restarts=1, maxiter=4000)
X_REL = 1e-5
H100_SMS = 132


def _row5_system(dtype=np.float64):
    A = laplace3d(16, 18, 20, dtype=dtype, constant=True)
    return A, np.random.default_rng(0).standard_normal(A.shape[0])


def _assert_x_close(x, x_jax) -> None:
    x_jax = np.asarray(x_jax)
    assert float(np.abs(np.asarray(x) - x_jax).max()) <= X_REL * float(np.abs(x_jax).max())


def test_row5_solve_device_matches_jax():
    """solve_device: the fused route's plain K5, then the restarts= pass."""
    A, b = _row5_system()
    want = krylov_tpu.solve_device(A, b, **ROW5)
    got = krylov_tpu_torch.solve_device(from_jax_operator(A), b, **ROW5)
    idx = int(want.index)
    assert int(got.index) == idx and int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_array_equal(got.nosl_trace[: idx + 1].numpy(), np.asarray(want.nosl_trace)[: idx + 1])
    np.testing.assert_array_equal(got.k_trace[: idx + 1].numpy(), np.asarray(want.k_trace)[: idx + 1])
    assert int(got.final_k) == int(want.final_k)
    np.testing.assert_allclose(got.residual_trace[: idx + 1].numpy(), np.asarray(want.residual_trace)[: idx + 1],
                               rtol=1e-5, atol=1e-11)
    _assert_x_close(got.x.numpy(), want.x)
    np.testing.assert_allclose(float(got.true_residual), float(want.true_residual), rtol=1e-5)
    assert float(got.true_residual) < ROW5["tol"]


def test_row5_solve_matches_jax():
    """solve: the same counts, histories, khistory, final k and true
    residual in the info dict."""
    A, b = _row5_system()
    xr, ir = krylov_tpu.solve(A, b, **ROW5)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, **ROW5)
    assert info["iterations"] == ir["iterations"] and info["converged"] == ir["converged"]
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    np.testing.assert_array_equal(info["khistory"], ir["khistory"])
    assert info["final_k"] == ir["final_k"]
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-5, atol=1e-11)
    _assert_x_close(x.numpy(), xr)
    np.testing.assert_allclose(info["true_residual"], ir["true_residual"], rtol=1e-5)
    assert info["converged"] and info["true_residual"] < ROW5["tol"]


def test_row5_float32_converges():
    """float32: converged, with the host-float64 true residual below tol."""
    A = fixtures.laplace3d(16, 18, 20, dtype=torch.float32, constant=True)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x, info = krylov_tpu_torch.solve(A, b, **ROW5)
    A64 = fixtures.laplace3d(16, 18, 20, dtype=torch.float64, constant=True)
    true_rel = float(np.linalg.norm(b - A64.matvec(x.double()).numpy()) / np.linalg.norm(b))
    assert x.dtype == torch.float32 and info["converged"] and true_rel < ROW5["tol"]


def _collapsed(n: int):
    """The collapsed grid and stencil of laplace3d(n, constant=True)."""
    _, stencil, grid, _ = fixtures.laplace3d(n, constant=True).collapse_to_2d()
    return grid, stencil


# The route of each plan on a 132-SM card as the plans stand: K2/K3 (mrr),
# K5 (kskipmrr at k_max 8 and 4) and K6 (kskipcg at k_max 4) on the
# collapsed laplace3d(n); the resident route's edge lies between 64 and 65
# in 3-D, lower for K5/K6 in float64, whose shared memory also holds the
# band arrays and the bundle
EDGE = {
    (64, torch.float64): ("resident", "streaming", "streaming", "streaming"),
    (64, torch.float32): ("resident", "resident", "resident", "resident"),
    (65, torch.float64): ("streaming",) * 4,
    (65, torch.float32): ("streaming",) * 4,
    (100, torch.float64): ("streaming",) * 4,
    (100, torch.float32): ("streaming",) * 4,
    (216, torch.float64): ("streaming",) * 4,
    (216, torch.float32): ("streaming",) * 4,
}


@pytest.mark.parametrize("n, dtype", sorted(EDGE, key=str))
def test_3d_routes(n, dtype):
    """laplace3d(216) (row 5) and laplace3d(100) stream on every plan; the
    resident-to-streaming edge at laplace3d(64) / (65) as it stands."""
    grid, stencil = _collapsed(n)
    routes = (fused.plan("mrr", grid, stencil, dtype, H100_SMS).route,
              fused_kskip.plan("kskipmrr", grid, stencil, dtype, H100_SMS, 8).route,
              fused_kskip.plan("kskipmrr", grid, stencil, dtype, H100_SMS, 4).route,
              fused_kskip.plan("kskipcg", grid, stencil, dtype, H100_SMS, 4).route)
    assert routes == EDGE[n, dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_main_path_system_stays_resident(dtype):
    """laplace2d(500), the main-path system, stays on the resident route."""
    A = fixtures.laplace2d(500, constant=True)
    assert fused.plan("mrr", A.grid, A.stencil, dtype, H100_SMS).route == "resident"
    assert fused_kskip.plan("kskipmrr", A.grid, A.stencil, dtype, H100_SMS, 8).route == "resident"


def test_row5_streaming_pass_and_index_range():
    """Row 5 takes the pass specialised on 7 terms, and every index its
    streaming K5 forms fits an int: the flat point index plus any stencil
    offset, the tiles of the specialised pass, the 10 n-vectors of work
    (offsets as size_t, each vector's index an int) and the partials of any
    grid the card can hold."""
    grid, stencil = _collapsed(216)
    n = grid[0] * grid[1]
    assert grid == (216, 216 * 216) and n == 10_077_696
    assert fused.pass_terms(stencil, True) == 7 and fused.pass_terms(stencil, False) == 0
    int_max = 2**31 - 1
    reach = max(abs(d0 * grid[1] + d1) for d0, d1 in stencil)
    assert n + reach <= int_max and 10 * n <= int_max
    for itemsize in (4, 8):
        tile = fused.STREAM_THREADS * 16 // itemsize
        assert grid[0] * -(-grid[1] // tile) <= int_max
    m = 6 * 8 + 6
    most_blocks = 32 * H100_SMS  # 2048 threads an SM over 64-thread blocks, far above a 256-thread grid
    assert (m + 3) * most_blocks + m <= int_max
