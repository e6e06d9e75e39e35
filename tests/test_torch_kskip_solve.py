"""The k-skip family through krylov_tpu_torch.solve against krylov_tpu.solve.

The JAX package runs on the CPU with x64 (tests/conftest.py), where it
takes its lax.while_loop solvers.  The port takes the plain versions of
its fused kernels for stencil systems and its eager loops otherwise (and
with ``fused=False`` or ``basis_norm=True``).  float64: equal iteration
counts, ``nosl``, ``khistory`` and ``final_k``.  The k-step scalar
recurrences amplify the rounding of the bundle (the Gram is summed in
another order than XLA's), so residual histories agree to rtol 1e-5 and
solutions to rtol 1e-6, atol 1e-9, as in tests/test_kernels.py.  The
residual atol is 1e-11: a solve that ends by finite termination
(poisson1d) or a steep last drop records a final residual near 1e-12 whose
digits are that amplified rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.solvers._common import pow2_scale as jax_pow2_scale
from krylov_tpu.sparse.fixtures import laplace2d, laplace3d, poisson1d
from krylov_tpu_torch.solvers import SolveResult
from krylov_tpu_torch.solvers._common import pow2_scale, tree_select
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator
from test_torch_kskip import advection


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


METHODS = ["kskipcg", "kskipmrr", "adaptivekskipmrr"]


def _compare(A, b, method, **kw):
    xr, ir = krylov_tpu.solve(A, b, method=method, **kw)
    port_kw = {key: (torch.float64 if key == "scalar_dtype" else v) for key, v in kw.items()}
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method=method, **port_kw)
    assert info["iterations"] == ir["iterations"]
    assert info["converged"] == ir["converged"]
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    assert ("khistory" in info) == ("khistory" in ir) == (method == "adaptivekskipmrr")
    if "khistory" in ir:
        np.testing.assert_array_equal(info["khistory"], ir["khistory"])
        assert info["final_k"] == ir["final_k"]
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-5, atol=1e-11)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-6, atol=1e-9)
    return x, info


@pytest.mark.parametrize("name", ["laplace2d", "laplace3d-const"])
@pytest.mark.parametrize("method", METHODS)
def test_fused_route_matches_jax(method, name):
    """Stencil systems take the fused route (plain versions on the CPU)."""
    A = laplace2d(20) if name == "laplace2d" else laplace3d(8, constant=True)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    _, info = _compare(A, b, method, k=3, tol=1e-8)
    assert info["converged"]


@pytest.mark.parametrize("system", ["poisson1d", "laplace2d"])
@pytest.mark.parametrize("method", METHODS)
def test_eager_loops_match_jax(method, system):
    """The eager loops (a banded operator, or fused=False) against the JAX
    while_loop solvers; poisson1d(80) with k=2 is tests/test_kskip.py's
    nosl-stride system."""
    if system == "poisson1d":
        A, b, kw = poisson1d(80), np.random.default_rng(12).standard_normal(80), dict(tol=1e-9)
    else:
        A, kw = laplace2d(12), dict(tol=1e-8, fused=False)
        b = np.random.default_rng(5).standard_normal(A.shape[0])
    _, info = _compare(A, b, method, k=2, maxiter=1000, **kw)
    assert info["converged"]
    if method != "adaptivekskipmrr":
        start = 1 if method == "kskipmrr" else 0  # MrR init step
        assert np.all(np.diff(info["nosl"][start + 1:]) == 3)


def test_eager_adaptive_rollback_matches_jax():
    """fused=False on both sides: the eager loop rolls back on the
    advection stencil as the JAX while_loop does."""
    A = advection()
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    _, info = _compare(A, b, "adaptivekskipmrr", k=6, tol=1e-8, maxiter=2000, fused=False)
    assert info["final_k"] < 6 and info["converged"]


@pytest.mark.parametrize("method", METHODS)
def test_eager_maxiter_divergence_matches_jax(method):
    A = poisson1d(64)
    b = np.random.default_rng(3).standard_normal(64)
    _, info = _compare(A, b, method, k=2, tol=1e-14, maxiter=7)
    assert not info["converged"] and info["iterations"] >= 7


@pytest.mark.parametrize("method", METHODS)
def test_basis_norm_matches_jax(method):
    """basis_norm=True runs the eager loops with power-of-two scaled chains,
    on both sides; in float64 it takes the raw basis's iteration count."""
    A = laplace2d(16)
    b = np.random.default_rng(1234).standard_normal(A.shape[0])
    _, info = _compare(A, b, method, k=4, tol=1e-8, maxiter=4000, basis_norm=True)
    _, raw = krylov_tpu_torch.solve(from_jax_operator(A), b, method=method, k=4, tol=1e-8, maxiter=4000)
    assert info["iterations"] == raw["iterations"]


@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr"])
def test_scalar_dtype_f64_on_f32_vectors_matches_jax(method):
    """float32 vectors with float64 bundle and recurrences (the eager route:
    the fused kernels compute their scalars in the vector dtype).  The
    float32 vector updates round differently in torch and XLA, by about
    1e-6 of ||b|| over the solve: equal iteration counts, residuals within
    atol 1e-5 (the tol), x within 1e-3."""
    A = laplace2d(16, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    xr, ir = krylov_tpu.solve(A, b, method=method, k=4, tol=1e-5, maxiter=600, scalar_dtype=jnp.float64)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method=method, k=4, tol=1e-5, maxiter=600,
                                     scalar_dtype=torch.float64)
    assert info["converged"] and ir["converged"]
    assert info["iterations"] == ir["iterations"]
    assert x.dtype == torch.float32 and info["residual"].dtype == np.float64
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-3, atol=1e-3)


def test_pow2_scale_matches_jax_exactly():
    """Powers of two, exact, half-to-even rounding of log2, the exponent
    clip, and 1 for zero, negative and non-finite inputs."""
    s = np.array([1e-30, 0.7, 1.0, 1.5, 3.0, 1264.0, 1e30, np.sqrt(2.0), 0.0, -1.0, np.nan, np.inf])
    for dt in (torch.float64, torch.float32):
        got = pow2_scale(torch.tensor(s, dtype=dt)).numpy()
        want = np.asarray(jax_pow2_scale(jnp.asarray(s, dtype=str(dt).removeprefix("torch."))))
        np.testing.assert_array_equal(got, want)
        m, _ = np.frexp(got)
        assert np.all(m == 0.5)
    # float64 norms beyond the float32 exponent range scale partially
    big = torch.tensor([2.0**200, 2.0**-200], dtype=torch.float64)
    np.testing.assert_array_equal(pow2_scale(big).numpy(), np.asarray(jax_pow2_scale(jnp.asarray(big.numpy()))))
    assert pow2_scale(big).tolist() == [2.0**127, 2.0**-126]
    np.testing.assert_array_equal(pow2_scale(torch.tensor([0.0, -1.0, np.nan, np.inf])).numpy(), 1.0)


def test_tree_select():
    pred = torch.tensor(True)
    a, b = (torch.ones(3), torch.tensor(2.0)), (torch.zeros(3), torch.tensor(5.0))
    got = tree_select(pred, a, b)
    assert torch.equal(got[0], a[0]) and got[1].item() == 2.0
    assert tree_select(~pred, a, b)[1].item() == 5.0


def test_basis_norm_with_fused_true_raises():
    A = fixtures.laplace2d(6)
    with pytest.raises(ValueError, match="basis_norm"):
        krylov_tpu_torch.solve(A, np.ones(36), method="kskipcg", k=2, basis_norm=True, fused=True)


def test_basis_norm_ignored_off_the_kskip_family():
    """basis_norm on cg only keeps the solve off the fused route, as in the
    JAX package; the eager CG gives the same answer."""
    A = fixtures.laplace2d(10, constant=True)
    b = np.random.default_rng(2).standard_normal(100)
    x1, i1 = krylov_tpu_torch.solve(A, b, method="cg", tol=1e-8, basis_norm=True)
    x2, i2 = krylov_tpu_torch.solve(A, b, method="cg", tol=1e-8, fused=False)
    assert i1["iterations"] == i2["iterations"]
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)


@pytest.mark.parametrize("method", METHODS)
def test_warm_start_matches_jax(method):
    A = laplace2d(16)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(A.shape[0])
    x0 = 0.1 * rng.standard_normal(A.shape[0])
    _compare(A, b, method, k=2, tol=1e-8, x0=x0)


def test_scipy_style_wrappers_solve_device_and_banner(capsys):
    A = fixtures.laplace2d(10, constant=True)
    b = np.ones(A.shape[0])
    x1, i1 = krylov_tpu_torch.kskipcg(A, b, tol=1e-8, k=2)
    x2, i2 = krylov_tpu_torch.kskipmrr(A, b, tol=1e-8, k=2)
    x3, i3 = krylov_tpu_torch.adaptivekskipmrr(A, b, tol=1e-8, k=2, verbose=True)
    out = capsys.readouterr().out
    assert "Method:\t\tAdaptive k-skip MrR" in out and "Initial_k:\t2" in out and "Final_k:\t2" in out
    assert "khistory" in i3 and "khistory" not in i1 and "final_k" not in i2
    res = krylov_tpu_torch.solve_device(A, b, method="adaptivekskipmrr", k=2, tol=1e-8)
    assert isinstance(res, SolveResult) and int(res.final_k) == i3["final_k"]
    assert int(res.iterations) == i3["iterations"]
    torch.testing.assert_close(res.x, x3)
    torch.testing.assert_close(x1, x2, rtol=1e-6, atol=1e-6)
