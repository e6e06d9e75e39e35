"""The Chebyshev-basis CA solvers (cacg, camrr) through krylov_tpu_torch
against the JAX package.

The JAX package runs on the CPU with x64 (tests/conftest.py).  Each
package estimates its own Lanczos bounds from the same numpy start vector
(they agree to about 1e-15), and the s-step recurrences run on one Gram
an outer iteration, summed in another order than XLA's.  float64: equal
iteration and outer counts, nosl and convergence; residual traces within
rtol 1e-8 (atol 1e-13), solutions within rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.solvers.cacg import camrr_kernel as jax_camrr
from krylov_tpu.solvers.cacg import cacg_kernel as jax_cacg
from krylov_tpu.sparse import as_operator as jax_as_operator
from krylov_tpu.sparse.fixtures import laplace2d, powerlaw_spd
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.solvers import cacg_kernel, camrr_kernel
from krylov_tpu_torch.solvers.cacg import _chebyshev_T, _monomial_T
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


def _compare(A, b, method, port_kw=None, **kw):
    xr, ir = krylov_tpu.solve(A, b, method=method, **kw)
    kw.update(port_kw or {})
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method=method, **kw)
    assert info["iterations"] == ir["iterations"]
    assert len(info["residual"]) == len(ir["residual"])  # outer iterations
    assert info["converged"] == ir["converged"]
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    return x, info, xr, ir


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_ca_solvers_match_jax(method, s):
    A = laplace2d(48)
    b = np.random.default_rng(1234).standard_normal(A.shape[0])
    x, info, xr, ir = _compare(A, b, method, k=s, tol=1e-8, maxiter=4000)
    assert info["converged"]
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_explicit_spectral_bounds_match_jax(method):
    """Given bounds are used as they are, by solve and solve_device alike."""
    A = laplace2d(32)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    x, info, xr, ir = _compare(A, b, method, k=4, tol=1e-8, maxiter=2000, spectral_bounds=(0.01, 8.0))
    assert info["converged"]
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-8, atol=1e-13)
    res = krylov_tpu_torch.solve_device(from_jax_operator(A), b, method=method, k=4, tol=1e-8, maxiter=2000,
                                        spectral_bounds=(0.01, 8.0))
    assert int(res.iterations) == info["iterations"] and torch.equal(res.x, x)


@pytest.mark.parametrize("kernel, jax_kernel", [(cacg_kernel, jax_cacg), (camrr_kernel, jax_camrr)])
def test_monomial_ablation_matches_jax(kernel, jax_kernel):
    """basis="monomial" through the same Gram algebra, at s = 2, and the
    change-of-basis matrices themselves."""
    A = laplace2d(24)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    Ad = jax.tree.map(jnp.asarray, A)
    want = jax_kernel(Ad, jnp.asarray(b), jnp.zeros(A.shape[0]), tol=1e-8, maxiter=2000, s=2, basis="monomial")
    bt = torch.from_numpy(b)
    got = kernel(from_jax_operator(A), bt, torch.zeros_like(bt), tol=1e-8, maxiter=2000, s=2, basis="monomial",
                 ctx=Context())
    assert bool(got.converged) and bool(want.converged)
    assert (int(got.iterations), int(got.index)) == (int(want.iterations), int(want.index))
    m = int(got.index) + 1
    np.testing.assert_array_equal(got.nosl_trace.numpy()[:m], np.asarray(want.nosl_trace)[:m])
    np.testing.assert_allclose(got.residual_trace.numpy()[:m], np.asarray(want.residual_trace)[:m], rtol=1e-8,
                               atol=1e-13)
    from krylov_tpu.solvers import cacg as jcacg

    blocks = ((0, 4), (5, 3))
    np.testing.assert_array_equal(_monomial_T(9, blocks), jcacg._monomial_T(9, blocks))
    np.testing.assert_array_equal(_chebyshev_T(9, blocks, 0.1, 7.9), jcacg._chebyshev_T(9, blocks, 0.1, 7.9))


@pytest.mark.parametrize("kernel", [cacg_kernel, camrr_kernel])
def test_bad_bounds_s_and_basis_raise(kernel):
    from krylov_tpu_torch.sparse import fixtures

    A = fixtures.laplace2d(8)
    b = torch.ones(64, dtype=torch.float64)
    x0 = torch.zeros_like(b)
    with pytest.raises(ValueError, match="spectral bounds"):
        kernel(A, b, x0, tol=1e-6, maxiter=10, s=2, lmin=5.0, lmax=1.0)
    with pytest.raises(ValueError, match="s must be"):
        kernel(A, b, x0, tol=1e-6, maxiter=10, s=0, lmin=0.1, lmax=8.0)
    with pytest.raises(ValueError, match="unknown basis"):
        kernel(A, b, x0, tol=1e-6, maxiter=10, s=2, lmin=0.1, lmax=8.0, basis="legendre")
    with pytest.raises(ValueError, match="spectral bounds"):
        krylov_tpu_torch.solve(A, b, method="cacg" if kernel is cacg_kernel else "camrr", k=2,
                               spectral_bounds=(1.0, 0.5))


@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_f32_divergence_guard_matches_jax(method):
    """tests/test_cacg.py's guard case: float32 vectors with float64
    scalars at s = 8 and an unreachable tol run through the float32 floor
    into the s-step instability; the guard rolls back (each rollback still
    counts s updates, as in the JAX package) and returns the best iterate.
    The same counts as the JAX package; a host float64 true residual below
    1e-5."""
    A = laplace2d(48, dtype=np.float32)
    b = np.random.default_rng(1234).standard_normal(A.shape[0]).astype(np.float32)
    x, info, xr, ir = _compare(A, b, method, port_kw=dict(scalar_dtype=torch.float64), k=8, tol=1e-30,
                               maxiter=320, scalar_dtype=jnp.float64)
    assert not info["converged"] and np.all(np.isfinite(info["residual"]))
    A64 = laplace2d(48).todense()
    true = np.linalg.norm(b - A64 @ x.double().numpy()) / np.linalg.norm(b)
    assert np.isfinite(true) and true < 1e-5


@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_f32_with_f64_scalars_converges_on_graded_powerlaw(method):
    """tests/test_cacg.py's row-4b class: float32 vectors, float64 scalars,
    s = 8 on the graded power-law system (kappa ~ 1e5), where the monomial
    k-skip basis records NaN: converged, host float64 true residual below
    5e-4."""
    P = powerlaw_spd(2048, shift=1e-3, diag_scale_decades=1.5, seed=0)
    A = from_jax_operator(jax_as_operator(P.astype(np.float32)))
    b = np.random.default_rng(1234).standard_normal(P.shape[0]).astype(np.float32)
    x, info = krylov_tpu_torch.solve(A, b, method=method, k=8, tol=1e-4, maxiter=6000, scalar_dtype=torch.float64)
    assert info["converged"] and np.all(np.isfinite(info["residual"]))
    assert np.linalg.norm(b - P @ x.double().numpy()) / np.linalg.norm(b) < 5e-4


def test_bounds_resolve_once_per_batch(monkeypatch):
    """solve_batched estimates the Lanczos bounds once for the batch; each
    member is the solo solve."""
    from krylov_tpu_torch import api
    from krylov_tpu_torch.sparse import fixtures

    calls = []
    real = api.lanczos_bounds
    monkeypatch.setattr(api, "lanczos_bounds", lambda A: calls.append(1) or real(A))
    A = fixtures.laplace2d(16)
    B = np.random.default_rng(5).standard_normal((3, A.shape[0]))
    res = krylov_tpu_torch.solve_batched(A, B, method="camrr", k=4, tol=1e-9)
    assert calls == [1] and bool(res.converged.all())
    for j in range(3):
        solo = krylov_tpu_torch.solve_device(A, B[j], method="camrr", k=4, tol=1e-9)
        assert int(res.index[j]) == int(solo.index) and torch.equal(res.x[j], solo.x)
