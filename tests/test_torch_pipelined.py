"""The preconditioned and pipelined CG family through krylov_tpu_torch.solve
against krylov_tpu.solve.

The JAX package runs on the CPU with x64 (tests/conftest.py); operators and
preconditioners cross through from_jax_operator, so both packages apply the
same M (a Chebyshev preconditioner keeps the JAX package's Lanczos
interval).  float64: equal iteration counts, convergence and nosl,
residual histories within rtol 1e-9 (atol 1e-14 for residuals at rounding
level), solutions within rtol 1e-8.  Without M, preconditioned CG is the
port's CG bit for bit.
"""

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu import precond as jprecond
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch import precond
from krylov_tpu_torch.solvers import SolveResult
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


METHODS = ["pcg", "chronopoulos_gear", "gropp", "pipelined_cg"]
SYSTEMS = {
    "laplace2d": lambda: jfx.laplace2d(24),
    "hyb": lambda: jconvert.to_hyb(jfx.powerlaw_spd(2048)),
}
PRECONDS = {
    "none": lambda A: None,
    "jacobi": jprecond.jacobi,
    "chebyshev4": lambda A: jprecond.chebyshev(A, degree=4),
}


def _compare(A, b, method, M=None, **kw):
    xr, ir = krylov_tpu.solve(A, b, method=method, M=M, **kw)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method=method,
                                     M=None if M is None else from_jax_operator(M), **kw)
    assert info["iterations"] == ir["iterations"]
    assert info["converged"] == ir["converged"]
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)
    return x, info


@pytest.mark.parametrize("pre", sorted(PRECONDS))
@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("method", METHODS)
def test_pipelined_family_matches_jax(method, system, pre):
    A = SYSTEMS[system]()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    _, info = _compare(A, b, method, M=PRECONDS[pre](A), tol=1e-8, maxiter=2000)
    assert info["converged"]


@pytest.mark.parametrize("method", METHODS)
def test_pipelined_maxiter_divergence_matches_jax(method):
    """An unreachable tol: the budget runs out, the final residual is
    written after the loop, as in the JAX package."""
    A = jfx.poisson1d(64)
    b = np.random.default_rng(3).standard_normal(64)
    _, info = _compare(A, b, method, M=jprecond.jacobi(A), tol=1e-14, maxiter=7)
    assert not info["converged"] and info["iterations"] == 7


@pytest.mark.parametrize("method", METHODS)
def test_warm_start_and_replacement_period_match_jax(method):
    """A warm start; on laplace2d(32) pipelined CG runs through several
    residual replacements (every 25 iterations)."""
    A = jfx.laplace2d(32)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(A.shape[0])
    _, info = _compare(A, b, method, x0=0.1 * rng.standard_normal(A.shape[0]), tol=1e-9, maxiter=1000)
    assert info["converged"] and info["iterations"] > 75


def test_unpreconditioned_pcg_is_cg():
    A = fixtures.laplace2d(20, constant=True)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    x, info = krylov_tpu_torch.solve(A, b, method="pcg", tol=1e-9)
    xc, ic = krylov_tpu_torch.solve(A, b, method="cg", tol=1e-9, fused=False)
    assert info["iterations"] == ic["iterations"]
    np.testing.assert_array_equal(info["residual"], ic["residual"])
    assert torch.equal(x, xc)


@pytest.mark.parametrize("method", METHODS)
def test_float32_with_float64_scalars_converges(method):
    """float32 vectors, float64 inner products and scalars, Jacobi on the
    graded HYB: converged, and the host float64 true residual near tol
    (the pipelined recurrences drift; pipelined CG's replacements hold it)."""
    P = jfx.powerlaw_spd(2048, diag_scale_decades=1.5, seed=1)
    A = from_jax_operator(jconvert.to_hyb(P), dtype=np.float32)
    b = np.random.default_rng(6).standard_normal(A.shape[0]).astype(np.float32)
    x, info = krylov_tpu_torch.solve(A, b, method=method, M=precond.jacobi(A), tol=1e-5, maxiter=3000,
                                     scalar_dtype=torch.float64)
    assert info["converged"] and x.dtype == torch.float32
    true = np.linalg.norm(b - P @ x.double().numpy()) / np.linalg.norm(b)
    assert true < 1e-4


@pytest.mark.parametrize("method", ["pcg", "pipelined_cg"])
def test_solve_batched_with_M_matches_solo(method):
    """solve_batched runs the preconditioned methods member by member: each
    member is the solo solve, bit for bit."""
    A = fixtures.laplace2d(16)
    M = precond.chebyshev(A, degree=3)
    B = np.random.default_rng(7).standard_normal((3, A.shape[0]))
    res = krylov_tpu_torch.solve_batched(A, B, method=method, M=M, tol=1e-9)
    assert res.x.shape == B.shape and bool(res.converged.all())
    for j in range(3):
        solo = krylov_tpu_torch.solve_device(A, B[j], method=method, M=M, tol=1e-9)
        assert int(res.iterations[j]) == int(solo.iterations)
        assert torch.equal(res.x[j], solo.x)


def test_scipy_style_wrappers_and_refine():
    A = fixtures.laplace2d(12, dtype=torch.float32, constant=True)
    b = np.random.default_rng(8).standard_normal(A.shape[0]).astype(np.float32)
    M = precond.jacobi(A)
    for name in METHODS:
        x, info = getattr(krylov_tpu_torch.api, name)(A, b, tol=1e-5, M=M)
        assert info["converged"] and isinstance(x, torch.Tensor)
    res = krylov_tpu_torch.solve_device(A, b, method="gropp", M=M, tol=1e-5)
    assert isinstance(res, SolveResult) and bool(res.converged)
    # refine= passes M on to each correction solve
    x, info = krylov_tpu_torch.solve(A, b, method="pcg", M=M, tol=1e-9, refine=3)
    assert info["refinements"] >= 1 and info["true_residual"] < 1e-9 and x.dtype == torch.float64


@pytest.mark.parametrize("method", METHODS)
def test_preconditioned_methods_stay_off_the_fused_route(method):
    A = fixtures.laplace2d(8, constant=True)
    with pytest.raises(ValueError, match="fused=True requires"):
        krylov_tpu_torch.solve(A, np.ones(64), method=method, fused=True)
