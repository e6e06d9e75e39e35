"""krylov_tpu_torch.precond against krylov_tpu.precond.

The JAX package runs on the CPU with x64 (tests/conftest.py); operators
and preconditioners cross through from_jax_operator.  The diagonal, the
Jacobi scaling and the Gershgorin bounds are read on the host in numpy by
both packages: bitwise equal.  lanczos_bounds starts both packages from the
same numpy vector; its inner products and projections sum in another order
than XLA's, so the bounds agree to rtol 1e-10.  A Chebyshev application is
d SpMVs and axpys, rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu import precond as jprecond
from krylov_tpu.context import Context as JaxContext
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch import precond
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


CONTAINERS = {
    "stencil": lambda: jfx.laplace2d(12, 9),
    "stencil-const": lambda: jfx.laplace2d(12, 9, constant=True),
    "stencil-3d-const": lambda: jfx.laplace3d(5, 4, 3, constant=True),
    "dia": lambda: jfx.poisson1d(50),
    "ell": lambda: jfx.random_spd_ell(300, seed=3),
    "hyb": lambda: jconvert.to_hyb(jfx.powerlaw_spd(600, seed=2, max_deg=120)),
    "dense": lambda: jconvert.to_dense(jfx.powerlaw_spd(80, seed=4)),
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_diagonal_jacobi_and_gershgorin_bitwise(name):
    A = CONTAINERS[name]()
    At = from_jax_operator(A)
    d = precond.extract_diagonal(At)
    assert isinstance(d, np.ndarray)
    np.testing.assert_array_equal(d, jprecond.extract_diagonal(A))
    M, Mr = precond.jacobi(At), jprecond.jacobi(A)
    assert M.offsets == Mr.offsets == (0,) and M.shape == Mr.shape and M.device == At.device
    np.testing.assert_array_equal(M.data.numpy(), np.asarray(Mr.data))
    assert precond.gershgorin_bounds(At) == jprecond.gershgorin_bounds(A)


@pytest.mark.parametrize("name", ["stencil", "stencil-const", "dia", "hyb", "dense"])
def test_lanczos_bounds_match_jax(name):
    A = CONTAINERS[name]()
    got = precond.lanczos_bounds(from_jax_operator(A))
    want = jprecond.lanczos_bounds(A)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(precond.lanczos_bounds(from_jax_operator(A), m=8, seed=3, safety=1.2),
                               jprecond.lanczos_bounds(A, m=8, seed=3, safety=1.2), rtol=1e-10)


@pytest.mark.parametrize("name", ["stencil", "stencil-3d-const", "hyb"])
@pytest.mark.parametrize("degree", [1, 4, 6])
def test_chebyshev_apply_matches_jax(name, degree):
    """The same preconditioner (carried across with its bounds) applied to
    one vector, and to a (batch, n) block member by member."""
    A = CONTAINERS[name]()
    Mr = jprecond.chebyshev(A, degree=degree)
    M = from_jax_operator(Mr)
    assert isinstance(M, precond.ChebyshevPreconditioner) and M.needs_ctx
    assert (M.lmin, M.lmax, M.degree) == (Mr.lmin, Mr.lmax, Mr.degree)
    V = np.random.default_rng(7).standard_normal((3, A.shape[0]))
    want = np.asarray(JaxContext().matvec(Mr, jnp.asarray(V[0])))
    got = Context().matvec(M, torch.from_numpy(V[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14 * np.abs(want).max())
    block = M.matvec(torch.from_numpy(V), Context())
    for j in range(3):
        np.testing.assert_allclose(block[j].numpy(), M.matvec(torch.from_numpy(V[j]), Context()).numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_chebyshev_bounds_choices_match_jax():
    A = jfx.laplace2d(16)
    At = from_jax_operator(A)
    for kw in (dict(bounds="gershgorin"), dict(lmin=0.1), dict(lmax=9.0, bounds="gershgorin"),
               dict(lmin=0.2, lmax=7.5)):
        M, Mr = precond.chebyshev(At, **kw), jprecond.chebyshev(A, **kw)
        assert (M.lmin, M.lmax, M.degree) == (Mr.lmin, Mr.lmax, Mr.degree)
    for bounds in ("auto", "lanczos"):
        M, Mr = precond.chebyshev(At, degree=6, bounds=bounds), jprecond.chebyshev(A, degree=6, bounds=bounds)
        np.testing.assert_allclose((M.lmin, M.lmax), (Mr.lmin, Mr.lmax), rtol=1e-10)
    with pytest.raises(ValueError, match="bounds must be"):
        precond.chebyshev(At, bounds="nope")


def test_chebyshev_auto_falls_back_only_on_a_degenerate_interval(monkeypatch):
    """bounds="auto" takes Gershgorin's interval where Lanczos gives a
    degenerate one, and lets any error of the Lanczos run through (the JAX
    package catches every exception there)."""
    A = fixtures.laplace2d(10)
    monkeypatch.setattr(precond, "lanczos_bounds", lambda A: (float("nan"), 1.0))
    M = precond.chebyshev(A)
    assert (M.lmin, M.lmax) == precond.gershgorin_bounds(A)

    def broken(A):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(precond, "lanczos_bounds", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        precond.chebyshev(A)


def test_float32_jacobi_keeps_the_dtype():
    A = jfx.laplace2d(8, dtype=np.float32)
    M = precond.jacobi(from_jax_operator(A))
    assert M.dtype == torch.float32
    np.testing.assert_array_equal(M.data.numpy(), np.asarray(jprecond.jacobi(A).data))
