"""The slice as a whole: krylov_tpu_torch.solve against krylov_tpu.solve.

The JAX package runs on the CPU with x64 (tests/conftest.py), where its
solve takes the lax.while_loop solvers; the port takes its fused path's
plain versions for stencil systems and its eager loops otherwise (and with
fused=False).  float64: equal iteration counts and nosl, residual histories
within rtol 1e-9 (atol 1e-13: a CG/MrR run that ends by finite termination
records a last residual at rounding level, ~1e-14, which carries no
digits), solutions within rtol 1e-8.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.sparse.fixtures import laplace2d, laplace3d, poisson1d
from krylov_tpu_torch.api import _fused_eligible
from krylov_tpu_torch.context import Context
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SYSTEMS = {
    "laplace2d": lambda: laplace2d(24),
    "laplace2d-const": lambda: laplace2d(24, constant=True),
    "laplace3d-const": lambda: laplace3d(8, constant=True),
    "poisson1d": lambda: poisson1d(200),
}


def _compare(A, b, method, **kw):
    xr, ir = krylov_tpu.solve(A, b, method=method, **kw)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method=method, **kw)
    assert info["iterations"] == ir["iterations"]
    assert info["converged"] == ir["converged"]
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)
    return x, info


@pytest.mark.parametrize("name", sorted(SYSTEMS))
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_solve_matches_jax(method, name):
    A = SYSTEMS[name]()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x, info = _compare(A, b, method, tol=1e-8)
    assert info["converged"] == (name != "poisson1d")
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_solve_eager_route_matches_jax(method):
    """fused=False keeps a stencil system on the eager loops."""
    A = laplace2d(20, constant=True)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    _compare(A, b, method, tol=1e-8, fused=False)


@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_warm_start_matches_jax(method, fused):
    A = laplace2d(16)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(A.shape[0])
    x0 = 0.1 * rng.standard_normal(A.shape[0])
    _compare(A, b, method, tol=1e-8, x0=x0, fused=fused)


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_shift_only_for_warm_start(method, monkeypatch):
    """A cold start hands b to the fused solve as it is; only a given x0
    takes the shift b - A x0 through the stencil SpMV."""
    from krylov_tpu_torch.kernels import stencil

    calls = []
    real = stencil.stencil_matvec_2d
    monkeypatch.setattr(stencil, "stencil_matvec_2d", lambda *a, **k: calls.append(1) or real(*a, **k))
    A = fixtures.laplace2d(12, constant=True)
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    x_cold, _ = krylov_tpu_torch.solve(A, b, method=method, tol=1e-8)
    assert calls == []
    x_warm, info = krylov_tpu_torch.solve(A, b, method=method, tol=1e-8, x0=np.zeros(A.shape[0]))
    assert calls == [1]
    torch.testing.assert_close(x_warm, x_cold, rtol=0, atol=0)


def test_eager_maxiter_divergence_matches_jax():
    A = poisson1d(64)
    b = np.random.default_rng(3).standard_normal(64)
    for method in ("cg", "mrr"):
        _, info = _compare(A, b, method, tol=1e-14, maxiter=7)
        assert not info["converged"] and info["iterations"] == 7


def test_scipy_style_wrappers_and_solve_device():
    A = fixtures.laplace2d(10, constant=True)
    b = np.ones(A.shape[0])
    x1, i1 = krylov_tpu_torch.cg(A, b, tol=1e-8)
    x2, i2 = krylov_tpu_torch.mrr(A, b, tol=1e-8)
    res = krylov_tpu_torch.solve_device(A, b, method="cg", tol=1e-8)
    assert isinstance(res, SolveResult)
    assert int(res.iterations) == i1["iterations"]
    torch.testing.assert_close(res.x, x1)
    torch.testing.assert_close(x1, x2, rtol=1e-6, atol=1e-6)


def test_verbose_prints_banners(capsys):
    A = fixtures.laplace2d(6)
    krylov_tpu_torch.solve(A, np.ones(36), method="mrr", verbose=True)
    out = capsys.readouterr().out
    assert "Method:\t\tMrR" in out and "Status:\t\tconverged" in out


def test_wrong_shape_b_raises():
    A = fixtures.laplace2d(6)
    with pytest.raises(ValueError, match="shape mismatch"):
        krylov_tpu_torch.solve(A, np.ones(35))
    with pytest.raises(ValueError, match="must be a vector"):
        krylov_tpu_torch.solve(A, np.ones((2, 36)))


def test_unknown_method_raises():
    A = fixtures.laplace2d(6)
    with pytest.raises(ValueError, match="unknown method"):
        krylov_tpu_torch.solve(A, np.ones(36), method="nope")


@pytest.mark.parametrize(
    "kw, error, match",
    [
        # restarts= and refine= are ported; with mesh= or chunk_iters= below
        # maxiter they still raise, naming the item that brings those
        (dict(restarts=2, mesh=object()), NotImplementedError, "item 11"),
        (dict(refine=1, chunk_iters=5), NotImplementedError, "item 10"),
        (dict(chunk_iters=10), NotImplementedError, "item 10"),
        # M= and spectral_bounds= are ported; given to a method that does
        # not read them they raise instead of being dropped
        (dict(M=object()), ValueError, "M= is read by"),
        (dict(method="cacg", M=object()), ValueError, "M= is read by"),
    ],
    ids=["restarts", "refine", "chunk_iters", "M", "cacg"],
)
def test_unported_options_name_their_roadmap_item(kw, error, match):
    A = fixtures.laplace2d(6)
    with pytest.raises(error, match=match):
        krylov_tpu_torch.solve(A, np.ones(36), **kw)


def test_fused_eligibility():
    S, D = fixtures.laplace2d(6), fixtures.poisson1d(6)
    assert _fused_eligible(S, "cg", None, None, None)
    assert _fused_eligible(fixtures.laplace3d(4, constant=True), "mrr", None, torch.float64, None)
    assert not _fused_eligible(S, "cg", None, torch.float32, None)
    assert not _fused_eligible(S, "mrr", None, None, False)
    assert not _fused_eligible(D, "cg", None, None, None)
    with pytest.raises(ValueError, match="fused=True requires"):
        _fused_eligible(D, "cg", None, None, True)
    for method in ("kskipcg", "kskipmrr", "adaptivekskipmrr"):
        assert _fused_eligible(S, method, None, None, None)
        assert _fused_eligible(fixtures.laplace3d(4, constant=True), method, None, None, True)
        assert not _fused_eligible(S, method, None, torch.float32, None)
        assert not _fused_eligible(D, method, None, None, None)


def test_import_leaves_jax_out():
    code = "import sys, krylov_tpu_torch; sys.exit('jax' in sys.modules)"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_context_widens_operands_like_jax():
    """scalar_dtype widens the operands, so float32 vectors give float64
    inner products exact to float64."""
    import jax.numpy as jnp

    from krylov_tpu.context import Context as JaxContext
    from krylov_tpu_torch.context import Context

    rng = np.random.default_rng(5)
    U = rng.standard_normal((3, 40)).astype(np.float32)
    V = rng.standard_normal((2, 40)).astype(np.float32)
    ctx, jctx = Context(scalar_dtype=torch.float64), JaxContext(scalar_dtype=jnp.float64)
    Ut, Vt = torch.from_numpy(U), torch.from_numpy(V)
    pairs = [(Ut[0], Ut[1]), (Ut[2], Ut[2])]
    jpairs = [(jnp.asarray(U[0]), jnp.asarray(U[1])), (jnp.asarray(U[2]), jnp.asarray(U[2]))]
    for got, want in (
        (ctx.dot(Ut[0], Vt[0]), jctx.dot(jnp.asarray(U[0]), jnp.asarray(V[0]))),
        (ctx.norm(Ut[1]), jctx.norm(jnp.asarray(U[1]))),
        (ctx.dot_bundle(pairs), jctx.dot_bundle(jpairs)),
        (ctx.gram(Ut), jctx.gram(jnp.asarray(U))),
        (ctx.cross_gram(Ut, Vt), jctx.cross_gram(jnp.asarray(U), jnp.asarray(V))),
    ):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="item 11"):
        Context(axis="rows")


@pytest.mark.parametrize("chunk_iters", [36, 100])
def test_chunk_iters_at_or_above_maxiter_is_a_plain_solve(chunk_iters):
    """The JAX package chunks only below the effective maxiter (here n =
    36); at or above it the solve is the plain one, on both sides."""
    A = laplace2d(6)
    b = np.random.default_rng(9).standard_normal(36)
    xr, ir = krylov_tpu.solve(A, b, method="mrr", tol=1e-10, chunk_iters=chunk_iters)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method="mrr", tol=1e-10, chunk_iters=chunk_iters)
    x_plain, plain = krylov_tpu_torch.solve(from_jax_operator(A), b, method="mrr", tol=1e-10)
    assert info["iterations"] == plain["iterations"] == ir["iterations"]
    assert torch.equal(x, x_plain)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)


def test_context_is_exported_like_jax():
    assert krylov_tpu_torch.Context is Context
    assert krylov_tpu_torch.DEFAULT_CONTEXT == Context() and "Context" in krylov_tpu_torch.__all__
    assert "DEFAULT_CONTEXT" in krylov_tpu_torch.__all__


@pytest.mark.parametrize(
    "method, kw, match",
    [
        ("cg", dict(M="jacobi"), "M= is read by"),
        ("kskipmrr", dict(M="jacobi", k=2), "M= is read by"),
        ("camrr", dict(M="jacobi", k=2), "M= is read by"),
        ("mrr", dict(spectral_bounds=(0.1, 8.0)), "spectral_bounds= is read by"),
        ("pcg", dict(spectral_bounds=(0.1, 8.0)), "spectral_bounds= is read by"),
    ],
)
def test_options_a_method_does_not_read_raise(method, kw, match):
    """Where the JAX package drops M= and spectral_bounds= silently for a
    method that does not read them, the port raises, from every entry
    point."""
    from krylov_tpu_torch import precond

    A = fixtures.laplace2d(6)
    if "M" in kw:
        kw = dict(kw, M=precond.jacobi(A))
    for call in (krylov_tpu_torch.solve, krylov_tpu_torch.solve_device):
        with pytest.raises(ValueError, match=match):
            call(A, np.ones(36), method=method, **kw)
    with pytest.raises(ValueError, match=match):
        krylov_tpu_torch.solve_batched(A, np.ones((2, 36)), method=method, **kw)


def test_new_methods_stay_eager():
    S = fixtures.laplace2d(6)
    for method in ("pcg", "chronopoulos_gear", "gropp", "pipelined_cg", "cacg", "camrr"):
        assert not _fused_eligible(S, method, None, None, None)
    assert not _fused_eligible(S, "cg", object(), None, None)
