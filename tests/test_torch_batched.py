"""Batched right-hand sides: krylov_tpu_torch.solve_batched and the batched
eager CG/MrR loops against krylov_tpu.solve_batched and against the
port's own solo solves.

The JAX package runs on the CPU with x64 (a ``vmap`` of its while_loop
solvers).  The port runs stencil systems member by member on its fused
route (the kernels' plain versions on the CPU), other operators (and
``fused=False``) through one batched eager loop (the k-skip family's is
held further in tests/test_torch_batched_kskip.py).  float64: equal iteration counts, outer
counts, nosl and convergence flags per member, residual histories rtol 1e-9
(atol 1e-13), x rtol 1e-8 (atol 1e-12); the k-skip family the tolerances of
tests/test_torch_kskip_solve.py.  A fused batch runs each member's solo
computation, so it equals the solo solves exactly.
"""

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.api import solve_batched as jax_solve_batched
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch.solvers import SolveResult, cg_kernel, mrr_kernel
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


TOLS = {"cg": (1e-9, 1e-13, 1e-8, 1e-12), "mrr": (1e-9, 1e-13, 1e-8, 1e-12)}
KSKIP_TOLS = (1e-5, 1e-11, 1e-6, 1e-9)


def _hyb():
    return jconvert.to_hyb(jfx.powerlaw_spd(400, seed=11, max_deg=100))


def _check_against_jax(res, ref, method):
    t_rtol, t_atol, x_rtol, x_atol = TOLS.get(method, KSKIP_TOLS)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.index.numpy(), np.asarray(ref.index))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=x_rtol, atol=x_atol)
    for j, idx in enumerate(np.asarray(ref.index)):
        m = int(idx) + 1
        np.testing.assert_allclose(res.residual_trace[j, :m].numpy(), np.asarray(ref.residual_trace)[j, :m],
                                   rtol=t_rtol, atol=t_atol)
        np.testing.assert_array_equal(res.nosl_trace[j, :m].numpy(), np.asarray(ref.nosl_trace)[j, :m])
        if ref.k_trace is not None:
            np.testing.assert_array_equal(res.k_trace[j, :m].numpy(), np.asarray(ref.k_trace)[j, :m])
    if ref.final_k is not None:
        np.testing.assert_array_equal(res.final_k.numpy(), np.asarray(ref.final_k))


def _check_against_solo(res, A, B, method, fused, **kw):
    _, _, x_rtol, x_atol = TOLS.get(method, KSKIP_TOLS) if fused is False else (0, 0, 0, 0)
    for j, b in enumerate(B):
        solo = krylov_tpu_torch.solve_device(A, b, method=method, fused=fused, **kw)
        assert int(res.iterations[j]) == int(solo.iterations) and bool(res.converged[j]) == bool(solo.converged)
        torch.testing.assert_close(res.x[j], solo.x, rtol=x_rtol, atol=x_atol)


@pytest.mark.parametrize(
    "method, k, fused",
    [("cg", 0, None), ("mrr", 0, None), ("kskipmrr", 2, None), ("adaptivekskipmrr", 4, None),
     ("cg", 0, False), ("mrr", 0, False), ("kskipcg", 3, False)],
)
def test_solve_batched_matches_jax_and_solo(method, k, fused):
    A = jfx.laplace2d(12)
    B = np.random.default_rng(0).standard_normal((4, A.shape[0]))
    kw = dict(method=method, k=k, tol=1e-9, maxiter=1000)
    ref = jax_solve_batched(A, B, **kw)
    At = from_jax_operator(A)
    res = krylov_tpu_torch.solve_batched(At, B, fused=fused, **kw)
    assert isinstance(res, SolveResult) and res.x.shape == (4, A.shape[0])
    assert res.residual_trace.shape[0] == res.nosl_trace.shape[0] == 4 and res.iterations.shape == (4,)
    assert bool(res.converged.all())
    _check_against_jax(res, ref, method)
    kw.pop("method")
    _check_against_solo(res, At, B, method, fused, **kw)


@pytest.mark.parametrize("method, k", [("cg", 0), ("mrr", 0), ("kskipmrr", 3)])
def test_solve_batched_hyb_matches_jax_and_solo(method, k):
    A = _hyb()
    B = np.random.default_rng(1).standard_normal((3, A.shape[0]))
    kw = dict(method=method, k=k, tol=1e-10, maxiter=400)
    ref = jax_solve_batched(A, B, **kw)
    At = from_jax_operator(A)
    res = krylov_tpu_torch.solve_batched(At, B, **kw)
    _check_against_jax(res, ref, method)
    kw.pop("method")
    _check_against_solo(res, At, B, method, False, **kw)


@pytest.mark.parametrize("fused", [None, False])
def test_solve_batched_warm_start_matches_jax(fused):
    A = jfx.laplace2d(10)
    rng = np.random.default_rng(2)
    B, X0 = rng.standard_normal((3, 100)), 0.1 * rng.standard_normal((3, 100))
    ref = jax_solve_batched(A, B, method="mrr", X0=X0, tol=1e-9, maxiter=500)
    res = krylov_tpu_torch.solve_batched(from_jax_operator(A), B, method="mrr", X0=X0, tol=1e-9, maxiter=500,
                                         fused=fused)
    _check_against_jax(res, ref, "mrr")


def test_batched_mixed_convergence_points():
    """As tests/test_batched.py: members that converge at different counts
    stay independent, each freezing on its own."""
    A = jfx.poisson1d(60)
    rng = np.random.default_rng(1)
    B = np.stack([1e-3 * np.asarray(A.matvec(np.ones(60) * 1e-3)), rng.standard_normal(60),
                  rng.standard_normal(60) * 100])
    ref = jax_solve_batched(A, B, method="cg", tol=1e-8, maxiter=500)
    res = krylov_tpu_torch.solve_batched(from_jax_operator(A), B, method="cg", tol=1e-8, maxiter=500)
    iters = res.iterations.numpy()
    assert bool(res.converged.all()) and len(set(iters.tolist())) > 1
    _check_against_jax(res, ref, "cg")
    for j in range(3):
        r = np.linalg.norm(B[j] - A.todense() @ res.x[j].numpy())
        assert r / max(np.linalg.norm(B[j]), 1e-30) < 1e-7


@pytest.mark.parametrize("kernel", [cg_kernel, mrr_kernel])
def test_batched_eager_loops_freeze_each_member(kernel):
    """A batch through the eager loop equals the solo loop member by member:
    counts and traces, with the diverged exit recorded per member."""
    A = from_jax_operator(jfx.poisson1d(50))
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 50)))
    B[0] = A.matvec(torch.full((50,), 1e-3))  # converges first
    for maxiter in (12, 200):
        res = kernel(A, B, torch.zeros_like(B), tol=1e-9, maxiter=maxiter)
        for j in range(3):
            solo = kernel(A, B[j], torch.zeros_like(B[j]), tol=1e-9, maxiter=maxiter)
            assert int(res.iterations[j]) == int(solo.iterations) and bool(res.converged[j]) == bool(solo.converged)
            m = int(solo.index) + 1
            torch.testing.assert_close(res.residual_trace[j, :m], solo.residual_trace[:m], rtol=1e-9, atol=1e-13)
            torch.testing.assert_close(res.x[j], solo.x, rtol=1e-8, atol=1e-12)


def test_solve_batched_rejects_what_it_does_not_take():
    A = fixtures.laplace2d(6)
    B = np.ones((2, 36))
    with pytest.raises(TypeError, match="DeviceMesh"):
        krylov_tpu_torch.solve_batched(A, B, mesh=object())
    # M= and spectral_bounds= on a method that does not read them
    for kw, match in ((dict(M=object()), "M= is read by"), (dict(spectral_bounds=(0.1, 8.0)), "spectral_bounds="),
                      (dict(method="pcg", spectral_bounds=(0.1, 8.0)), "spectral_bounds=")):
        with pytest.raises(ValueError, match=match):
            krylov_tpu_torch.solve_batched(A, B, **kw)
    with pytest.raises(ValueError, match="basis_norm"):
        krylov_tpu_torch.solve_batched(A, B, method="kskipmrr", k=2, basis_norm=True, fused=True)
    with pytest.raises(ValueError, match=r"B must be \(batch, N=36\)"):
        krylov_tpu_torch.solve_batched(A, np.ones(36))
    with pytest.raises(ValueError, match="X0"):
        krylov_tpu_torch.solve_batched(A, B, X0=np.ones((3, 36)))


def test_solve_batched_basis_norm_matches_jax():
    """basis_norm keeps a stencil batch off the fused route, member by
    member on the eager k-skip loops."""
    A = jfx.laplace2d(10)
    B = np.random.default_rng(4).standard_normal((2, 100))
    kw = dict(method="kskipmrr", k=3, tol=1e-9, maxiter=500, basis_norm=True)
    res = krylov_tpu_torch.solve_batched(from_jax_operator(A), B, **kw)
    _check_against_jax(res, jax_solve_batched(A, B, **kw), "kskipmrr")
    x, info = krylov_tpu.solve(A, B[1], **kw)
    assert int(res.iterations[1]) == info["iterations"]
