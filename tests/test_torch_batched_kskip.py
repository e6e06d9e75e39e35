"""Batched k-skip solves: krylov_tpu_torch.solve_batched of kskipcg,
kskipmrr and adaptivekskipmrr on the eager loops (``fused=False``, a
non-stencil operator, or ``basis_norm=True``) against the JAX package's
``vmap`` and against each member's solo solve.

The batch runs as one loop over ``(batch, N)`` blocks; the adaptive loop
reads the guard of the whole batch at once and steps its members grouped
by their current k.  float64: equal iteration counts, outer counts, nosl,
ktrace, final k and convergence flags per member; residual histories and
x at the tolerances of tests/test_torch_kskip_solve.py (rtol 1e-5, atol
1e-11; x rtol 1e-6, atol 1e-9), against the JAX package and against the
solo solves alike: a batched inner product sums in another order than a
solo one, and the k-step recurrences amplify that rounding.
"""

import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu.api import solve_batched as jax_solve_batched
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch import api
from krylov_tpu_torch.solvers import adaptivekskipmrr_kernel, kskipcg_kernel, kskipmrr_kernel
from krylov_tpu_torch.sparse.convert import from_jax_operator
from test_torch_batched import _check_against_jax
from test_torch_kskip import advection


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


METHODS = [("kskipcg", 3), ("kskipmrr", 3), ("adaptivekskipmrr", 4)]
TRACE_TOL, X_TOL = dict(rtol=1e-5, atol=1e-11), dict(rtol=1e-6, atol=1e-9)


def _check_against_solo(res, A, B, method, **kw):
    """Each member against its solo eager solve."""
    for j, b in enumerate(B):
        solo = krylov_tpu_torch.solve_device(A, b, method=method, fused=False, **kw)
        for field in ("iterations", "index", "converged", "final_k"):
            if getattr(solo, field) is not None:
                assert getattr(res, field)[j].item() == getattr(solo, field).item(), (j, field)
        m = int(solo.index) + 1
        torch.testing.assert_close(res.nosl_trace[j, :m], solo.nosl_trace[:m], rtol=0, atol=0)
        if solo.k_trace is not None:
            torch.testing.assert_close(res.k_trace[j, :m], solo.k_trace[:m], rtol=0, atol=0)
        torch.testing.assert_close(res.residual_trace[j, :m], solo.residual_trace[:m], **TRACE_TOL)
        torch.testing.assert_close(res.x[j], solo.x, **X_TOL)


def _system(name):
    """``(A, options)``: the HYB solves stop at tol 1e-7, where their last
    residual (1e-8) still stands above the amplified rounding."""
    if name == "hyb":
        return jconvert.to_hyb(jfx.powerlaw_spd(400, seed=11, max_deg=100)), {"tol": 1e-7}
    return jfx.laplace2d(12 if name == "stencil" else 10), {"tol": 1e-9, "basis_norm": name == "basis_norm"}


@pytest.mark.parametrize("system", ["stencil", "hyb", "basis_norm"])
@pytest.mark.parametrize("method, k", METHODS)
def test_batched_kskip_matches_jax_vmap_and_solo(method, k, system):
    A, extra = _system(system)
    B = np.random.default_rng(7).standard_normal((4, A.shape[0]))
    kw = dict(k=k, maxiter=600, **extra)
    ref = jax_solve_batched(A, B, method=method, **kw)
    At = from_jax_operator(A)
    res = krylov_tpu_torch.solve_batched(At, B, method=method, fused=False, **kw)
    assert res.x.shape == B.shape and res.iterations.shape == (4,) and bool(res.converged.all())
    _check_against_jax(res, ref, method)
    _check_against_solo(res, At, B, method, **kw)


def test_adaptive_batch_ends_at_different_k():
    """On the advection stencil (eps 0.3) the members roll back at other
    outer iterations, so they run at different k in one outer iteration and
    end at different final k."""
    A = advection(eps=0.3)
    B = np.random.default_rng(0).standard_normal((6, A.shape[0]))
    kw = dict(k=6, tol=1e-3, maxiter=2000)
    ref = jax_solve_batched(A, B, method="adaptivekskipmrr", **kw)
    At = from_jax_operator(A)
    res = krylov_tpu_torch.solve_batched(At, B, method="adaptivekskipmrr", fused=False, **kw)
    assert len(set(res.final_k.tolist())) > 1 and bool(res.converged.all())
    _check_against_jax(res, ref, "adaptivekskipmrr")
    _check_against_solo(res, At, B, "adaptivekskipmrr", **kw)


@pytest.mark.parametrize("kernel", [kskipcg_kernel, kskipmrr_kernel, adaptivekskipmrr_kernel])
@pytest.mark.parametrize("maxiter", [12, 400])
def test_batched_loops_freeze_each_member(kernel, maxiter):
    """The loops on a (batch, n) block equal the solo loops member by
    member, the diverged exit (maxiter 12) recorded per member."""
    A = from_jax_operator(jfx.poisson1d(50))
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 50)))
    B[0] = A.matvec(torch.full((50,), 1e-3))  # converges first
    res = kernel(A, B, torch.zeros_like(B), tol=1e-9, maxiter=maxiter, k=2)
    for j in range(3):
        solo = kernel(A, B[j], torch.zeros_like(B[j]), tol=1e-9, maxiter=maxiter, k=2)
        assert (int(res.iterations[j]), int(res.index[j]), bool(res.converged[j])) == (
            int(solo.iterations), int(solo.index), bool(solo.converged))
        m = int(solo.index) + 1
        torch.testing.assert_close(res.nosl_trace[j, :m], solo.nosl_trace[:m], rtol=0, atol=0)
        torch.testing.assert_close(res.residual_trace[j, :m], solo.residual_trace[:m], **TRACE_TOL)
        torch.testing.assert_close(res.x[j], solo.x, **X_TOL)


@pytest.mark.parametrize("method, k", METHODS)
def test_solve_batched_makes_one_loop_call(monkeypatch, method, k):
    """The whole batch goes through one call of the eager loop."""
    calls = []
    loop = api._KERNELS[method]

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return loop(*args, **kw)

    monkeypatch.setitem(api._KERNELS, method, counted)
    A = krylov_tpu_torch.sparse.fixtures.laplace2d(10)
    B = np.random.default_rng(8).standard_normal((5, 100))
    res = krylov_tpu_torch.solve_batched(A, B, method=method, k=k, tol=1e-8, maxiter=500, fused=False)
    assert calls == [(5, 100)] and bool(res.converged.all())
