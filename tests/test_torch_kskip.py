"""K5/K6 (the fused k-skip kernels of krylov_tpu_torch): plain versions
against the JAX Pallas kernels in interpret mode on the CPU, as
tests/test_kernels.py runs them.  The CUDA kernels are held against these
plain versions in test_torch_cuda.py.

Tolerances (float64), those of tests/test_kernels.py for the same kernels:
the iteration count, the outer count, the convergence flag, ``nosl``,
``ktrace`` and ``final_k`` are equal.  Both sides stream the bundle but sum
each inner product in another order, and the k-step scalar recurrences
amplify that rounding (their cancellation grows like kappa^k), so residual
traces agree to rtol 1e-5 and solutions to rtol 1e-6, atol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu.kernels import fused_kskipcg_solve_2d as jax_kskipcg
from krylov_tpu.kernels import fused_kskipmrr_solve_2d as jax_kskipmrr
from krylov_tpu.sparse.fixtures import laplace2d, laplace3d
from krylov_tpu.sparse.formats import StencilMatrix
from krylov_tpu_torch.kernels import fused, fused_kskip
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator

TRACE_RTOL = 1e-5
X_TOL = dict(rtol=1e-6, atol=1e-9)


def advection(g=(16, 16), eps=0.5):
    """Non-normal advection-like stencil (tests/test_kernels.py:198-212):
    MrR overshoots there and the adaptive guard rolls back."""
    iy = np.arange(g[0])[:, None]
    ix = np.arange(g[1])[None, :]
    coef = np.stack([
        -(1 + eps) * np.broadcast_to(iy > 0, g).astype(float),
        -(1 + eps) * np.broadcast_to(ix > 0, g).astype(float),
        np.full(g, 4.5),
        -(1 - eps) * np.broadcast_to(ix < g[1] - 1, g).astype(float),
        -(1 - eps) * np.broadcast_to(iy < g[0] - 1, g).astype(float),
    ])
    return StencilMatrix(jnp.asarray(coef), ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), g)


def _both(A, method, k, tol, maxiter, adaptive=False, seed=0):
    """The JAX kernel (interpret mode) and the port's plain version on the
    same operator and b; returns both output tuples as numpy."""
    b = np.random.default_rng(seed).standard_normal(A.shape[0])
    b_norm = np.linalg.norm(b)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    kw = dict(stencil=stencil2, grid=grid2, maxiter=maxiter, k_max=max(k, 1), sub=sub)
    At = from_jax_operator(A)
    c2, s2, g2, sub_t = At.collapse_to_2d()
    kwt = dict(stencil=s2, grid=g2, maxiter=maxiter, k_max=max(k, 1), sub=sub_t)
    if method == "kskipcg":
        ref = jax_kskipcg(jnp.asarray(coef2), jnp.asarray(b), tol, b_norm, k, interpret=True, **kw)
        out = fused_kskip.fused_kskipcg_solve_2d(c2, torch.from_numpy(b), tol, b_norm, k, **kwt)
    else:
        ref = jax_kskipmrr(jnp.asarray(coef2), jnp.asarray(b), tol, b_norm, k, adaptive=adaptive,
                           interpret=True, **kw)
        out = fused_kskip.fused_kskipmrr_solve_2d(c2, torch.from_numpy(b), tol, b_norm, k,
                                                  adaptive=adaptive, **kwt)
    return [np.asarray(v) for v in ref], [v.numpy() for v in out]


def _check(ref, out, method, adaptive=False):
    """Integer outputs equal; trace and x within the stated tolerances.
    Returns the K5 output (x, trace, nosl, ktrace, iters, conv, index, final_k)
    shape for both methods (K6 gets ktrace/final_k None).  The static Pallas
    kernel leaves ktrace past slot 1 unwritten, so only the adaptive one's
    is compared whole."""
    if method == "kskipcg":
        ref = ref[:3] + [None] + ref[3:] + [None]
        out = out[:3] + [None] + out[3:] + [None]
    (xr, tr, nr, kr, ir, cr, idr, fr), (x, t, n, kt, i, c, idx, f) = ref, out
    assert (int(i), bool(c), int(idx)) == (int(ir), bool(cr), int(idr))
    m = int(idr) + 1
    np.testing.assert_array_equal(n[:m], nr[:m])
    if method != "kskipcg":
        np.testing.assert_array_equal(kt[: m if adaptive else 2], kr[: m if adaptive else 2])
        assert int(f) == int(fr)
    np.testing.assert_allclose(t[:m], tr[:m], rtol=TRACE_RTOL)
    np.testing.assert_allclose(x, xr, **X_TOL)
    return x, t, n, kt, i, c, idx, f


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_kskipcg_plain_matches_pallas(k):
    ref, out = _both(laplace2d(24), "kskipcg", k, 1e-8, 500)
    assert bool(_check(ref, out, "kskipcg")[5])


@pytest.mark.parametrize("k, adaptive", [(1, False), (2, False), (4, False), (2, True), (4, True)])
def test_kskipmrr_plain_matches_pallas(k, adaptive):
    ref, out = _both(laplace2d(24), "kskipmrr", k, 1e-8, 500, adaptive)
    x, t, n, kt, i, c, idx, f = _check(ref, out, "kskipmrr", adaptive)
    assert bool(c)
    if not adaptive:  # the static kernel writes k into the first two slots only
        assert list(kt[:2]) == [k, k] and not kt[2:].any()


@pytest.mark.parametrize("constant", [False, True])
@pytest.mark.parametrize("method, adaptive", [("kskipcg", False), ("kskipmrr", True)])
def test_kskip_plain_matches_pallas_3d(method, adaptive, constant):
    """3-D on the collapsed view; the constant form masks inner-axis lanes."""
    ref, out = _both(laplace3d(8, constant=constant), method, 2, 1e-8, 500, adaptive, seed=4)
    assert bool(_check(ref, out, method, adaptive)[5])


def test_adaptive_rollback_plain_matches_pallas():
    """The rollback branch: k drops below its start, with equal khistory,
    nosl, final_k and iteration count."""
    ref, out = _both(advection(), "kskipmrr", 6, 1e-8, 2000, adaptive=True, seed=3)
    x, t, n, kt, i, c, idx, f = _check(ref, out, "kskipmrr", adaptive=True)
    assert int(f) < 6 and bool(c)


@pytest.mark.parametrize("method, adaptive", [("kskipcg", False), ("kskipmrr", False), ("kskipmrr", True)])
def test_kskip_plain_maxiter_divergence_matches_pallas(method, adaptive):
    """tol 1e-14 is out of reach: the solve stops at maxiter (i may pass it
    by up to k) and writes the final residual at the last outer index."""
    ref, out = _both(laplace2d(16), method, 2, 1e-14, 9, adaptive, seed=1)
    x, t, n, kt, i, c, idx, f = _check(ref, out, method, adaptive)
    assert not bool(c) and int(i) >= 9
    assert np.all(t[: int(idx) + 1] > 0)


@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr", "adaptivekskipmrr"])
def test_kskip_trace_cap_clamps_recording(monkeypatch, method):
    """Past TRACE_CAP the fused k-skip solve keeps iterating; residuals land
    in the last slot and solve() reports residual_truncated."""
    A = fixtures.laplace2d(12, constant=True)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    _, full = krylov_tpu_torch.solve(A, b, method=method, k=1, tol=1e-10)
    monkeypatch.setattr(fused, "TRACE_CAP", 10)
    x, info = krylov_tpu_torch.solve(A, b, method=method, k=1, tol=1e-10)
    assert info["iterations"] == full["iterations"]
    assert len(full["residual"]) > 12 and "residual_truncated" not in full
    assert info["residual_truncated"] and len(info["residual"]) == 12
    np.testing.assert_array_equal(info["residual"][:11], full["residual"][:11])
    assert info["residual"][11] == full["residual"][-1]


def test_kskip_k_out_of_range_raises():
    A = fixtures.laplace2d(4)
    b = torch.ones(16)
    with pytest.raises(ValueError, match="k_max"):
        fused_kskip.fused_kskipcg_solve_2d(A.coef, b, 1e-8, 4.0, 3, stencil=A.stencil, grid=A.grid,
                                           maxiter=10, k_max=2)
    with pytest.raises(ValueError, match="k_max"):
        fused_kskip.fused_kskipmrr_solve_2d(A.coef, b, 1e-8, 4.0, -1, stencil=A.stencil, grid=A.grid,
                                            maxiter=10, k_max=2)
