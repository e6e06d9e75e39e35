"""krylov_tpu_torch kernels: plain versions against the JAX Pallas kernels
(interpret mode on the CPU, as tests/test_kernels.py runs them).  The CUDA
kernels are held against these plain versions in test_torch_cuda.py.

Tolerances (float64): the SpMV adds the same products in the same order,
rtol 1e-12.  The fused solves sum their inner products in another order
than XLA, so residual traces agree to rtol 1e-9 (atol 1e-14 for residuals
at rounding level) and solutions to rtol 1e-8, atol 1e-12; iteration counts
and the convergence flag are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu.kernels import fused_cg_solve_2d as jax_fused_cg
from krylov_tpu.kernels import fused_mrr_solve_2d as jax_fused_mrr
from krylov_tpu.kernels import stencil_matvec_2d as jax_stencil_matvec_2d
from krylov_tpu.sparse.fixtures import laplace2d, laplace3d
from krylov_tpu_torch.kernels import fused, stencil
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator

JAX_FUSED = {"cg": jax_fused_cg, "mrr": jax_fused_mrr}
PORT_FUSED = {"cg": fused.fused_cg_solve_2d, "mrr": fused.fused_mrr_solve_2d}


@pytest.mark.parametrize("dims", [(20, 24), (17, 13), (40, 40)])
def test_stencil_matvec_plain_matches_pallas(dims):
    A = laplace2d(*dims)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    y_ref = np.asarray(
        jax_stencil_matvec_2d(A.coef, jnp.asarray(x), stencil=A.stencil, grid=A.grid, interpret=True)
    )
    At = from_jax_operator(A)
    y = stencil.stencil_matvec_2d(At.coef, torch.from_numpy(x), stencil=At.stencil, grid=At.grid)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-12)


@pytest.mark.parametrize("constant", [False, True])
@pytest.mark.parametrize("dims", [(6, 7, 9), (8, 8, 8)])
def test_stencil_matvec_plain_matches_pallas_3d(dims, constant):
    """3-D on the collapsed view; the constant form masks inner-axis lanes."""
    A = laplace3d(*dims, constant=constant)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    y_ref = np.asarray(
        jax_stencil_matvec_2d(coef2, jnp.asarray(x), stencil=stencil2, grid=grid2, sub=sub, interpret=True)
    )
    y = stencil.stencil_matvec(from_jax_operator(A), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-12)


OPERATORS = {
    "2d": lambda: laplace2d(24),
    "2d-const": lambda: laplace2d(24, constant=True),
    "3d": lambda: laplace3d(10),
    "3d-const": lambda: laplace3d(10, constant=True),
}


def _both(A, b, tol, maxiter, method):
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    b_norm = np.linalg.norm(b)
    ref = JAX_FUSED[method](
        jnp.asarray(coef2), jnp.asarray(b), tol, b_norm,
        stencil=stencil2, grid=grid2, maxiter=maxiter, sub=sub, interpret=True,
    )
    At = from_jax_operator(A)
    c2, s2, g2, sub_t = At.collapse_to_2d()
    out = PORT_FUSED[method](
        c2, torch.from_numpy(b), tol, b_norm, stencil=s2, grid=g2, maxiter=maxiter, sub=sub_t
    )
    return ref, out


@pytest.mark.parametrize("name", sorted(OPERATORS))
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_plain_matches_pallas(method, name):
    A = OPERATORS[name]()
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    (xr, tr, ir, cr), (x, t, i, c) = _both(A, b, 1e-8, A.shape[0], method)
    assert int(i) == int(ir) and bool(c) == bool(cr) and bool(c)
    m = int(ir) + 1
    np.testing.assert_allclose(t.numpy()[:m], np.asarray(tr)[:m], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_plain_maxiter_divergence_matches_pallas(method):
    """maxiter=5 at an unreachable tol: not converged, the final residual
    written after the loop."""
    A = laplace2d(16)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    (xr, tr, ir, cr), (x, t, i, c) = _both(A, b, 1e-14, 5, method)
    assert not bool(c) and not bool(cr)
    assert int(i) == int(ir) == 5
    assert np.all(t.numpy()[:6] > 0)
    np.testing.assert_allclose(t.numpy(), np.asarray(tr), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_trace_cap_clamps_recording(monkeypatch, method):
    """Past TRACE_CAP the solve keeps iterating; residuals land in the last
    slot and solve() reports residual_truncated."""
    A = fixtures.laplace2d(12, constant=True)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    _, full = krylov_tpu_torch.solve(A, b, method=method, tol=1e-8)
    monkeypatch.setattr(fused, "TRACE_CAP", 10)
    x, info = krylov_tpu_torch.solve(A, b, method=method, tol=1e-8)
    assert info["iterations"] == full["iterations"] > 10
    assert info["residual_truncated"] and len(info["residual"]) == 11
    np.testing.assert_array_equal(info["residual"][:10], full["residual"][:10])
    assert info["residual"][10] == full["residual"][-1]
    assert "residual_truncated" not in full


def test_cuda_wrappers_refuse_other_devices():
    A = fixtures.laplace2d(4)
    with pytest.raises(ValueError, match="CUDA device"):
        stencil.require_cuda("k", A.coef, torch.zeros(16), A.stencil, A.grid)
    with pytest.raises(ValueError, match="at most"):
        stencil.geometry(((0, 0),) * 17, (4, 4), None, True)
