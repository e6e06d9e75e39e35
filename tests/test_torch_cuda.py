"""krylov_tpu_torch CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine that has none:
``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the
``--noconftest`` skips tests/conftest.py, which sets JAX up).

Tolerances: the SpMV differs from the plain version only by fused
multiply-adds, rtol 1e-12 (f64) / 1e-5 (f32) against the largest entry.
The fused solves sum inner products in another order (per-block partials):
equal iteration counts, traces rtol 1e-9 (atol 1e-14), x rtol 1e-8
(atol 1e-12), in float64.
"""

import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu_torch.kernels import fused, stencil
from krylov_tpu_torch.sparse import fixtures

OPERATORS = {
    "2d": lambda **kw: fixtures.laplace2d(24, **kw),
    "2d-const": lambda **kw: fixtures.laplace2d(24, constant=True, **kw),
    "3d-const": lambda **kw: fixtures.laplace3d(10, constant=True, **kw),
}
KERNEL = {"cg": fused.fused_cg_solve_2d, "mrr": fused.fused_mrr_solve_2d}
PLAIN = {"cg": fused.fused_cg_solve_2d_reference, "mrr": fused.fused_mrr_solve_2d_reference}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its plain version")
    return torch.device("cuda")


def _rhs(n, seed, device, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_stencil_kernel_matches_plain(cuda, name, dtype, rtol):
    A = OPERATORS[name](dtype=dtype, device=cuda)
    x = _rhs(A.shape[0], 5, cuda, dtype)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    before = stencil.stencil_matvec_2d.launches
    y = stencil.stencil_matvec_2d(coef2, x, stencil=stencil2, grid=grid2, sub=sub)
    assert stencil.stencil_matvec_2d.launches == before + 1
    y_ref = stencil.stencil_matvec_2d_reference(coef2, x, stencil=stencil2, grid=grid2, sub=sub)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=rtol * float(y_ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPERATORS))
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_kernel_matches_plain(cuda, method, name):
    A = OPERATORS[name](device=cuda)
    b = _rhs(A.shape[0], 6, cuda)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    kw = dict(stencil=stencil2, grid=grid2, maxiter=A.shape[0], sub=sub)
    b_norm = torch.linalg.vector_norm(b)
    before = KERNEL[method].launches
    x, t, i, c = KERNEL[method](coef2, b, 1e-8, b_norm, **kw)
    assert KERNEL[method].launches == before + 1
    xr, tr, ir, cr = PLAIN[method](coef2, b, 1e-8, b_norm, **kw)
    assert int(i) == int(ir) and bool(c) and bool(cr)
    m = int(i) + 1
    torch.testing.assert_close(t[:m], tr[:m], rtol=1e-9, atol=1e-14)
    torch.testing.assert_close(x, xr, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("method, vectors", [("cg", 3), ("mrr", 4)])
def test_fused_workspace_sizes(cuda, method, vectors):
    """The C library sizes the scratch buffers: n-vectors of work by method,
    8 partial-sum slots a block, and no more blocks than n points need."""
    n = 64 * 64
    blocks, work, partials = fused.workspace(method, torch.float64, n)
    assert 1 <= blocks <= n // 256 and work == vectors * n and partials == 8 * blocks
    assert fused.workspace(method, torch.float64, n) == (blocks, work, partials)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_kernel_maxiter_divergence(cuda, method):
    A = fixtures.laplace2d(16, device=cuda)
    b = _rhs(A.shape[0], 1, cuda)
    kw = dict(stencil=A.stencil, grid=A.grid, maxiter=5)
    x, t, i, c = KERNEL[method](A.coef, b, 1e-14, torch.linalg.vector_norm(b), **kw)
    xr, tr, ir, cr = PLAIN[method](A.coef, b, 1e-14, torch.linalg.vector_norm(b), **kw)
    assert not bool(c) and int(i) == int(ir) == 5
    torch.testing.assert_close(t, tr, rtol=1e-9, atol=1e-14)
    torch.testing.assert_close(x, xr, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_solve_on_cuda_matches_cpu(cuda, method):
    """The same system through solve() on the card (kernels) and on the CPU
    (plain versions), with a warm start."""
    b = np.random.default_rng(7).standard_normal(32 * 32)
    x0 = 0.1 * np.random.default_rng(8).standard_normal(32 * 32)
    x_c, info_c = krylov_tpu_torch.solve(fixtures.laplace2d(32, constant=True), b, method=method, x0=x0, tol=1e-8)
    x_g, info_g = krylov_tpu_torch.solve(
        fixtures.laplace2d(32, constant=True, device=cuda), b, method=method, x0=x0, tol=1e-8
    )
    assert x_g.device.type == "cuda"
    assert info_g["iterations"] == info_c["iterations"] and info_g["converged"]
    np.testing.assert_allclose(info_g["residual"], info_c["residual"], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
def test_kernel_runs_on_torch_current_stream(cuda):
    """The kernel is ordered after work queued on a side stream: it takes
    torch's current stream, not the default one."""
    A = fixtures.laplace2d(64, constant=True, device=cuda)
    x = _rhs(A.shape[0], 9, cuda)
    y_ref = stencil.stencil_matvec_2d(A.coef, x, stencil=A.stencil, grid=A.grid)
    side = torch.cuda.Stream()
    xs = torch.zeros_like(x)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)  # keep the side stream busy
        xs.copy_(x)
        ys = stencil.stencil_matvec_2d(A.coef, xs, stencil=A.stencil, grid=A.grid)
    torch.cuda.synchronize()
    torch.testing.assert_close(ys, y_ref, rtol=0, atol=0)
