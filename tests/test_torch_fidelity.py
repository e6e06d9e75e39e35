"""Fidelity: ``restarts=`` (device-side defect correction) and ``refine=``
(host-float64 iterative refinement) of krylov_tpu_torch against krylov_tpu.

The JAX package runs on the CPU with x64.  Stencil systems take the port's
fused route (the kernels' plain versions on the CPU), a HYB system its eager
loops.  A ``maxiter`` below the convergence count makes every correction
fire.  float64: equal iteration counts, refinements and nosl, residual
histories rtol 1e-9 (atol 1e-13), x rtol 1e-8 and ``true_residual`` rtol
1e-9 (atol 1e-15: the resolution of ||b - A x|| / ||b|| formed in float64
on these systems, met where a solve ends near 1e-9); the k-skip family the
tolerances of tests/test_torch_kskip_solve.py (rtol 1e-5 on histories and
``true_residual``, x rtol 1e-6).  float32 cases
hold the port alone, as tests/test_restarts.py holds the JAX package: the
true residual must end below tol.
"""

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator, host_matvec64


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


TOLS = {"cg": (1e-9, 1e-13, 1e-8, 1e-12), "mrr": (1e-9, 1e-13, 1e-8, 1e-12)}
KSKIP_TOLS = (1e-5, 1e-11, 1e-6, 1e-9)
TRUE_ATOL = 1e-15

SYSTEMS = {  # (JAX operator, tol, maxiter below the convergence count)
    "stencil": (lambda: jfx.laplace2d(16, constant=True), 1e-10, 15),
    "hyb": (lambda: jconvert.to_hyb(jfx.powerlaw_spd(400, seed=11, max_deg=100)), 1e-12, 6),
}
CASES = [
    ("stencil", "cg", 0), ("stencil", "mrr", 0), ("stencil", "kskipmrr", 2), ("stencil", "adaptivekskipmrr", 4),
    ("hyb", "cg", 0), ("hyb", "mrr", 0),
]


def _true_rel(A, x, b):
    b64 = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b64 - host_matvec64(A, x)) / np.linalg.norm(b64))


def _system(name, seed):
    make, tol, maxiter = SYSTEMS[name]
    A = make()
    return A, np.random.default_rng(seed).standard_normal(A.shape[0]), tol, maxiter


@pytest.mark.parametrize("system, method, k", CASES)
def test_restarts_match_jax(system, method, k):
    A, b, tol, maxiter = _system(system, 0)
    kw = dict(method=method, k=k, tol=tol, maxiter=maxiter, restarts=3)
    ref = krylov_tpu.solve_device(A, b, **kw)
    res = krylov_tpu_torch.solve_device(from_jax_operator(A), b, **kw)
    t_rtol, t_atol, x_rtol, x_atol = TOLS.get(method, KSKIP_TOLS)
    # every correction fired: each pass ran to its maxiter
    assert int(res.iterations) == int(ref.iterations) > 3 * maxiter
    assert bool(res.converged) == bool(ref.converged) == (float(ref.true_residual) < tol)
    np.testing.assert_allclose(float(res.true_residual), float(ref.true_residual), rtol=t_rtol, atol=TRUE_ATOL)
    assert res.true_residual.ndim == 0 and res.true_residual.dtype == torch.float64
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=x_rtol, atol=x_atol)
    m = int(ref.index) + 1  # the base solve's history
    np.testing.assert_allclose(res.residual_trace[:m].numpy(), np.asarray(ref.residual_trace)[:m],
                               rtol=t_rtol, atol=t_atol)


@pytest.mark.parametrize("system, method, k", [("stencil", "mrr", 0), ("hyb", "cg", 0)])
def test_solve_restarts_info_matches_jax(system, method, k):
    A, b, tol, maxiter = _system(system, 1)
    kw = dict(method=method, k=k, tol=tol, maxiter=maxiter, restarts=2)
    xr, ir = krylov_tpu.solve(A, b, **kw)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, **kw)
    assert (info["iterations"], info["converged"]) == (ir["iterations"], ir["converged"])
    np.testing.assert_allclose(info["true_residual"], ir["true_residual"], rtol=1e-9, atol=TRUE_ATOL)
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(x.numpy(), xr, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("fused", [None, False])
def test_restarts_skip_when_already_converged(fused):
    """As tests/test_restarts.py: the float64 base solve already meets tol,
    so the correction is skipped and the count stays that of restarts=0."""
    A = jfx.poisson1d(600)
    b = np.random.default_rng(1234).standard_normal(600)
    kw = dict(method="cg", tol=1e-9, maxiter=3000)
    At = from_jax_operator(A)
    r0 = krylov_tpu_torch.solve_device(At, b, fused=fused, **kw)
    r1 = krylov_tpu_torch.solve_device(At, b, fused=fused, restarts=1, **kw)
    ref = krylov_tpu.solve_device(A, b, restarts=1, **kw)
    assert int(r1.iterations) == int(r0.iterations) == int(ref.iterations)
    assert bool(r1.converged) and float(r1.true_residual) < 1e-9
    # CG ends here by finite termination: the true residual (about 2.6e-12)
    # sits at the float64 rounding floor of this system, whose digits are
    # rounding (atol 1e-11)
    np.testing.assert_allclose(float(r1.true_residual), float(ref.true_residual), rtol=1e-9, atol=1e-11)
    torch.testing.assert_close(r1.x, r0.x, rtol=0, atol=0)


def test_restarts_pass_inner_tol_as_device_tensor(monkeypatch):
    """The correction solves get their tolerance as a 0-d tensor of b's
    dtype on b's device: the fused kernels read it with no host transfer."""
    from krylov_tpu_torch.kernels import fused

    tols = []
    real = fused.fused_mrr_solve_2d
    monkeypatch.setattr(fused, "fused_mrr_solve_2d", lambda c, b, tol, *a, **k: tols.append(tol) or real(c, b, tol, *a, **k))
    A = fixtures.laplace2d(12, constant=True)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    krylov_tpu_torch.solve_device(A, b, method="mrr", tol=1e-10, maxiter=10, restarts=2)
    assert len(tols) == 3 and tols[0] == 1e-10
    for t in tols[1:]:
        assert isinstance(t, torch.Tensor) and t.ndim == 0 and t.dtype == torch.float64
        assert 2e-7 <= float(t) <= 0.5


@pytest.mark.parametrize("system, method, k", CASES)
def test_refine_matches_jax(system, method, k):
    A, b, tol, maxiter = _system(system, 3)
    kw = dict(method=method, k=k, tol=tol, maxiter=maxiter, refine=3)
    xr, ir = krylov_tpu.solve(A, b, **kw)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, **kw)
    t_rtol, t_atol, x_rtol, x_atol = TOLS.get(method, KSKIP_TOLS)
    assert info["refinements"] == ir["refinements"] == 3
    assert (info["iterations"], info["converged"]) == (ir["iterations"], ir["converged"])
    assert set(info) - {"compile_time"} == set(ir) - {"compile_time"}
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=t_rtol, atol=t_atol)
    np.testing.assert_allclose(info["true_residual"], ir["true_residual"], rtol=t_rtol, atol=TRUE_ATOL)
    if "khistory" in ir:
        np.testing.assert_array_equal(info["khistory"], ir["khistory"])
        assert info["final_k"] == ir["final_k"]
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64 and x.device.type == "cpu"
    assert xr.dtype == np.float64
    np.testing.assert_allclose(x.numpy(), xr, rtol=x_rtol, atol=x_atol)


def test_refine_stops_once_below_tol():
    A = jfx.laplace2d(16, constant=True)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    xr, ir = krylov_tpu.solve(A, b, method="cg", tol=1e-8, refine=5)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method="cg", tol=1e-8, refine=5)
    assert info["refinements"] == ir["refinements"] < 5
    assert info["converged"] and info["true_residual"] < 1e-8
    np.testing.assert_allclose(info["true_residual"], ir["true_residual"], rtol=1e-9, atol=TRUE_ATOL)


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_restarts_drive_f32_true_residual_below_tol(method):
    """As tests/test_restarts.py: float32 vectors, restarts=2 closes the gap
    between the recurred and the true residual."""
    A = fixtures.laplace2d(48, dtype=torch.float32)
    b = np.random.default_rng(1234).standard_normal(A.shape[0]).astype(np.float32)
    res = krylov_tpu_torch.solve_device(A, b, method=method, tol=1e-5, maxiter=4000, restarts=2)
    assert bool(res.converged) and float(res.true_residual) < 1e-5
    assert res.x.dtype == torch.float32
    assert _true_rel(A, res.x, b) < 1e-5 * 1.5  # host float64 cross-check


@pytest.mark.parametrize("system", ["stencil", "hyb"])
def test_refine_f32_ends_below_tol(system):
    A = fixtures.laplace2d(48, dtype=torch.float32) if system == "stencil" else from_jax_operator(
        jconvert.to_hyb(jfx.powerlaw_spd(2000, seed=3, diag_scale_decades=1.0)), dtype=torch.float32)
    b = np.random.default_rng(5).standard_normal(A.shape[0]).astype(np.float32)
    x, info = krylov_tpu_torch.solve(A, b, method="mrr", tol=1e-7, maxiter=4000, refine=3)
    assert x.dtype == torch.float64
    assert info["converged"] and info["true_residual"] < 1e-7 and info["refinements"] >= 1
    assert _true_rel(A, x, b) == pytest.approx(info["true_residual"], rel=1e-12)


def test_solve_restarts_info_f32():
    """As tests/test_restarts.py: info holds true_residual, and converged
    reads it."""
    A = fixtures.laplace2d(32, dtype=torch.float32)
    b = np.random.default_rng(1234).standard_normal(A.shape[0]).astype(np.float32)
    x, info = krylov_tpu_torch.solve(A, b, method="mrr", tol=1e-5, restarts=1)
    assert "true_residual" in info
    assert info["converged"] == (info["true_residual"] < 1e-5)


def test_restarts_with_mesh_in_a_world_of_one(tmp_path):
    """restarts= under mesh= corrects on the rank's rows: in a gloo world of
    one (in this process, destroyed after) solve and solve_device give the
    single-device restarts=1's count and x, and a true residual below tol;
    the first solve stops at maxiter short of tol, so the defect solve
    runs.  chunk_iters= with it still raises."""
    import torch.distributed as dist

    from krylov_tpu_torch.dist import make_mesh

    A = fixtures.laplace2d(12)
    b = np.random.default_rng(3).standard_normal(144)
    kw = dict(method="mrr", tol=1e-9, maxiter=30, restarts=1)
    want = krylov_tpu_torch.solve_device(A, b, fused=False, **kw)
    first = krylov_tpu_torch.solve_device(A, b, fused=False, **dict(kw, restarts=0))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = make_mesh("cpu")
        got = krylov_tpu_torch.solve_device(A, b, mesh=mesh, **kw)
        x, info = krylov_tpu_torch.solve(A, b, mesh=mesh, **kw)
        with pytest.raises(ValueError, match="chunk_iters= is single-device only"):
            krylov_tpu_torch.solve(A, b, mesh=mesh, chunk_iters=5, **kw)
    finally:
        dist.destroy_process_group()
    assert int(first.iterations) < int(want.iterations) == int(got.iterations) == info["iterations"]
    assert bool(got.converged) and info["converged"] and float(got.true_residual) < 1e-9
    assert info["true_residual"] < 1e-9
    torch.testing.assert_close(got.x, want.x, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(x, want.x, rtol=1e-12, atol=1e-15)
