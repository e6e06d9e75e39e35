"""Degenerate systems at the port's front door, on the CPU: an exact warm
start (``b = A x0``, so r0 = 0) and a zero right-hand side.

The port follows scipy's rule for ``||b|| = 0`` (``scipy.sparse.linalg.cg``
returns ``x = 0`` and info 0 at once): every entry point returns ``x = 0``
in ``b``'s dtype, 0 iterations, converged, a residual trace whose slot 0
is 0 with index 0, and runs no kernel or loop for it; a batch takes its
zero members out before the loop and puts their zero results back.  An
exact warm start returns ``x0`` converged after at most one iteration
(Chronopoulos–Gear after none).  These cases are held to that expectation
and not to the JAX package, which runs ``maxiter`` iterations into NaN on
both (ROADMAP queue 3, on the reference side).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu_torch import api
from krylov_tpu_torch.kernels import fused, fused_kskip
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.formats import StencilMatrix


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


METHODS = ("cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr", "cacg", "camrr", "pcg", "chronopoulos_gear",
           "gropp", "pipelined_cg")
K = {"kskipcg": 4, "kskipmrr": 4, "adaptivekskipmrr": 4, "cacg": 4, "camrr": 4}
TOL, MAXITER = 1e-5, 60


def _system(nx=20):
    A = fixtures.laplace2d(nx, constant=True)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(A.shape[0]))
    return A, x0


@pytest.fixture
def nothing_runs(monkeypatch):
    """Make any solve loop, fused kernel or Lanczos estimate raise: a zero
    b must reach none of them."""
    def refuse(*args, **kw):
        raise AssertionError("a loop or kernel ran for b = 0")

    monkeypatch.setattr(api, "_run_base", refuse)
    monkeypatch.setattr(api, "lanczos_bounds", refuse)
    for mod, names in ((fused, ("fused_cg_solve_2d", "fused_mrr_solve_2d")),
                       (fused_kskip, ("fused_kskipcg_solve_2d", "fused_kskipmrr_solve_2d"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


def _assert_zero_info(info, method):
    assert info["converged"] is True and info["iterations"] == 0
    np.testing.assert_array_equal(info["residual"], [0.0])
    np.testing.assert_array_equal(info["nosl"], [0])
    if method == "adaptivekskipmrr":
        assert info["final_k"] == K[method]


def _assert_zero_result(res, b):
    assert res.x.dtype == b.dtype and res.x.device == b.device and res.x.shape == b.shape
    assert bool((res.x == 0).all()) and not bool(torch.signbit(res.x).any())
    assert bool(res.converged.all()) and bool((res.iterations == 0).all()) and bool((res.index == 0).all())
    assert bool((res.residual_trace[..., 0] == 0).all())


@pytest.mark.parametrize("method", METHODS)
def test_exact_warm_start(method):
    """b = A x0: every method returns x0 bitwise, converged, after at most
    one iteration, with a zero and finite residual history; Chronopoulos–
    Gear after none (its first alpha was 0 / 0, and r0 was never tested)."""
    A, x0 = _system()
    x, info = krylov_tpu_torch.solve(A, A.matvec(x0), method=method, x0=x0, tol=TOL, maxiter=MAXITER,
                                     k=K.get(method, 0))
    assert info["converged"] and info["iterations"] <= 1
    assert torch.equal(x, x0)
    assert np.all(info["residual"] == 0)
    if method == "chronopoulos_gear":
        assert info["iterations"] == 0 and len(info["residual"]) == 1


ROUTES = [(m, False) for m in METHODS] + [(m, None) for m in api._FUSED_METHODS]


@pytest.mark.parametrize("method, fused_", ROUTES, ids=[f"{m}-{'eager' if f is False else 'fused'}" for m, f in ROUTES])
def test_zero_rhs_solve(method, fused_, nothing_runs):
    """b = 0 through solve, on the fused and the eager route: x = 0 whatever
    x0 is, 0 iterations, converged, trace slot 0 = 0, no NaN, no loop."""
    A, x0 = _system()
    b = torch.zeros(A.shape[0])
    x, info = krylov_tpu_torch.solve(A, b, method=method, x0=x0, tol=TOL, maxiter=MAXITER, k=K.get(method, 0),
                                     fused=fused_)
    assert x.dtype == torch.float64 and bool((x == 0).all())
    _assert_zero_info(info, method)


@pytest.mark.parametrize("method", ("cg", "mrr", "kskipmrr", "chronopoulos_gear"))
def test_zero_rhs_solve_device(method, nothing_runs):
    A, x0 = _system()
    b = torch.zeros(A.shape[0], dtype=torch.float64)
    res = krylov_tpu_torch.solve_device(A, b, method=method, x0=x0, tol=TOL, maxiter=MAXITER, k=K.get(method, 0))
    _assert_zero_result(res, b)
    res = krylov_tpu_torch.solve_device(A, b, method=method, tol=TOL, maxiter=MAXITER, k=K.get(method, 0),
                                        restarts=2)
    _assert_zero_result(res, b)
    assert float(res.true_residual) == 0.0


@pytest.mark.parametrize("wrapper", ("cg", "mrr", "kskipmrr", "chronopoulos_gear", "pipelined_cg"))
def test_zero_rhs_scipy_style(wrapper, nothing_runs):
    A, x0 = _system(6)
    x, info = getattr(api, wrapper)(A, np.zeros(A.shape[0]), x=x0.numpy(), tol=TOL, maxiter=MAXITER,
                                                 k=K.get(wrapper, 0))
    assert bool((x == 0).all())
    _assert_zero_info(info, wrapper)


@pytest.mark.parametrize("options", [dict(chunk_iters=5), dict(restarts=2), dict(refine=3)],
                         ids=["chunk_iters", "restarts", "refine"])
@pytest.mark.parametrize("method", ("cg", "kskipmrr"))
def test_zero_rhs_solve_options(method, options, nothing_runs):
    """chunk_iters= (no chunk runs), restarts= (true residual 0) and
    refine= (x float64, as refine= returns it; no refinement)."""
    A, x0 = _system()
    x, info = krylov_tpu_torch.solve(A, np.zeros(A.shape[0]), method=method, x0=x0.numpy(), tol=TOL,
                                     maxiter=MAXITER, k=K.get(method, 0), **options)
    assert bool((x == 0).all())
    _assert_zero_info(info, method)
    if "chunk_iters" in options:
        assert info["chunks"] == 0
    else:
        assert info["true_residual"] == 0.0
    if "refine" in options:
        assert x.dtype == torch.float64 and info["refinements"] == 0


def test_zero_rhs_float32_keeps_b_dtype(nothing_runs):
    A = fixtures.laplace2d(6, dtype=torch.float32, constant=True)
    x, info = krylov_tpu_torch.solve(A, torch.zeros(A.shape[0], dtype=torch.float32), method="mrr")
    assert x.dtype == torch.float32 and bool((x == 0).all())
    _assert_zero_info(info, "mrr")


class _Count:
    """Counts the calls of a function it wraps."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


BATCHED = [("cg", False), ("chronopoulos_gear", False), ("kskipmrr", False), ("adaptivekskipmrr", False),
           ("cacg", False), ("pipelined_cg", False), ("cg", True), ("mrr", True), ("kskipcg", True)]


@pytest.mark.parametrize("method, on_fused", BATCHED, ids=[f"{m}-{'fused' if f else 'eager'}" for m, f in BATCHED])
def test_batch_with_a_zero_member(method, on_fused, monkeypatch):
    """Three members, the middle one zero: the zero member's result is the
    front door's, the other two are bitwise their solo solves, and the batch
    does the work of the batch without its zero member (the same SpMVs on
    the eager loops, one fused launch a non-zero member)."""
    A, x0 = _system()
    rng = np.random.default_rng(7)
    B = torch.from_numpy(rng.standard_normal((3, A.shape[0])))
    B[1] = 0
    X0 = torch.from_numpy(rng.standard_normal((3, A.shape[0])))
    kw = dict(method=method, tol=TOL, maxiter=MAXITER, k=K.get(method, 0), fused=None if on_fused else False)
    bounds = {"spectral_bounds": (0.04, 7.96)} if method == "cacg" else {}
    if on_fused:
        mod = fused_kskip if method.startswith("kskip") else fused
        name = f"fused_{method}_solve_2d"
        counter = _Count(getattr(mod, name))
        monkeypatch.setattr(mod, name, counter)
    else:
        counter = _Count(StencilMatrix.matvec)
        monkeypatch.setattr(StencilMatrix, "matvec", lambda self, x: counter(self, x))
    res = krylov_tpu_torch.solve_batched(A, B, X0=X0, **kw, **bounds)
    calls = counter.calls
    keep = torch.tensor([0, 2])
    alone = krylov_tpu_torch.solve_batched(A, B[keep], X0=X0[keep], **kw, **bounds)
    assert counter.calls - calls == calls
    if on_fused:
        assert calls == 2
    zero = krylov_tpu_torch.solve_device(A, B[1], method=method, k=K.get(method, 0), fused=kw["fused"])
    _assert_zero_result(api.SolveResult(**{f: getattr(res, f)[1] for f in ("x", "residual_trace", "nosl_trace",
                                                                           "iterations", "index", "converged")}),
                        B[1])
    assert int(zero.iterations) == 0
    for j, row in ((0, 0), (2, 1)):
        solo = krylov_tpu_torch.solve_device(A, B[j], x0=X0[j], **kw, **bounds)
        assert torch.equal(res.x[j], solo.x) and torch.equal(res.x[j], alone.x[row])
        assert int(res.iterations[j]) == int(solo.iterations) > 0
        idx = int(solo.index)
        assert torch.equal(res.residual_trace[j, : idx + 1], solo.residual_trace[: idx + 1])
        assert torch.equal(res.nosl_trace[j, : idx + 1], solo.nosl_trace[: idx + 1])
    if method == "adaptivekskipmrr":
        assert int(res.final_k[1]) == K[method] and int(res.k_trace[1, 0]) == K[method]


@pytest.mark.parametrize("method, on_fused", [("cg", False), ("mrr", True)])
def test_batch_of_zero_members(method, on_fused, nothing_runs):
    A, _ = _system(6)
    B = torch.zeros(2, A.shape[0], dtype=torch.float64)
    res = krylov_tpu_torch.solve_batched(A, B, method=method, fused=None if on_fused else False)
    _assert_zero_result(res, B)


def test_chronopoulos_gear_batch_with_an_exact_warm_start():
    """F1 on the batched loop: the member started at its solution keeps x0
    bitwise after 0 iterations; the others are bitwise their solo solves."""
    A, _ = _system()
    rng = np.random.default_rng(9)
    B = torch.from_numpy(rng.standard_normal((3, A.shape[0])))
    X0 = torch.from_numpy(rng.standard_normal((3, A.shape[0])))
    B[1] = A.matvec(X0[1])
    res = krylov_tpu_torch.solve_batched(A, B, X0=X0, method="chronopoulos_gear", tol=TOL, maxiter=MAXITER)
    assert torch.equal(res.x[1], X0[1]) and int(res.iterations[1]) == 0 and bool(res.converged[1])
    for j in (0, 2):
        solo = krylov_tpu_torch.solve_device(A, B[j], x0=X0[j], method="chronopoulos_gear", tol=TOL,
                                             maxiter=MAXITER)
        assert torch.equal(res.x[j], solo.x) and int(res.iterations[j]) == int(solo.iterations) > 0


def test_mesh_of_one(tmp_path, monkeypatch):
    """mesh= in a gloo world of one (in this process, destroyed after): the
    zero b returns x = 0 from the all-reduced norm, a zero batch member
    runs no loop and the others are bitwise the batch without it, and an
    exact warm start of Chronopoulos–Gear keeps x0 after 0 iterations."""
    import torch.distributed as dist

    from krylov_tpu_torch.dist import make_mesh

    A, x0 = _system()
    n = A.shape[0]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = make_mesh("cpu")
        for method in ("cg", "chronopoulos_gear", "kskipmrr"):
            kw = dict(method=method, tol=TOL, maxiter=MAXITER, k=K.get(method, 0), mesh=mesh)
            x, info = krylov_tpu_torch.solve(A, np.zeros(n), x0=x0.numpy(), **kw)
            assert bool((x == 0).all()) and x.shape == (n,)
            _assert_zero_info(info, method)
            b0 = torch.zeros(n, dtype=torch.float64)
            _assert_zero_result(krylov_tpu_torch.solve_device(A, b0, **kw), b0)
            x, info = krylov_tpu_torch.solve(A, A.matvec(x0), x0=x0, **kw)
            assert torch.equal(x, x0) and info["converged"] and info["iterations"] <= 1
        B = torch.from_numpy(np.random.default_rng(3).standard_normal((3, n)))
        B[0] = 0
        kw = dict(method="cg", tol=TOL, maxiter=MAXITER, mesh=mesh)
        res = krylov_tpu_torch.solve_batched(A, B, **kw)
        alone = krylov_tpu_torch.solve_batched(A, B[1:], **kw)
        assert torch.equal(res.x[1:], alone.x) and torch.equal(res.iterations[1:], alone.iterations)
        assert bool((res.x[0] == 0).all()) and int(res.iterations[0]) == 0 and bool(res.converged[0])
        monkeypatch.setattr(api, "_run_base", None)  # nothing may run for an all-zero batch
        zero = krylov_tpu_torch.solve_batched(A, torch.zeros(2, n, dtype=torch.float64), **kw)
        _assert_zero_result(zero, torch.zeros(2, n, dtype=torch.float64))
    finally:
        dist.destroy_process_group()
