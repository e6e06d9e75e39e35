"""Chunked solves, ``solve(chunk_iters=)``: krylov_tpu_torch against
krylov_tpu and against the port's own unbroken eager solves.

The JAX package runs on the CPU with x64.  For the seven carry methods
(cg, mrr, the k-skip family, cacg, camrr) each chunk resumes from the
state the one before left, so a chunked solve takes exactly the
iterations of the unbroken eager solve.  float64, against the JAX
package's chunked solve: equal iterations, chunks, nosl, khistory and
final k; residual histories rtol 1e-9 (atol 1e-13) and x rtol 1e-8 for
cg/mrr; the k-skip family at the tolerances of
tests/test_torch_kskip_solve.py (rtol 1e-5, atol 1e-11; x rtol 1e-6,
atol 1e-9); cacg/camrr at those of tests/test_torch_cacg.py (rtol 1e-8,
atol 1e-13; x rtol 1e-8, atol 1e-12).  Against the port's unbroken eager
solve: equal counts, nosl and khistory, histories rtol 1e-12 (the entry at
a chunk boundary is the chunk's final ``||r||``, the unbroken solve's the
recurred one), x rtol 1e-12.  The pipelined family and ``fused=True``
chunks warm-restart from the iterate; the JAX package runs no fused kernel
on the CPU, so ``fused=True`` chunks are held against the same warm
restarts through the JAX package's ``solve(x0=)``.
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
from krylov_tpu_torch.sparse.convert import from_jax_operator
from test_torch_kskip import advection


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


CARRY = [("cg", 0), ("mrr", 0), ("kskipcg", 3), ("kskipmrr", 3), ("adaptivekskipmrr", 4), ("cacg", 4),
         ("camrr", 4)]
# (residual rtol, residual atol, x rtol, x atol) against the JAX package
TOLS = {"cg": (1e-9, 1e-13, 1e-8, 1e-12), "mrr": (1e-9, 1e-13, 1e-8, 1e-12),
        "cacg": (1e-8, 1e-13, 1e-8, 1e-12), "camrr": (1e-8, 1e-13, 1e-8, 1e-12)}
KSKIP_TOLS = (1e-5, 1e-11, 1e-6, 1e-9)


def _system(name):
    """``(A, b, tol, chunk_iters)``: the HYB system converges in 21-24
    iterations, so its chunks are shorter."""
    if name == "laplace2d":
        A = jfx.laplace2d(48)
        return A, np.random.default_rng(0).standard_normal(A.shape[0]), 1e-8, 40
    A = jconvert.to_hyb(jfx.powerlaw_spd(400, seed=11, max_deg=100, shift=1e-3))
    return A, np.random.default_rng(1).standard_normal(A.shape[0]), 1e-8, 10


def _same_counts(info, ref, chunks=True):
    assert info["iterations"] == ref["iterations"] and info["converged"] == ref["converged"]
    if chunks:
        assert info["chunks"] == ref["chunks"]
    np.testing.assert_array_equal(info["nosl"], ref["nosl"])
    assert ("khistory" in info) == ("khistory" in ref)
    if "khistory" in ref:
        np.testing.assert_array_equal(info["khistory"], ref["khistory"])
        assert info["final_k"] == ref["final_k"]


@pytest.mark.parametrize("system", ["laplace2d", "hyb"])
@pytest.mark.parametrize("method, k", CARRY)
def test_chunked_matches_jax_and_unbroken(method, k, system):
    A, b, tol, chunk_iters = _system(system)
    At = from_jax_operator(A)
    kw = dict(method=method, k=k, tol=tol, maxiter=3000)
    xr, ref = krylov_tpu.solve(A, b, chunk_iters=chunk_iters, **kw)
    x, info = krylov_tpu_torch.solve(At, b, chunk_iters=chunk_iters, **kw)
    assert info["converged"] and info["chunks"] >= 2
    _same_counts(info, ref)
    t_rtol, t_atol, x_rtol, x_atol = TOLS.get(method, KSKIP_TOLS)
    np.testing.assert_allclose(info["residual"], ref["residual"], rtol=t_rtol, atol=t_atol)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=x_rtol, atol=x_atol)

    xu, unbroken = krylov_tpu_torch.solve(At, b, fused=False, **kw)
    _same_counts(info, unbroken, chunks=False)
    np.testing.assert_allclose(info["residual"], unbroken["residual"], rtol=1e-12, atol=0)
    torch.testing.assert_close(x, xu, rtol=1e-12, atol=0)


def test_adaptive_rollback_across_a_chunk_boundary():
    """On the advection stencil adaptive k-skip MrR rolls back every few
    outer iterations; with chunks of 40 one chunk's first guard reads a
    residual that rose against the snapshot of the chunk before and rolls
    back, which only the carried (pre_x, pre_res, k) can reproduce."""
    A = advection()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(method="adaptivekskipmrr", k=6, tol=1e-10, maxiter=2000)
    xr, ref = krylov_tpu.solve(A, b, chunk_iters=40, **kw)
    At = from_jax_operator(A)
    x, info = krylov_tpu_torch.solve(At, b, chunk_iters=40, **kw)
    xu, unbroken = krylov_tpu_torch.solve(At, b, fused=False, **kw)
    _same_counts(info, ref)
    _same_counts(info, unbroken, chunks=False)
    np.testing.assert_allclose(info["residual"], ref["residual"], rtol=1e-5, atol=1e-11)
    np.testing.assert_allclose(info["residual"], unbroken["residual"], rtol=1e-12, atol=0)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-6, atol=1e-9)
    # the chunk starts, from the merged nosl: a chunk runs outer iterations
    # while its own count is below 40; a rollback is an advance of 1
    nosl, starts, s = info["nosl"], [], 0
    while s < len(nosl) - 1:
        starts.append(s)
        e = s
        while e < len(nosl) - 1 and nosl[e] - nosl[s] < 40:
            e += 1
        s = e
    assert len(starts) == info["chunks"] >= 3
    rolled_back_first = [s for s in starts[1:] if nosl[s + 1] - nosl[s] == 1]
    assert rolled_back_first, f"no chunk rolled back at its first guard (starts {starts})"
    assert info["final_k"] < 6


def _jax_warm_chunks(A, b, chunk_iters, maxiter, **kw):
    """Warm restarts through the JAX package's ``solve(x0=)``, with the stop
    rule of its chunked solve: (iterations, chunks, converged, x)."""
    x, done, chunks = None, 0, 0
    while True:
        x, seg = krylov_tpu.solve(A, b, x0=x, maxiter=chunk_iters, **kw)
        done, chunks = done + seg["iterations"], chunks + 1
        if seg["converged"] or done >= maxiter or seg["iterations"] == 0 or not np.isfinite(seg["residual"][-1]):
            return done, chunks, seg["converged"], np.asarray(x)


@pytest.mark.parametrize("method, k", [("cg", 0), ("mrr", 0), ("kskipcg", 2), ("kskipmrr", 2),
                                       ("adaptivekskipmrr", 4)])
def test_fused_chunks_warm_restart(method, k):
    """fused=True chunks: one fused solve each (the kernels' plain versions
    here), shifted to x0 = x; counts as the JAX package's warm restarts."""
    A = jfx.laplace2d(24)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    kw = dict(method=method, k=k, tol=1e-8)
    iters, chunks, conv, xr = _jax_warm_chunks(A, b, 15, 2000, **kw)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, maxiter=2000, chunk_iters=15, fused=True, **kw)
    assert (info["iterations"], info["chunks"], info["converged"]) == (iters, chunks, conv) and conv
    assert len(info["residual"]) == len(info["nosl"]) and np.all(np.diff(info["nosl"]) >= 0)
    np.testing.assert_allclose(x.numpy(), xr, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("method", ["pcg", "chronopoulos_gear", "gropp", "pipelined_cg"])
def test_pipelined_chunks_match_jax(method):
    """The pipelined family warm-restarts in both packages."""
    A = jfx.laplace2d(20)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    At = from_jax_operator(A)
    kw = dict(method=method, tol=1e-8, maxiter=2000, chunk_iters=12)
    xr, ref = krylov_tpu.solve(A, b, M=jprecond.jacobi(A), **kw)
    x, info = krylov_tpu_torch.solve(At, b, M=precond.jacobi(At), **kw)
    assert info["converged"] and info["chunks"] > 1
    _same_counts(info, ref)
    np.testing.assert_allclose(info["residual"], ref["residual"], rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)


def test_chunks_run_whole_past_maxiter():
    """maxiter=25 with chunks of 10: three chunks, 25-30 iterations."""
    A = jfx.laplace2d(32)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    kw = dict(method="cg", tol=1e-30, maxiter=25, chunk_iters=10)
    xr, ref = krylov_tpu.solve(A, b, **kw)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, **kw)
    assert not info["converged"] and info["chunks"] == 3 and 25 <= info["iterations"] <= 30
    _same_counts(info, ref)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)


def test_chunk_iters_at_maxiter_is_one_plain_solve():
    A = jfx.laplace2d(16)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    At = from_jax_operator(A)
    x1, i1 = krylov_tpu_torch.solve(At, b, method="mrr", tol=1e-8, maxiter=300)
    x2, i2 = krylov_tpu_torch.solve(At, b, method="mrr", tol=1e-8, maxiter=300, chunk_iters=300)
    assert "chunks" not in i2 and i1["iterations"] == i2["iterations"]
    torch.testing.assert_close(x1, x2, rtol=0, atol=0)


@pytest.mark.parametrize("kw, match", [
    (dict(chunk_iters=0), "chunk_iters must be >= 1"),
    (dict(chunk_iters=-3), "chunk_iters must be >= 1"),
    (dict(chunk_iters=5, restarts=1), "mutually exclusive"),
])
def test_chunk_iters_errors(kw, match):
    A = krylov_tpu_torch.sparse.fixtures.laplace2d(6)
    with pytest.raises(ValueError, match=match):
        krylov_tpu_torch.solve(A, np.ones(36), **kw)


@pytest.mark.parametrize("method, k", [("cg", 0), ("kskipmrr", 2)])
def test_refine_with_chunks_matches_jax(method, k):
    """refine= passes chunk_iters on to its correction solves: a base solve
    cut at maxiter, then host-float64 corrections, each chunked."""
    A = jfx.laplace2d(16)
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    kw = dict(method=method, k=k, tol=1e-12, maxiter=30, chunk_iters=10, refine=4)
    xr, ref = krylov_tpu.solve(A, b, **kw)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, **kw)
    assert info["converged"] and info["true_residual"] < 1e-12 and info["refinements"] >= 1
    assert (info["iterations"], info["refinements"]) == (ref["iterations"], ref["refinements"])
    np.testing.assert_array_equal(info["nosl"], ref["nosl"])
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)
