"""Batched preconditioned, pipelined and CA solves: krylov_tpu_torch.solve_batched
of pcg, chronopoulos_gear, gropp, pipelined_cg, cacg and camrr, one loop
over ``(batch, N)`` blocks, against each member's solo solve and against
the JAX package's ``vmap`` (krylov_tpu.solve_batched, on the CPU with
x64).

Against the solo solves every member is bitwise equal: iterations, outer
index, convergence flag, residual and nosl traces and x (a batched
member's inner products and Gram are its solo ones, and the loops freeze
a finished member as the solo loop stops).  Against the JAX package, in
float64: equal counts, nosl and convergence flags per member; residual
histories and x at the tolerances of tests/test_torch_pipelined.py (rtol
1e-9, atol 1e-14; x rtol 1e-8, atol 1e-12) and tests/test_torch_cacg.py
(rtol 1e-8, atol 1e-13; x rtol 1e-8, atol 1e-12).  Operators and
preconditioners cross through from_jax_operator, a JAX
ChebyshevPreconditioner included; both packages take the same spectral
bounds for the CA methods.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu
from krylov_tpu import precond as jprecond
from krylov_tpu.solvers.cacg import cacg_kernel as jax_cacg
from krylov_tpu.solvers.cacg import camrr_kernel as jax_camrr
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx

import krylov_tpu_torch
from krylov_tpu_torch import api
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.solvers import cacg as cacg_module
from krylov_tpu_torch.solvers import cacg_kernel, camrr_kernel, pcg_kernel, pipelined_cg_kernel
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


PIPELINED = ["pcg", "chronopoulos_gear", "gropp", "pipelined_cg"]
SYSTEMS = {
    "laplace2d": lambda: jfx.laplace2d(16),
    "hyb": lambda: jconvert.to_hyb(jfx.powerlaw_spd(512, seed=11, max_deg=100)),
}
PRECONDS = {
    "none": lambda A: None,
    "jacobi": jprecond.jacobi,
    "chebyshev3": lambda A: jprecond.chebyshev(A, degree=3),
}
# (residual rtol, atol, x rtol, atol) against the JAX package
JAX_TOLS = {"pipelined": (1e-9, 1e-14, 1e-8, 1e-12), "ca": (1e-8, 1e-13, 1e-8, 1e-12)}
KERNELS = {"cacg": (cacg_kernel, jax_cacg), "camrr": (camrr_kernel, jax_camrr)}


def _same_as_solo(res, solos):
    """Each member of the batch bitwise equal to its solo result."""
    for j, solo in enumerate(solos):
        for field in ("iterations", "index", "converged"):
            assert getattr(res, field)[j].item() == getattr(solo, field).item(), (j, field)
        m = int(solo.index) + 1
        assert torch.equal(res.nosl_trace[j, :m], solo.nosl_trace[:m]), j
        assert torch.equal(res.residual_trace[j, :m], solo.residual_trace[:m]), j
        assert torch.equal(res.x[j], solo.x), j


def _same_as_jax(res, ref, kind):
    t_rtol, t_atol, x_rtol, x_atol = JAX_TOLS[kind]
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.index.numpy(), np.asarray(ref.index))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    for j, idx in enumerate(np.asarray(ref.index)):
        m = int(idx) + 1
        np.testing.assert_array_equal(res.nosl_trace[j, :m].numpy(), np.asarray(ref.nosl_trace)[j, :m])
        np.testing.assert_allclose(res.residual_trace[j, :m].numpy(), np.asarray(ref.residual_trace)[j, :m],
                                   rtol=t_rtol, atol=t_atol)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=x_rtol, atol=x_atol)


def _solve_both(A, B, method, M=None, X0=None, **kw):
    """``(port batch, the port's solo solves, JAX batch)`` of one case."""
    ref = krylov_tpu.solve_batched(A, B, method=method, M=M, X0=X0, **kw)
    At = from_jax_operator(A)
    Mt = None if M is None else from_jax_operator(M)
    res = krylov_tpu_torch.solve_batched(At, B, method=method, M=Mt, X0=X0, **kw)
    solos = [krylov_tpu_torch.solve_device(At, b, method=method, M=Mt, x0=None if X0 is None else X0[j], **kw)
             for j, b in enumerate(B)]
    return res, solos, ref


@pytest.mark.parametrize("pre", sorted(PRECONDS))
@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("method", PIPELINED)
def test_batched_pipelined_family_matches_solo_and_jax(method, system, pre):
    A = SYSTEMS[system]()
    B = np.random.default_rng(7).standard_normal((3, A.shape[0]))
    res, solos, ref = _solve_both(A, B, method, M=PRECONDS[pre](A), tol=1e-8, maxiter=1000)
    assert res.x.shape == B.shape and bool(res.converged.all())
    _same_as_solo(res, solos)
    _same_as_jax(res, ref, "pipelined")


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_batched_ca_chebyshev_matches_solo_and_jax(method, s, system):
    A = SYSTEMS[system]()
    bounds = jprecond.lanczos_bounds(A)
    B = np.random.default_rng(8).standard_normal((3, A.shape[0]))
    res, solos, ref = _solve_both(A, B, method, k=s, tol=1e-8, maxiter=1000, spectral_bounds=bounds)
    assert bool(res.converged.all())
    _same_as_solo(res, solos)
    _same_as_jax(res, ref, "ca")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_batched_ca_monomial_matches_solo_and_jax(method, s):
    """basis="monomial" through the kernels: the batch against the solo
    kernel calls and the JAX kernel's vmap."""
    kernel, jax_kernel = KERNELS[method]
    A = jfx.laplace2d(16)
    B = np.random.default_rng(9).standard_normal((3, A.shape[0]))
    kw = dict(tol=1e-8, maxiter=800, s=s, basis="monomial")
    Ad = jax.tree.map(jnp.asarray, A)
    ref = jax.vmap(lambda b: jax_kernel(Ad, b, jnp.zeros_like(b), **kw))(jnp.asarray(B))
    At, Bt = from_jax_operator(A), torch.from_numpy(B)
    res = kernel(At, Bt, torch.zeros_like(Bt), ctx=Context(), **kw)
    _same_as_solo(res, [kernel(At, b, torch.zeros_like(b), ctx=Context(), **kw) for b in Bt])
    _same_as_jax(res, ref, "ca")


@pytest.mark.parametrize("method", [*PIPELINED, "cacg", "camrr"])
def test_member_that_converges_early_freezes(method):
    """Member 0 starts next to its solution and converges within a few
    iterations; the others run on (the CA methods' advance on part of the
    batch).  Each member is its solo solve."""
    A = jfx.laplace2d(16)
    B = np.random.default_rng(10).standard_normal((3, A.shape[0]))
    X0 = np.zeros_like(B)
    X0[0] = np.linalg.solve(np.asarray(A.todense()), B[0]) + 1e-9 * np.random.default_rng(11).standard_normal(
        A.shape[0])
    kw = dict(tol=1e-8, maxiter=1000)
    if method in ("cacg", "camrr"):
        kw.update(k=4, spectral_bounds=jprecond.lanczos_bounds(A))
        M = None
    else:
        M = jprecond.jacobi(A)
    res, solos, ref = _solve_both(A, B, method, M=M, X0=X0, **kw)
    assert int(res.iterations[0]) < int(res.iterations[1]) // 4 and bool(res.converged.all())
    _same_as_solo(res, solos)
    if method == "chronopoulos_gear":
        # member 0's r0 is already below tol: the port tests r0 before the
        # first step, as every other loop does, and keeps x0, where the JAX
        # package takes one step (ROADMAP queue 3, F1); the others as JAX
        assert int(res.iterations[0]) == 0 and int(ref.iterations[0]) == 1
        assert torch.equal(res.x[0], torch.from_numpy(X0[0]))
        np.testing.assert_allclose(res.residual_trace[0, 0].item(), float(ref.residual_trace[0, 0]), rtol=1e-9)
        fields = ("iterations", "index", "converged", "nosl_trace", "residual_trace", "x")
        res = SimpleNamespace(**{f: getattr(res, f)[1:] for f in fields})
        ref = SimpleNamespace(**{f: np.asarray(getattr(ref, f))[1:] for f in fields})
    _same_as_jax(res, ref, "ca" if method in ("cacg", "camrr") else "pipelined")


# the rollback cases: (grid side, kernel arguments, the operator's dtype,
# the scalar dtype); the members' right-hand sides come from seeds 1234, 1
# and 2.  cacg: the guard case of tests/test_torch_cacg.py (float32
# vectors, float64 scalars, s = 8 on laplace2d(48), Lanczos bounds); camrr,
# which that case does not roll back, in float32 on the monomial basis at
# s = 8 on laplace2d(16)
ROLLBACKS = {
    "cacg": (48, dict(s=8), np.float32, torch.float64),
    "camrr": (16, dict(s=8, basis="monomial"), np.float32, None),
}


@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_rollback_member_beside_advancing_members(monkeypatch, method):
    """An unreachable tol: the members roll back at different outer
    iterations, so in some outer iterations one member rolls back while
    another advances (the branches of each outer iteration are recorded).
    Each member is its solo solve bitwise and takes the JAX package's
    counts and nosl (each rollback still counts s updates); the traces
    stay finite."""
    branch_log = []
    read = cacg_module._Outer.read

    def logged(self, *args):
        out = read(self, *args)
        branch_log.append((out[0].size, out[1].size))
        return out

    monkeypatch.setattr(cacg_module._Outer, "read", logged)
    kernel, jax_kernel = KERNELS[method]
    nx, kw, dt, sdt = ROLLBACKS[method]
    A = jfx.laplace2d(nx, dtype=dt)
    if method == "cacg":
        kw = dict(kw, **dict(zip(("lmin", "lmax"), jprecond.lanczos_bounds(A))))
    B = np.stack([np.random.default_rng(seed).standard_normal(A.shape[0]) for seed in (1234, 1, 2)]).astype(dt)
    kw.update(tol=1e-30, maxiter=320)
    Ad = jax.tree.map(jnp.asarray, A)
    jctx = krylov_tpu.Context(scalar_dtype=None if sdt is None else jnp.float64)
    ref = jax.vmap(lambda b: jax_kernel(Ad, b, jnp.zeros_like(b), ctx=jctx, **kw))(jnp.asarray(B))
    At, Bt = from_jax_operator(A), torch.from_numpy(B)
    ctx = Context(scalar_dtype=sdt)
    res = kernel(At, Bt, torch.zeros_like(Bt), ctx=ctx, **kw)
    mixed = sum(bool(adv and rb) for adv, rb in branch_log)
    _same_as_solo(res, [kernel(At, b, torch.zeros_like(b), ctx=ctx, **kw) for b in Bt])
    assert mixed > 0, "no outer iteration mixes a rollback and an advance"
    assert not bool(res.converged.any()) and bool(torch.isfinite(res.residual_trace).all())
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.nosl_trace.numpy(), np.asarray(ref.nosl_trace))


class _Counted:
    """An operator that counts its matvec calls."""

    def __init__(self, A):
        self.A, self.calls = A, 0
        self.shape, self.dtype, self.device = A.shape, A.dtype, A.device

    def matvec(self, x):
        self.calls += 1
        return self.A.matvec(x)


@pytest.mark.parametrize("kernel, kw", [
    (pcg_kernel, {}),
    (pipelined_cg_kernel, {}),  # its replacement every 25 iterations
    (cacg_kernel, dict(s=4, lmin=0.02, lmax=8.0)),
    (camrr_kernel, dict(s=4, lmin=0.02, lmax=8.0)),
])
def test_batch_makes_the_longest_solos_spmvs(kernel, kw):
    """A batch applies the operator to its whole block as often as its
    longest member's solo solve does: one SpMV a step for every member,
    one K1 launch on a stencil on the card."""
    A = krylov_tpu_torch.sparse.fixtures.laplace2d(16)
    B = torch.from_numpy(np.random.default_rng(12).standard_normal((4, A.shape[0])))
    B[0] = A.matvec(torch.full((A.shape[0],), 1e-3))  # converges first
    counted = _Counted(A)
    kernel(counted, B, torch.zeros_like(B), tol=1e-9, maxiter=1000, **kw)
    solo = []
    for b in B:
        one = _Counted(A)
        kernel(one, b, torch.zeros_like(b), tol=1e-9, maxiter=1000, **kw)
        solo.append(one.calls)
    assert counted.calls == max(solo) and min(solo) < max(solo)


@pytest.mark.parametrize("kernel", [cacg_kernel, camrr_kernel])
def test_carry_takes_one_system(kernel):
    """carry_in=/emit_carry= are single-system: a batch raises."""
    A = krylov_tpu_torch.sparse.fixtures.laplace2d(8)
    B = torch.ones(2, 64, dtype=torch.float64)
    kw = dict(tol=1e-8, maxiter=20, s=2, lmin=0.1, lmax=8.0)
    with pytest.raises(ValueError, match="take one system"):
        kernel(A, B, torch.zeros_like(B), emit_carry=True, **kw)
    solo = kernel(A, B[0], torch.zeros_like(B[0]), emit_carry=True, **kw)
    carry = tuple(torch.stack([t, t]) for t in solo.carry)
    with pytest.raises(ValueError, match="take one system"):
        kernel(A, B, torch.zeros_like(B), carry_in=(carry, True), **kw)


@pytest.mark.parametrize("method", [*PIPELINED, "cacg", "camrr"])
def test_solve_batched_makes_one_loop_call(monkeypatch, method):
    """The whole batch goes through one call of the eager loop."""
    calls = []
    loop = api._KERNELS[method]

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return loop(*args, **kw)

    monkeypatch.setitem(api._KERNELS, method, counted)
    A = krylov_tpu_torch.sparse.fixtures.laplace2d(10)
    B = np.random.default_rng(13).standard_normal((5, 100))
    kw = dict(k=2) if method in ("cacg", "camrr") else dict(M=krylov_tpu_torch.precond.jacobi(A))
    res = krylov_tpu_torch.solve_batched(A, B, method=method, tol=1e-8, maxiter=500, **kw)
    assert calls == [(5, 100)] and bool(res.converged.all())
