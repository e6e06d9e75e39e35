"""krylov_tpu_torch.precond against krylov_tpu.precond.

The JAX package runs on the CPU with x64 (tests/conftest.py); operators
and preconditioners cross through from_jax_operator.  The diagonal, the
Jacobi scaling and the Gershgorin bounds are read on the host in numpy by
both packages: bitwise equal.  lanczos_bounds starts both packages from the
same numpy vector; its inner products and projections sum in another order
than XLA's, so the bounds agree to rtol 1e-10.  A Chebyshev application is
d - 1 SpMVs and axpys (the JAX package's d, the last never read), rtol
1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu import precond as jprecond
from krylov_tpu.context import Context as JaxContext
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch import precond
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


CONTAINERS = {
    "stencil": lambda: jfx.laplace2d(12, 9),
    "stencil-const": lambda: jfx.laplace2d(12, 9, constant=True),
    "stencil-3d-const": lambda: jfx.laplace3d(5, 4, 3, constant=True),
    "dia": lambda: jfx.poisson1d(50),
    "ell": lambda: jfx.random_spd_ell(300, seed=3),
    "hyb": lambda: jconvert.to_hyb(jfx.powerlaw_spd(600, seed=2, max_deg=120)),
    "dense": lambda: jconvert.to_dense(jfx.powerlaw_spd(80, seed=4)),
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_diagonal_jacobi_and_gershgorin_bitwise(name):
    A = CONTAINERS[name]()
    At = from_jax_operator(A)
    d = precond.extract_diagonal(At)
    assert isinstance(d, np.ndarray)
    np.testing.assert_array_equal(d, jprecond.extract_diagonal(A))
    M, Mr = precond.jacobi(At), jprecond.jacobi(A)
    assert M.offsets == Mr.offsets == (0,) and M.shape == Mr.shape and M.device == At.device
    np.testing.assert_array_equal(M.data.numpy(), np.asarray(Mr.data))
    assert precond.gershgorin_bounds(At) == jprecond.gershgorin_bounds(A)


@pytest.mark.parametrize("name", ["stencil", "stencil-const", "dia", "hyb", "dense"])
def test_lanczos_bounds_match_jax(name):
    A = CONTAINERS[name]()
    got = precond.lanczos_bounds(from_jax_operator(A))
    want = jprecond.lanczos_bounds(A)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(precond.lanczos_bounds(from_jax_operator(A), m=8, seed=3, safety=1.2),
                               jprecond.lanczos_bounds(A, m=8, seed=3, safety=1.2), rtol=1e-10)


@pytest.mark.parametrize("name", ["stencil", "stencil-3d-const", "hyb"])
@pytest.mark.parametrize("degree", [1, 4, 6])
def test_chebyshev_apply_matches_jax(name, degree):
    """The same preconditioner (carried across with its bounds) applied to
    one vector, and to a (batch, n) block member by member."""
    A = CONTAINERS[name]()
    Mr = jprecond.chebyshev(A, degree=degree)
    M = from_jax_operator(Mr)
    assert isinstance(M, precond.ChebyshevPreconditioner) and M.needs_ctx
    assert (M.lmin, M.lmax, M.degree) == (Mr.lmin, Mr.lmax, Mr.degree)
    V = np.random.default_rng(7).standard_normal((3, A.shape[0]))
    want = np.asarray(JaxContext().matvec(Mr, jnp.asarray(V[0])))
    got = Context().matvec(M, torch.from_numpy(V[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14 * np.abs(want).max())
    block = M.matvec(torch.from_numpy(V), Context())
    for j in range(3):
        np.testing.assert_allclose(block[j].numpy(), M.matvec(torch.from_numpy(V[j]), Context()).numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_chebyshev_bounds_choices_match_jax():
    A = jfx.laplace2d(16)
    At = from_jax_operator(A)
    for kw in (dict(bounds="gershgorin"), dict(lmin=0.1), dict(lmax=9.0, bounds="gershgorin"),
               dict(lmin=0.2, lmax=7.5)):
        M, Mr = precond.chebyshev(At, **kw), jprecond.chebyshev(A, **kw)
        assert (M.lmin, M.lmax, M.degree) == (Mr.lmin, Mr.lmax, Mr.degree)
    for bounds in ("auto", "lanczos"):
        M, Mr = precond.chebyshev(At, degree=6, bounds=bounds), jprecond.chebyshev(A, degree=6, bounds=bounds)
        np.testing.assert_allclose((M.lmin, M.lmax), (Mr.lmin, Mr.lmax), rtol=1e-10)
    with pytest.raises(ValueError, match="bounds must be"):
        precond.chebyshev(At, bounds="nope")


def test_chebyshev_auto_falls_back_only_on_a_degenerate_interval(monkeypatch):
    """bounds="auto" takes Gershgorin's interval where Lanczos gives a
    degenerate one, and lets any error of the Lanczos run through (the JAX
    package catches every exception there)."""
    A = fixtures.laplace2d(10)
    monkeypatch.setattr(precond, "lanczos_bounds", lambda A: (float("nan"), 1.0))
    M = precond.chebyshev(A)
    assert (M.lmin, M.lmax) == precond.gershgorin_bounds(A)

    def broken(A):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(precond, "lanczos_bounds", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        precond.chebyshev(A)


def test_float32_jacobi_keeps_the_dtype():
    A = jfx.laplace2d(8, dtype=np.float32)
    M = precond.jacobi(from_jax_operator(A))
    assert M.dtype == torch.float32
    np.testing.assert_array_equal(M.data.numpy(), np.asarray(jprecond.jacobi(A).data))


# The Chebyshev step (krylov_tpu_torch.kernels.stencil.chebyshev_apply): on
# the card a degree-d application on a stencil operator runs d - 1 fused
# launches; tests/test_torch_cuda.py holds it bitwise against the loop there.
# Here: the route decision, its counters, the scalar schedule and the loop
# (precond.chebyshev_loop) against the JAX package's recurrence.


class _ScalarLog(torch.overrides.TorchFunctionMode):
    """Log the Python floats a Chebyshev application multiplies or divides
    a tensor by, in order: ``("div", theta)``, then ``("mul", c)``."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        for a in args:
            if isinstance(a, float) and name in ("__truediv__", "div", "__mul__", "__rmul__", "mul"):
                self.log.append(("div" if "div" in name else "mul", a))
        return func(*args, **(kwargs or {}))


def _jax_rounds(lmin: float, lmax: float, degree: int) -> tuple:
    """``theta`` and the ``(c1, c2)`` of each of the ``degree`` rounds of
    krylov_tpu.precond.ChebyshevPreconditioner.matvec, in its arithmetic."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    pairs = []
    for _ in range(degree):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        pairs.append(((rho_new * rho), (2.0 * rho_new / delta)))
        rho = rho_new
    return theta, pairs


def _jax_recurrence(A, v: torch.Tensor, lmin: float, lmax: float, degree: int) -> torch.Tensor:
    """The JAX package's Chebyshev loop in torch's operations: ``degree``
    rounds, the last SpMV and updates included."""
    theta, pairs = _jax_rounds(lmin, lmax, degree)
    z = torch.zeros_like(v)
    r = v
    d = r / theta
    for c1, c2 in pairs:
        z = z + d
        r = r - A.matvec(d)
        d = c1 * d + c2 * r
    return z


@pytest.mark.parametrize("lmin, lmax, degree", [(0.05, 8.0, 6), (0.3, 7.7, 1), (1e-3, 2.5, 2), (0.27, 7.9, 9)])
def test_chebyshev_schedule_is_the_loops_floats(lmin, lmax, degree):
    """chebyshev_schedule gives theta and each round's (c1, c2) as the very
    floats an application divides and multiplies by, in its order, and as
    the JAX package's recurrence forms them (_jax_rounds)."""
    A = fixtures.laplace2d(6, constant=True)
    M = precond.ChebyshevPreconditioner(A, lmin, lmax, degree)
    with _ScalarLog() as mode:
        M.matvec(torch.ones(A.shape[0], dtype=torch.float64), Context())
    theta, steps = precond.chebyshev_schedule(lmin, lmax, degree)
    ops = mode.log
    assert ops[0] == ("div", theta) and len(ops) == 1 + 2 * (degree - 1)
    assert all(kind == "mul" for kind, _ in ops[1:])
    assert steps == tuple((ops[1 + 2 * k][1], ops[2 + 2 * k][1]) for k in range(degree - 1))
    jax_theta, jax_pairs = _jax_rounds(lmin, lmax, degree)
    assert theta == jax_theta and steps == tuple(jax_pairs[: degree - 1])


ROUTE_SYSTEMS = {
    "stencil 2-D": lambda dt: fixtures.laplace2d(7, 5, dtype=dt),
    "stencil 2-D constant": lambda dt: fixtures.laplace2d(7, 5, constant=True, dtype=dt),
    "stencil 3-D constant": lambda dt: fixtures.laplace3d(4, 3, 5, constant=True, dtype=dt),
    "stencil 3-D": lambda dt: fixtures.laplace3d(4, 3, 5, dtype=dt),
}


def _on_card(v: torch.Tensor, **change):
    """What fused_route reads of ``v``, as if ``v`` lay on a card."""
    import types

    seen = dict(is_cuda=True, dtype=v.dtype, device=v.device, ndim=v.ndim, shape=tuple(v.shape),
                is_contiguous=lambda: True)
    seen.update(change)
    return types.SimpleNamespace(**seen)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(ROUTE_SYSTEMS))
def test_fused_route_takes_the_stencils_k1_takes(name, dtype):
    """A vector on the operator's card, in its dtype, (n,) or (batch, n),
    with a single-process context: the fused route for each stencil form
    K1 takes; declined for another dtype, length or rank, a non-contiguous
    vector, a process group, or a vector off the card."""
    A = ROUTE_SYSTEMS[name](dtype)
    n = A.shape[0]
    v = torch.zeros(n, dtype=dtype)
    assert precond.fused_route(A, _on_card(v), Context())
    assert precond.fused_route(A, _on_card(torch.zeros((3, n), dtype=dtype)), Context())
    grouped = Context(axis="rows", group=object())
    other = torch.float32 if dtype == torch.float64 else torch.float64
    for seen, ctx in ((_on_card(v), grouped), (_on_card(v, dtype=other), Context()),
                      (_on_card(v, dtype=torch.float16), Context()), (_on_card(v, shape=(n + 1,)), Context()),
                      (_on_card(v, ndim=3, shape=(2, 2, n)), Context()),
                      (_on_card(v, is_contiguous=lambda: False), Context()), (v, Context())):
        assert not precond.fused_route(A, seen, ctx)


def test_fused_route_declines_other_operators():
    """DIA, ELL, HYB, dense and 1-D stencil operators run the loop, on the
    card too, as does a stencil of more terms than the kernels take."""
    from krylov_tpu_torch.sparse import StencilMatrix

    A = fixtures.laplace2d(6, 5)
    n = A.shape[0]
    seen = _on_card(torch.zeros(n, dtype=torch.float64))
    others = [A.to_dia()] + [from_jax_operator(CONTAINERS[name]()) for name in ("ell", "hyb", "dense")] + [
        StencilMatrix(torch.tensor([-1.0, 2.0, -1.0], dtype=torch.float64), ((-1,), (0,), (1,)), (n,))]
    wide = tuple((i, j) for i in (-2, -1, 0, 1, 2) for j in (-2, -1, 0, 1, 2))
    others.append(StencilMatrix(torch.ones(len(wide), dtype=torch.float64), wide, (6, 5)))
    assert len(wide) > precond._build.MAX_TERMS
    for B in others:
        assert not precond.fused_route(B, seen, Context()), type(B).__name__


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_application_counter_counts_the_loop(name):
    """Off the card every application runs the loop: each counts one call
    in tracing.totals.cheb_apply and none fused, records nothing in
    tracing.recorded, and launches no Chebyshev step."""
    from krylov_tpu_torch import tracing

    A = from_jax_operator(CONTAINERS[name]())
    M = precond.ChebyshevPreconditioner(A, 0.1, 8.0, 3)

    def counts():
        return tuple(getattr(getattr(store, group), field) for store in (tracing.totals, tracing.recorded)
                     for group, field in (("cheb_apply", "calls"), ("cheb_apply", "fused"),
                                          ("chebyshev_apply", "launches")))

    before = counts()
    V = torch.from_numpy(np.random.default_rng(3).standard_normal((2, A.shape[0])))
    M.matvec(V[0], Context())
    M.matvec(V, Context())
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 0, 0, 0, 0, 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(ROUTE_SYSTEMS))
def test_loop_equals_the_full_recurrence(name, dtype, degree, batch):
    """An application off the card (precond.chebyshev_loop, degree - 1
    SpMVs) gives bit for bit the z of the JAX package's recurrence of
    degree SpMVs, signs of zeros included; v unchanged."""
    A = ROUTE_SYSTEMS[name](dtype)
    rng = np.random.default_rng(11)
    v = torch.from_numpy(rng.standard_normal((batch or 1, A.shape[0]))).to(dtype)
    v[:, :4] = -0.0
    if batch is None:
        v = v[0]
    kept = v.clone()
    want = _jax_recurrence(A, v, 0.05, 7.9, degree)
    got = precond.ChebyshevPreconditioner(A, 0.05, 7.9, degree).matvec(v, Context())
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(v), _bits(kept))


def test_chebyshev_step_refuses_a_cpu_tensor():
    """The Chebyshev step runs on the card alone: on a CPU tensor it raises
    (precond.fused_route never sends one there)."""
    from krylov_tpu_torch.kernels import stencil

    A = fixtures.laplace2d(6, 5)
    v = torch.ones(A.shape[0], dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        stencil.chebyshev_apply(A, v, *precond.chebyshev_schedule(0.05, 7.9, 3))
