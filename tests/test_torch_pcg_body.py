"""Preconditioned CG's body on the four steps of ``krylov_tpu_torch.kernels.pcg``
on the CPU.

``solvers.pipelined.pcg_route`` decides from the solve's input whether the
steps launch their kernels: ``b`` on the card in float32 or float64
(``kernels.pcg.takes``), ``x0`` and ``tol`` to match, a context without a
process group and with ``b``'s scalar dtype.  Here the route declines on
CPU tensors; with its device test waived, each other condition declines on
its own.  Declined, the steps run torch's passes, which give the textbook
body's bits.  ``tests/test_torch_cuda.py`` holds the kernels on the card.
"""

import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu_torch import context, tracing
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.kernels import pcg
from krylov_tpu_torch.precond import chebyshev, jacobi
from krylov_tpu_torch.solvers import cg_kernel, pipelined
from krylov_tpu_torch.solvers._common import run_bodies, safe_div, scale, set_at, tree_select
from krylov_tpu_torch.sparse import fixtures


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


PRECONDS = {"none": lambda A: None, "jacobi": jacobi, "chebyshev(6)": lambda A: chebyshev(A, 6)}


def _rhs(A, seed, batch=None):
    rng = np.random.default_rng(seed)
    shape = (A.shape[0],) if batch is None else (batch, A.shape[0])
    return torch.from_numpy(rng.standard_normal(shape)).to(A.dtype)


def _counts() -> tuple:
    return tracing.totals.pcg_body.calls, tracing.totals.pcg_body.fused, tracing.totals.eager_bodies.calls


def _moved(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_counts(), before))


def _same(a, b):
    assert torch.equal(a.x, b.x) and torch.equal(a.iterations, b.iterations)
    assert torch.equal(a.converged, b.converged)
    last = int(a.index.max())
    assert torch.equal(a.residual_trace[..., : last + 1], b.residual_trace[..., : last + 1])


@pytest.mark.parametrize("case", ["cpu tensors", "a process group", "another scalar dtype"])
def test_pcg_route_declines_and_the_body_counts_no_fused(monkeypatch, case):
    """The route declines on CPU tensors, on a context with a process
    group (a world of one, its sum the input) and on a scalar dtype other
    than ``b``'s, each alone (the other conditions hold: with the device
    test waived the plain context is taken); the body then counts every
    call and none fused.  With the group the solve is the plain context's
    bit for bit."""
    dtype = torch.float32 if case == "another scalar dtype" else torch.float64
    A = fixtures.laplace2d(16, constant=True, dtype=dtype)
    b = _rhs(A, 1)
    x0 = torch.zeros_like(b)
    ctx = Context()
    if case == "a process group":
        monkeypatch.setattr(context, "all_reduce", lambda t, group: t)
        ctx = Context(axis="rows", group=object())
    elif case == "another scalar dtype":
        ctx = Context(scalar_dtype=torch.float64)
    assert not pcg.takes(b)
    if case != "cpu tensors":
        with monkeypatch.context() as m:
            m.setattr(pcg, "takes", lambda b: True)
            assert pipelined.pcg_route(Context(), b, x0, 1e-8) and not pipelined.pcg_route(ctx, b, x0, 1e-8)
    assert not pipelined.pcg_route(ctx, b, x0, 1e-8)
    before = _counts()
    got = pipelined.pcg_kernel(A, b, x0, tol=1e-8, maxiter=300, M=jacobi(A), ctx=ctx)
    calls, fused, bodies = _moved(before)
    assert bool(got.converged) and calls == bodies > 0 and fused == 0
    if case == "a process group":
        _same(got, pipelined.pcg_kernel(A, b, x0, tol=1e-8, maxiter=300, M=jacobi(A)))


ROUTE_INPUTS = {
    "x0 of another dtype": (lambda b: b.float(), 1e-8, False),
    "x0 not contiguous": (lambda b: torch.zeros(b.shape[:-1] + (2 * b.shape[-1],), dtype=b.dtype)[..., ::2],
                          1e-8, False),
    "tol a tensor of another dtype": (torch.zeros_like, torch.tensor(1e-8, dtype=torch.float32), False),
    "tol a tensor a member": (torch.zeros_like, torch.full((2,), 1e-8, dtype=torch.float64), False),
    "tol a 0-d tensor of the dtype": (torch.zeros_like, torch.tensor(1e-8, dtype=torch.float64), True),
    "tol a number": (torch.zeros_like, 1e-8, True),
}


@pytest.mark.parametrize("name", sorted(ROUTE_INPUTS))
def test_pcg_route_reads_x0_and_tol(monkeypatch, name):
    """With the device test waived, the route takes ``x0`` of ``b``'s
    dtype and contiguous and ``tol`` a number or a 0-d tensor of ``b``'s
    dtype and device, and declines the rest."""
    monkeypatch.setattr(pcg, "takes", lambda b: True)
    make_x0, tol, taken = ROUTE_INPUTS[name]
    b = torch.ones(2, 64, dtype=torch.float64)
    assert pipelined.pcg_route(Context(), b, make_x0(b), tol) == taken


def _textbook_pcg(A, b, x0, *, tol, maxiter, M=None, ctx=Context()):
    """Preconditioned CG's body as the textbook writes it in torch's
    passes, ``<r, r>`` taken anew each body and the selects at its end, on
    the package's block runner: the reference of the steps' torch passes."""
    matvec = ctx.matvec

    def apply_M(v):
        return v if M is None else matvec(M, v)

    b_norm = ctx.norm(b)
    x, r = x0, b - matvec(A, x0)
    u = apply_M(r)
    p, ru = u, ctx.dot(r, u)
    batch = b.shape[:-1]
    trace = torch.zeros(batch + (maxiter + 1,), dtype=b.dtype)
    i, conv = torch.zeros(batch, dtype=torch.int64), torch.zeros(batch, dtype=torch.bool)

    def body(state):
        tol, b_norm, x, r, u, p, ru, trace, i, conv = state
        res = torch.sqrt(ctx.dot(r, r)) / b_norm
        set_at(trace, i, res)
        conv = res < tol
        s = matvec(A, p)
        alpha = safe_div(ru, ctx.dot(s, p))
        x_n, r_n = x + scale(alpha, p), r - scale(alpha, s)
        u_n = apply_M(r_n)
        ru_n = ctx.dot(r_n, u_n)
        p_n = u_n + scale(safe_div(ru_n, ru), p)
        x, r, u, p, ru = tree_select(conv, (x, r, u, p, ru), (x_n, r_n, u_n, p_n, ru_n))
        return tol, b_norm, x, r, u, p, ru, trace, i + (~conv).to(i.dtype), conv

    *_, x, r, u, p, ru, trace, i, conv = run_bodies(body, (tol, b_norm, x, r, u, p, ru, trace, i, conv), maxiter,
                                                    ctx)
    return x, trace, i, conv


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("precond", sorted(PRECONDS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_body_on_torch_passes_equals_the_textbook_body(dtype, precond, batch):
    """Declined (CPU tensors), the body's steps run torch's passes
    (``<r, r>`` carried, ``u`` not, the selects inside each step): bit for
    bit the textbook body, solo and for a batch whose members converge at
    different counts; every body counted, none as fused."""
    A = fixtures.laplace2d(16, constant=True, dtype=dtype)
    M = PRECONDS[precond](A)
    b = _rhs(A, 2, batch)
    if batch:  # member 1 an eigenvector of the Laplacian: it converges at once and freezes
        s = np.sin(np.pi * np.arange(1, 17) / 17)
        b[1] = torch.from_numpy(np.outer(s, s).reshape(-1))
    kw = dict(tol=1e-9 if dtype == torch.float64 else 1e-5, maxiter=300, M=M)
    before = _counts()
    got = pipelined.pcg_kernel(A, b, torch.zeros_like(b), **kw)
    calls, fused, bodies = _moved(before)
    assert bool(got.converged.all()) and calls == bodies > 0 and fused == 0
    assert batch is None or int(got.iterations[1]) < int(got.iterations[0])
    x, trace, i, conv = _textbook_pcg(A, b, torch.zeros_like(b), **kw)
    assert torch.equal(got.x, x) and torch.equal(got.iterations, i) and torch.equal(got.converged, conv)
    last = int(i.max())
    assert torch.equal(got.residual_trace[..., : last + 1], trace[..., : last + 1])
    if precond == "none":
        _same(got, cg_kernel(A, b, torch.zeros_like(b), tol=kw["tol"], maxiter=300))


@pytest.mark.parametrize("step", ["alpha", "xr", "ru", "p"])
def test_pcg_steps_refuse_cpu_tensors_given_a_scratch(step):
    """Given a scratch, a step launches its kernel, which takes CUDA
    tensors alone: on CPU tensors it raises before any launch, and counts
    nothing."""
    v = torch.ones(64, dtype=torch.float64)
    one, no = torch.ones((), dtype=torch.float64), torch.zeros((), dtype=torch.bool)
    work = torch.zeros(2, dtype=torch.float64)
    calls = {
        "alpha": lambda: pcg.step_alpha(Context(), v, v, one, one, one, 1e-8, torch.zeros(4, dtype=v.dtype),
                                        torch.zeros((), dtype=torch.int64), work),
        "xr": lambda: pcg.step_xr(Context(), v, v, v, v, one, no, one, work),
        "ru": lambda: pcg.step_ru(Context(), v, v, one, no, work),
        "p": lambda: pcg.step_p(v, v, one, no, work),
    }
    before = getattr(tracing.totals.pcg_launches, step)
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[step]()
    assert getattr(tracing.totals.pcg_launches, step) == before
