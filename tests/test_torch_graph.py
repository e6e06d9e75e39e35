"""The eager loops' block runner (``krylov_tpu_torch.solvers._common.run_bodies``)
on the CPU.

The runner runs a loop's bodies in blocks of ``SYNC_EVERY`` = 32 and reads
convergence after each full block, where ``synced_done`` reads it; the last
``steps % 32`` bodies run one by one.  On the card a key's first block warms
up, and the full blocks after it replay one captured CUDA graph where the
capture pays back: two full blocks left, or one and a key that has come back.
Here that route is emulated: its
streams are no-ops and a "capture" keeps the block's Python function, which
each replay calls on the static state, so the schedule, the copies in and
out of the static state, the cache's keys and the counters are held on the
CPU against the eager route, bit for bit.  The adaptive k-skip loop's
steps (``replay_step``: an outer iteration and its guard's flags, a graph
a k) are emulated the same way.  tests/test_torch_cuda.py holds the
captured graphs on the card.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu_torch import solvers, tracing
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.precond import chebyshev, jacobi
from krylov_tpu_torch.solvers import _common
from krylov_tpu_torch.sparse import fixtures

SYNC = _common.SYNC_EVERY


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


class _Stream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


@pytest.fixture
def emulated(monkeypatch):
    """The graph route on CPU tensors: engaged by the rule less its
    ``is_cuda``, streams and devices as no-ops, and a capture that keeps
    the block's function (a capture launches nothing; each replay runs the
    block).  Returns the block cache, empty at the start."""
    monkeypatch.setattr(_common, "graph_route", lambda ctx, state, steps: steps >= SYNC and ctx.group is None)
    monkeypatch.setattr(_common, "step_route", lambda state: True)
    monkeypatch.setattr(_common, "_record", lambda fn, device, pool=None: fn)
    monkeypatch.setattr(_common, "_side_stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    blocks = collections.OrderedDict()
    monkeypatch.setattr(_common, "_BLOCKS", blocks)
    return blocks


def _counts() -> tuple:
    g = tracing.totals.eager_graph
    return (tracing.totals.eager_bodies.calls, tracing.totals.host_read.calls, g.captures, g.replays, g.bodies)


def _delta(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_counts(), before))


def _counter(stop_at: int):
    """A loop whose state is ``(n, conv)``: each body adds 1 to ``n``;
    ``conv`` turns true once ``n`` reaches ``stop_at``."""

    def body(state):
        n, _ = state
        n = n + 1
        return n, n >= stop_at

    return body


def _run_counter(steps: int, stop_at: int):
    state = (torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.bool))
    before = _counts()
    n, _ = _common.run_bodies(_counter(stop_at), state, steps, Context())
    return int(n), _delta(before)


# (steps, stop_at) -> bodies run and reads made (a read after every 32nd
# body, the loop stopping at the first read that sees conv), then the
# graph route's captures and replays in a first, second and third request
SCHEDULES = {
    "full blocks": (96, 10**9, 96, 3, ((1, 2), (0, 3), (0, 3))),
    # one block left after the first warm-up: the capture waits for the
    # key to come back
    "full blocks and a tail": (77, 10**9, 77, 2, ((0, 0), (1, 1), (0, 2))),
    "a warm-up and one block": (64, 10**9, 64, 2, ((0, 0), (1, 1), (0, 2))),
    "an exit at the second block's read": (200, 40, 64, 2, ((1, 1), (0, 2), (0, 2))),
    # done at the warm-up's read: nothing captured, so each request warms up
    "an exit at the first read": (200, 5, 32, 1, ((0, 0),) * 3),
    # the warm-up leaves less than a block: nothing captured
    "a warm-up and a tail": (63, 10**9, 63, 1, ((0, 0),) * 3),
    "a tail alone": (31, 10**9, 31, 0, ((0, 0),) * 3),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_eager_schedule(case):
    """On the CPU the runner runs the plain eager loop: a body a step, a read after
    every 32nd, counted as ``synced_done`` counts them; no graph."""
    steps, stop_at, bodies, reads, _ = SCHEDULES[case]
    n, (counted, read, captures, replays, in_replays) = _run_counter(steps, stop_at)
    assert (n, counted, read) == (bodies, bodies, reads)
    assert (captures, replays, in_replays) == (0, 0, 0)


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_emulated_graph_schedule(emulated, case):
    """The graph route's schedule: a request on a key without a graph runs
    one block eagerly (the warm-up), captures where two full blocks are
    left (one where the key has come back), and replays the full blocks
    left; a request on a captured key replays every full block; each runs
    its tail eagerly.  Bodies and reads are those of the eager route, and
    every body a replay runs is counted in ``eager_graph.bodies``."""
    steps, stop_at, bodies, reads, requests = SCHEDULES[case]
    for captures_replays in requests:
        n, (counted, read, captures, replays, in_replays) = _run_counter(steps, stop_at)
        assert (n, counted, read) == (bodies, bodies, reads)
        assert (captures, replays, in_replays) == (*captures_replays, SYNC * captures_replays[1])


def test_emulated_results_do_not_alias_the_static_state(emulated):
    """Two requests on one key: the second's result is new tensors, and the
    first's is untouched by it."""
    first, _ = _common.run_bodies(_counter(10**9), (torch.zeros(()), torch.zeros((), dtype=torch.bool)), 96,
                                  Context())
    (block,) = emulated.values()
    second, _ = _common.run_bodies(_counter(10**9), (torch.full((), 1000.0), torch.zeros((), dtype=torch.bool)),
                                   96, Context())
    assert (float(first), float(second)) == (96.0, 1096.0)
    assert all(first is not t and second is not t for t in block.static)


def _system(n=24, dtype=torch.float64):
    return fixtures.laplace2d(n, constant=True, dtype=dtype)


def _rhs(A, seed, batch=None):
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    if batch is None:
        return torch.from_numpy(rng.standard_normal(n)).to(A.dtype)
    B = torch.from_numpy(rng.standard_normal((batch, n))).to(A.dtype)
    # member 1 an eigenvector of the Laplacian: it converges at once, inside
    # the first block, and freezes while the others run
    g = int(round(n ** 0.5))
    s = np.sin(np.pi * np.arange(1, g + 1) / (g + 1))
    B[1] = torch.from_numpy(np.outer(s, s).reshape(-1)).to(A.dtype)
    return B


LOOPS = {
    "cg": (solvers.cg_kernel, lambda A: {}),
    "mrr": (solvers.mrr_kernel, lambda A: {}),
    "kskipcg k=1": (solvers.kskipcg_kernel, lambda A: {"k": 1}),
    "kskipmrr k=1": (solvers.kskipmrr_kernel, lambda A: {"k": 1}),
    "kskipcg k=1 basis_norm": (solvers.kskipcg_kernel, lambda A: {"k": 1, "basis_norm": True}),
    "pcg": (solvers.pcg_kernel, lambda A: {}),
    "pcg jacobi": (solvers.pcg_kernel, lambda A: {"M": jacobi(A)}),
    "pcg chebyshev(6)": (solvers.pcg_kernel, lambda A: {"M": chebyshev(A, 6)}),
    "chronopoulos_gear jacobi": (solvers.chronopoulos_gear_kernel, lambda A: {"M": jacobi(A)}),
    "gropp jacobi": (solvers.gropp_kernel, lambda A: {"M": jacobi(A)}),
}
CARRIES = ("cg", "mrr", "kskipcg k=1", "kskipmrr k=1", "kskipcg k=1 basis_norm")


def _solve(name, A, b, extra, **kw):
    if name in CARRIES:
        kw["emit_carry"] = True
    return LOOPS[name][0](A, b, torch.zeros_like(b), **extra, **kw)


def _same(a, b):
    """Bitwise equality of two results, the trace up to each member's index."""
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.iterations, b.iterations) and torch.equal(a.index, b.index)
    assert torch.equal(a.converged, b.converged)
    last = int(a.index.max())
    assert torch.equal(a.residual_trace[..., : last + 1], b.residual_trace[..., : last + 1])
    if a.carry is not None:
        assert all(torch.equal(u, v) for u, v in zip(a.carry, b.carry))


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("tol, maxiter", [(1e-12, 400), (0.0, 154)], ids=["converging", "tail"])
@pytest.mark.parametrize("name", sorted(LOOPS))
def test_emulated_graph_route_equals_eager(emulated, monkeypatch, name, tol, maxiter, batch):
    """Each loop on the runner: three requests on one key through the
    emulated graph route (a capture in the first or, where it leaves one
    block after its warm-up, the second; the last replays from its start)
    against the eager route, bit for bit, with the same bodies and reads;
    one capture in all, and replays.  ``tol = 0`` runs every step: full
    blocks, then a tail (154 steps; 77 outer iterations at k = 1).
    Chebyshev(6) pcg converges inside its first block (28 iterations), so
    nothing is captured there."""
    A = _system()
    extra = LOOPS[name][1](A)  # one preconditioner object for every request
    bs = [_rhs(A, seed, batch) for seed in (1, 2, 5)]
    before = _counts()
    graph = [_solve(name, A, b, extra, tol=tol, maxiter=maxiter) for b in bs]
    on_graph = _delta(before)
    first_x = graph[0].x.clone()
    with monkeypatch.context() as m:
        m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
        before = _counts()
        eager = [_solve(name, A, b, extra, tol=tol, maxiter=maxiter) for b in bs]
        on_eager = _delta(before)
    for g, e in zip(graph, eager):
        _same(g, e)
    assert torch.equal(graph[0].x, first_x)
    assert on_graph[:2] == on_eager[:2]
    assert on_eager[2:] == (0, 0, 0)
    if name == "pcg chebyshev(6)" and tol:
        assert on_graph[2:] == (0, 0, 0)
    else:
        assert on_graph[2] == 1 and on_graph[3] >= 2


def test_emulated_replays_add_what_the_capture_recorded(emulated, monkeypatch):
    """The counts a captured body makes (K1's and the Chebyshev step's
    launches, the Chebyshev applications and those fused): the capture
    moves only ``tracing.recorded``, and each replay adds what it recorded
    to ``tracing.totals``.  The capture here runs its block once with the
    stream taken as capturing, as a CUDA graph's capture runs it; a replay
    runs nothing."""
    counted = [("stencil_matvec_2d", ("launches",), 1), ("chebyshev_apply", ("launches",), 5),
               ("cheb_apply", ("calls", "fused"), 1)]
    capturing = [False]
    monkeypatch.setattr(tracing, "_capturing", lambda: capturing[0])

    def body(state, counted=counted):  # no closure: the block takes a key
        n, _ = state
        for group, fields, k in counted:
            tracing.count(group, *fields, n=k)
        return n + 1, n + 1 >= 10**9

    def record(fn, device, pool=None):
        capturing[0] = True
        try:
            fn()
        finally:
            capturing[0] = False
        return lambda: None

    def reading(store):
        return [getattr(getattr(store, group), f) for group, fields, _ in counted for f in fields]

    monkeypatch.setattr(_common, "_record", record)
    before = reading(tracing.recorded), reading(tracing.totals)
    state = (torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.bool))
    start = _counts()
    _common.run_bodies(body, state, 96, Context())
    assert _delta(start)[2:] == (1, 2, 64)  # a warm-up block, its capture, two replays
    per_body = [k for _, fields, k in counted for _ in fields]
    assert [a - b for a, b in zip(reading(tracing.recorded), before[0])] == [32 * k for k in per_body]
    assert [a - b for a, b in zip(reading(tracing.totals), before[1])] == [96 * k for k in per_body]


def test_emulated_chebyshev_applications_counted_as_on_the_eager_route(emulated, monkeypatch):
    """pcg with Chebyshev(6) over 96 steps: the emulated graph route counts
    the applications the eager route counts, one a body and the start's,
    none fused off the card."""
    A = _system()
    M = chebyshev(A, 6)
    b = _rhs(A, 3)
    applied = tracing.totals.cheb_apply
    got = []
    for route in ("graph", "eager"):
        with monkeypatch.context() as m:
            if route == "eager":
                m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
            before = (applied.calls, applied.fused, tracing.totals.eager_graph.replays)
            solvers.pcg_kernel(A, b, torch.zeros_like(b), M=M, tol=0.0, maxiter=96)
            got.append((applied.calls - before[0], applied.fused - before[1],
                        tracing.totals.eager_graph.replays - before[2]))
    assert got == [(97, 0, 2), (97, 0, 0)]


@pytest.mark.parametrize("precond", ["none", "chebyshev(6)"])
@pytest.mark.parametrize("batch", [None, 4])
def test_emulated_pcg_body_counted_through_replays(emulated, monkeypatch, precond, batch):
    """pcg's body on its steps (torch's passes: the route declines on the
    CPU, and the state carries no scratch) over 96 steps, two requests on
    one key: the emulated graph route equals the eager route bit for bit,
    one capture, and every body, replayed ones too, counts in
    ``pcg_body.calls`` and none in ``fused``."""
    A = _system(16)
    M = chebyshev(A, 6) if precond != "none" else None
    bs = [_rhs(A, seed, batch) for seed in (5, 6)]
    bodies = tracing.totals.pcg_body
    got, moved = [], []
    for route in ("graph", "eager"):
        with monkeypatch.context() as m:
            if route == "eager":
                m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
            before = (bodies.calls, bodies.fused), _counts()
            got.append([solvers.pcg_kernel(A, b, torch.zeros_like(b), M=M, tol=0.0, maxiter=96) for b in bs])
            moved.append((bodies.calls - before[0][0], bodies.fused - before[0][1], _delta(before[1])[2]))
    for g, e in zip(*got):
        _same(g, e)
    assert moved == [(192, 0, 1), (192, 0, 0)]


def test_emulated_new_operator_is_captured_anew(emulated):
    """A new operator object of the same shape (and one changed in place)
    is a new key: it never replays the block of another."""
    b = _rhs(_system(), 1)
    A1 = _system()
    solvers.cg_kernel(A1, b, torch.zeros_like(b), tol=0.0, maxiter=96)
    A2 = fixtures.laplace2d(24, constant=True, dtype=torch.float64)
    A2.coef.mul_(2.0)
    before = _counts()
    got = solvers.cg_kernel(A2, b, torch.zeros_like(b), tol=0.0, maxiter=96)
    assert _delta(before)[2] == 1
    with torch.no_grad():
        A1.coef.mul_(2.0)  # A1 now equals A2; its in-place change is a new key
    before = _counts()
    again = solvers.cg_kernel(A1, b, torch.zeros_like(b), tol=0.0, maxiter=96)
    assert _delta(before)[2] == 1
    assert torch.equal(got.x, again.x)


def test_emulated_freed_operator_drops_its_block(emulated, monkeypatch):
    """A block holds its operators weakly: freeing the operator drops it.
    (The captured replay here holds nothing, as a CUDA graph holds no
    Python object; the emulated one holds the body and its operator.)"""
    monkeypatch.setattr(_common, "_record", lambda fn, device, pool=None: lambda: None)
    A = _system()
    b = _rhs(A, 1)
    solvers.cg_kernel(A, b, torch.zeros_like(b), tol=0.0, maxiter=96)
    assert len(emulated) == 1
    del A
    assert len(emulated) == 0


def test_emulated_cache_is_bounded(emulated):
    """At most ``GRAPHS_KEPT`` blocks, the least recently used dropped."""
    b = _rhs(_system(8), 1)
    kept = [fixtures.laplace2d(8, constant=True, dtype=torch.float64) for _ in range(_common.GRAPHS_KEPT + 2)]
    for A in kept:
        solvers.cg_kernel(A, b, torch.zeros_like(b), tol=0.0, maxiter=96)
    assert len(emulated) == _common.GRAPHS_KEPT


def test_a_tensor_in_the_closure_is_refused(emulated):
    """A body that reads a request's tensor from its closure would replay
    the capture's tensor: the runner refuses it."""
    step = torch.ones(())

    def body(state):
        n, _ = state
        return n + step, n > 10**9

    with pytest.raises(TypeError, match="closure"):
        _common.run_bodies(body, (torch.zeros(()), torch.zeros((), dtype=torch.bool)), 64, Context())


@pytest.mark.parametrize("method", ["cg", "mrr", "kskipcg"])
def test_emulated_chunked_solve_equals_eager(emulated, monkeypatch, method):
    """``solve(chunk_iters=)`` through the emulated graph route: each chunk
    resumes from the last one's carry, as on the eager route."""
    A = _system()
    b = _rhs(A, 3)
    kw = dict(method=method, tol=1e-12, maxiter=400, chunk_iters=70, **({"k": 1} if method == "kskipcg" else {}))
    x, info = krylov_tpu_torch.solve(A, b, **kw)
    with monkeypatch.context() as m:
        m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
        x_e, info_e = krylov_tpu_torch.solve(A, b, **kw)
    assert torch.equal(x, x_e)
    assert info["chunks"] == info_e["chunks"] >= 2
    assert info["iterations"] == info_e["iterations"]
    np.testing.assert_array_equal(info["residual"], info_e["residual"])


def _advection():
    """The non-normal 16x16 advection-like stencil of tests/test_kernels.py
    (grid-coefficient form): the adaptive guard rolls back on it."""
    from krylov_tpu_torch.sparse import StencilMatrix

    g, eps = (16, 16), 0.5
    iy, ix = np.arange(g[0])[:, None], np.arange(g[1])[None, :]
    coef = np.stack([-(1 + eps) * np.broadcast_to(iy > 0, g), -(1 + eps) * np.broadcast_to(ix > 0, g),
                     np.full(g, 4.5), -(1 - eps) * np.broadcast_to(ix < g[1] - 1, g),
                     -(1 - eps) * np.broadcast_to(iy < g[0] - 1, g)]).astype(np.float64)
    return StencilMatrix(torch.from_numpy(coef), ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), g)


# the adaptive loop's cases: (system, k, batch); on the advection stencil
# the guard rolls back, and a batch's members then step at different k
ADAPTIVE = {
    "laplace k=2": (lambda: _system(), 2, None),
    "laplace k=2 batch": (lambda: _system(), 2, 3),
    "advection k=6": (_advection, 6, None),
    "advection k=6 batch": (_advection, 6, 3),
}


def _same_adaptive(a, b):
    _same(a, b)
    assert torch.equal(a.nosl_trace, b.nosl_trace) and torch.equal(a.k_trace, b.k_trace)
    assert torch.equal(a.final_k, b.final_k)


@pytest.mark.parametrize("case", sorted(ADAPTIVE))
def test_emulated_adaptive_steps_equal_eager(emulated, monkeypatch, case):
    """The adaptive loop's steps through the emulated graph route, three
    requests on one operator (a key's first step warms up, its second is
    captured, the rest replay; a rollback's half-step runs eagerly between
    them) against the eager route, bit for bit, with the same bodies (one
    an outer iteration) and reads; every step after a key's first is a
    replay, and no result aliases the graphs' static buffers."""
    make, k, batch = ADAPTIVE[case]
    A = make()
    bs = [_rhs(A, seed) if batch is None else torch.stack([_rhs(A, seed + j) for j in range(batch)])
          for seed in (1, 2, 5)]
    kw = dict(k=k, tol=1e-10, maxiter=400)
    before = _counts()
    graph = [solvers.adaptivekskipmrr_kernel(A, b, torch.zeros_like(b), **kw) for b in bs]
    on_graph = _delta(before)
    first_x = graph[0].x.clone()
    with monkeypatch.context() as m:
        m.setattr(_common, "step_route", lambda state: False)
        before = _counts()
        eager = [solvers.adaptivekskipmrr_kernel(A, b, torch.zeros_like(b), **kw) for b in bs]
        on_eager = _delta(before)
    for g, e in zip(graph, eager):
        _same_adaptive(g, e)
    assert torch.equal(graph[0].x, first_x)
    captured = [block for block in emulated.values() if block.replay is not None]
    assert all(g.x is not t for g in graph for block in captured for t in block.static)
    assert on_graph[:2] == on_eager[:2] and on_eager[2:] == (0, 0, 0)
    captures, replays, bodies = on_graph[2:]
    assert len(captured) >= 1 and replays == bodies
    # the eager steps of the graph route are each key's first, and each
    # key is captured once, unless a full cache dropped it and it came back
    warm_ups = on_graph[0] - replays
    if len(emulated) < _common.GRAPHS_KEPT:
        assert (warm_ups, captures) == (len(emulated), len(captured))
    else:
        assert warm_ups >= len(emulated) and captures >= len(captured)
    if case.startswith("advection"):
        assert all(bool((e.final_k < k).all()) for e in eager)


def test_emulated_step_replays_add_what_the_capture_recorded(emulated, monkeypatch):
    """A step's counts (here K1's launches and the all-reduces): its
    capture moves only ``tracing.recorded``, and each replay adds what it
    recorded to ``tracing.totals``, with one body and one replay."""
    capturing = [False]
    monkeypatch.setattr(tracing, "_capturing", lambda: capturing[0])

    def body(state):  # no closure: the step takes a key
        tracing.count("stencil_matvec_2d", "launches", n=3)
        tracing.count("collectives", n=2)
        return (state[0] + 1,)

    def record(fn, device, pool=None):
        capturing[0] = True
        try:
            fn()
        finally:
            capturing[0] = False
        return lambda: None

    monkeypatch.setattr(_common, "_record", record)
    totals = tracing.totals
    before = (totals.stencil_matvec_2d.launches, totals.collectives.calls, _counts())
    state = (torch.zeros(()),)
    for _ in range(5):  # a warm-up, then a capture and four replays
        state = _common.replay_step(body, state)
    assert (totals.stencil_matvec_2d.launches - before[0], totals.collectives.calls - before[1]) == (15, 10)
    assert _delta(before[2]) == (5, 0, 1, 4, 4)


def test_emulated_step_state_outlives_the_next_replay(emulated):
    """What a replayed step returns is the caller's own: the key's next
    replay, another request's between two of this one's steps, leaves it
    as it was, and the request carries on from its own state."""

    def body(state):  # no closure: the step takes a key
        return (state[0] * 2 + 1,)

    mine = (torch.zeros(3),)
    for _ in range(3):  # a warm-up, the capture and a replay
        mine = _common.replay_step(body, mine)
    kept = mine[0].clone()
    theirs = _common.replay_step(body, (torch.full((3,), 100.0),))
    assert torch.equal(mine[0], kept) and torch.equal(theirs[0], torch.full((3,), 201.0))
    assert torch.equal(_common.replay_step(body, mine)[0], kept * 2 + 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, for the rule alone."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return t.as_subclass(_OnCard)


def test_engagement_rule(monkeypatch):
    """The rule engages on a state on the card, a single-process context, a
    stream not capturing and at least 32 steps; it declines a CPU state, a
    CPU scalar beside a state on the card (a capture would bake its value
    in), a context with a process group (the sharded loops' collectives stay
    eager), a stream already capturing and fewer than 32 steps."""
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    conv = _on_card(torch.zeros((), dtype=torch.bool))
    card = (1e-5, _on_card(torch.zeros(())), conv)
    assert _common.graph_route(Context(), card, SYNC)
    assert not _common.graph_route(Context(), (torch.zeros(()), torch.zeros((), dtype=torch.bool)), 1000)
    assert not _common.graph_route(Context(), (torch.full((), 1e-5), conv), 1000)
    assert not _common.graph_route(Context(axis="rows", group=object()), card, 1000)
    assert not _common.graph_route(Context(), card, SYNC - 1)
    capturing[0] = True
    assert not _common.graph_route(Context(), card, 1000)


def test_pipelined_cg_keeps_its_own_loop(monkeypatch):
    """``pipelined_cg`` reads its residual replacement from the host's step
    (every 25 steps, which 32 does not divide): it never asks the runner,
    while ``pcg`` does."""
    asked = []
    monkeypatch.setattr(_common, "graph_route", lambda ctx, state, steps: asked.append(steps) or False)
    A = _system(12)
    b = _rhs(A, 1)
    solvers.pipelined_cg_kernel(A, b, torch.zeros_like(b), tol=1e-10, maxiter=100, M=jacobi(A))
    assert asked == []
    solvers.pcg_kernel(A, b, torch.zeros_like(b), tol=1e-10, maxiter=100, M=jacobi(A))
    assert asked == [100]


def test_host_read_raises_while_the_stream_captures(monkeypatch):
    """A host read inside a capture would not be replayed: ``host_read``
    raises when the current stream reports capturing, and so does a
    loop's read there."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        tracing.host_read()
    with pytest.raises(RuntimeError, match="capture"):
        _common.synced_done(SYNC - 1, torch.ones((), dtype=torch.bool))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with tracing.host_read():
        pass


def test_emulated_object_not_held_weakly_runs_eagerly(emulated):
    """An object in the body's closure that cannot be held weakly gives the
    block no key: the loop runs eagerly, on the eager schedule."""
    token = object()

    def body(state):
        n, _ = state
        assert token is not None
        n = n + 1
        return n, n > 10**9

    before = _counts()
    n, _ = _common.run_bodies(body, (torch.zeros(()), torch.zeros((), dtype=torch.bool)), 96, Context())
    assert float(n) == 96 and _delta(before) == (96, 3, 0, 0, 0) and len(emulated) == 0


def test_a_body_that_moves_a_state_entry_is_refused(emulated):
    """A block ends by copying each new entry into its own static slot; a
    body that returns one entry of its state in another's slot would be
    copied over before it is read: the runner refuses it."""

    def body(state):
        a, b, c, _ = state
        return b, c, a, a > 10**9  # a rotation: after 32 bodies, still rotated

    state = (torch.zeros(()), torch.ones(()), torch.full((), 2.0), torch.zeros((), dtype=torch.bool))
    with pytest.raises(ValueError, match="another slot"):
        _common.run_bodies(body, state, 96, Context())


class _Damped:
    """A user's preconditioner, duck-typed and mutable: ``omega * v``."""

    def __init__(self, omega):
        self.omega = omega
        self.shape = None

    def matvec(self, v):
        return self.omega * v


@pytest.mark.parametrize("make", ["duck-typed", "chebyshev over a duck-typed operator"])
def test_emulated_operator_of_another_kind_runs_eagerly(emulated, monkeypatch, make):
    """An operator in a body's closure that is not one of the package's own
    frozen containers or preconditioners, here a user's ``M`` whose scalar
    changes between requests (directly, or under a Chebyshev
    preconditioner): the loop has no key and runs eagerly, so each request
    reads the ``M`` it is given, as on the eager route."""
    A = _system()
    b = _rhs(A, 4)
    damped = _Damped(0.25)
    M = damped if make == "duck-typed" else chebyshev(_Damped(1.0), 2, lmin=0.5, lmax=2.0)
    got = []
    before = _counts()
    for omega in (0.25, 0.5):
        damped.omega = omega
        got.append(solvers.pcg_kernel(A, b, torch.zeros_like(b), tol=0.0, maxiter=96, M=M))
    assert _delta(before)[2:] == (0, 0, 0) and len(emulated) == 0
    with monkeypatch.context() as m:
        m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
        for omega, g in zip((0.25, 0.5), got):
            damped.omega = omega
            _same(g, solvers.pcg_kernel(A, b, torch.zeros_like(b), tol=0.0, maxiter=96, M=M))


def test_fingerprint_follows_the_package_operators():
    """A key holds each field of a package operator: a plain value, a
    tensor's identity and version, or a nested operator's fingerprint."""
    A = _system(8)
    M = chebyshev(A, 3)
    first = _common._fingerprint(M)
    assert first == _common._fingerprint(M) and first is not None
    object.__setattr__(M, "lmax", M.lmax * 2)  # a frozen field rebound
    assert _common._fingerprint(M) != first
    second = _common._fingerprint(M)
    with torch.no_grad():
        A.coef.mul_(2.0)  # the nested operator changed in place
    assert _common._fingerprint(M) != second
    assert _common._fingerprint(_Damped(1.0)) is None
    assert _common._fingerprint(Context()) is None


def test_emulated_block_in_use_runs_eagerly(emulated):
    """A request whose block another thread's request holds, or that would
    capture while another thread captures, runs eagerly and touches
    neither the block's static state nor its graph."""
    A = _system()
    bs = [_rhs(A, seed) for seed in (6, 7)]
    want = solvers.cg_kernel(A, bs[0], torch.zeros_like(bs[0]), tol=0.0, maxiter=96)
    (block,) = emulated.values()
    static = [t.clone() for t in block.static if isinstance(t, torch.Tensor)]
    with block.busy:
        before = _counts()
        got = solvers.cg_kernel(A, bs[1], torch.zeros_like(bs[1]), tol=0.0, maxiter=96)
        assert _delta(before)[2:] == (0, 0, 0)
    kept = [t for t in block.static if isinstance(t, torch.Tensor)]
    assert all(torch.equal(u, v) for u, v in zip(static, kept))
    again = solvers.cg_kernel(A, bs[1], torch.zeros_like(bs[1]), tol=0.0, maxiter=96)
    _same(got, again)
    assert not torch.equal(got.x, want.x)
    A2 = _system()
    with _common._CAPTURE:
        before = _counts()
        solvers.cg_kernel(A2, bs[1], torch.zeros_like(bs[1]), tol=0.0, maxiter=96)
        assert _delta(before)[2:] == (0, 0, 0)


def test_emulated_key_names_the_stream(emulated, monkeypatch):
    """Requests on two streams never share a block: each stream's key has
    its own graph and static state, so the copies of one never overwrite
    the state another stream still reads."""
    A = _system()
    b = _rhs(A, 8)
    for handle in (1, 2, 1):
        stream = _Stream()
        stream.cuda_stream = handle
        monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, s=stream: s)
        solvers.cg_kernel(A, b, torch.zeros_like(b), tol=0.0, maxiter=96)
    assert len(emulated) == 2 and tracing.totals.eager_graph.captures >= 2
    assert sorted(key[2] for key in emulated) == [1, 2]
