"""krylov_tpu_torch.tracing: the spans' totals and host-read counters, and
their annotations under torch.profiler, on the CPU.

A span adds its total and self nanoseconds and one call to its totals; it
builds no profiler annotation unless a profiler records; under one, the
spans of a solve nest on one thread inside their request and carry its id.
The front door and the eager loops count each device-to-host read
(``host_read``) and each loop body (``eager_bodies``): a fused MrR reads
once (the ``b = 0`` test), ``restarts=1`` once more (the restart
decision), an eager loop once more a 32-body block.
"""

import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu_torch import tracing
from krylov_tpu_torch.sparse import fixtures

TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


def _system(n=16, seed=0):
    A = fixtures.laplace2d(n, constant=True)
    b = torch.from_numpy(np.random.default_rng(seed).standard_normal(A.shape[0]))
    return A, b


def _calls() -> dict:
    return {name: getattr(tracing.totals, name).calls for name in tracing.NAMES}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


def _fields(name: str) -> tuple:
    t = getattr(tracing.totals, name)
    return t.calls, t.total_ns, t.self_ns, t.read_ns


def test_nested_spans_add_total_self_and_read_ns(monkeypatch):
    """On a clock that ticks 10 ns a reading: ``solve`` (0..70) holds
    ``plan`` (10..40, holding a host read 20..30) and a host read (50..60)."""
    ticks = iter(range(0, 1000, 10))
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    before = {name: _fields(name) for name in ("solve", "plan", "host_read")}
    with tracing.span("solve"):
        with tracing.span("plan"):
            with tracing.host_read():
                pass
        with tracing.host_read():
            pass
    got = {name: tuple(a - b for a, b in zip(_fields(name), before[name])) for name in before}
    assert got["host_read"] == (2, 20, 20, 0)
    assert got["plan"] == (1, 30, 20, 10)
    assert got["solve"] == (1, 70, 30, 20)


def test_a_span_ends_on_an_exception_and_keeps_its_stack():
    before = _fields("plan")[0]
    with pytest.raises(ValueError):
        with tracing.span("plan"):
            raise ValueError("inside")
    assert _fields("plan")[0] == before + 1
    assert tracing._state.stack == []


def test_no_profiler_no_annotation(monkeypatch):
    """Without a profiler a span, and a whole solve, builds no annotation."""
    def refuse(*args, **kwargs):
        raise AssertionError("an annotation was built with no profiler running")

    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter", refuse)
    monkeypatch.setattr(torch.profiler.record_function, "__init__", refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    A, b = _system()
    with tracing.request("solve_device"):
        with tracing.host_read():
            pass
    for kw in (dict(method="mrr", restarts=1), dict(method="pcg")):
        assert bool(krylov_tpu_torch.solve_device(A, b, tol=TOL, **kw).converged)


def _krylov_events(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("krylov.")]


def test_profiled_solve_nests_its_spans_in_one_request():
    """Under torch.profiler (record_shapes, so an annotation keeps its
    argument), one solve_device: ``krylov.solve_device`` holds
    ``krylov.plan``, ``krylov.host_read`` and ``krylov.run_fused`` inside its
    interval, on its thread, all with its request id; a second call has
    another id."""
    from torch.profiler import ProfilerActivity, profile

    A, b = _system()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        krylov_tpu_torch.solve_device(A, b, method="mrr", tol=TOL)
        krylov_tpu_torch.solve_device(A, b, method="mrr", tol=TOL)
    events = _krylov_events(prof)
    roots = sorted((e for e in events if e.name() == "krylov.solve_device"), key=lambda e: e.start_ns())
    assert len(roots) == 2
    ids = []
    for root in roots:
        t0, t1 = root.start_ns(), root.start_ns() + root.duration_ns()
        inside = [e for e in events if e is not root and t0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= t1]
        assert {e.name() for e in inside} == {"krylov.plan", "krylov.host_read", "krylov.run_fused"}
        assert {e.start_thread_id() for e in inside} == {root.start_thread_id()}
        assert all(e.is_user_annotation() for e in inside + [root])
        (rid,) = {tuple(e.concrete_inputs()) for e in inside + [root]}
        ids.append(rid)
    assert ids[0] != ids[1] and all(isinstance(r[0], int) and r[0] > 0 for r in ids)


def test_request_ids_nest_and_restore():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with tracing.request("solve"):
            with tracing.span("plan"):
                pass
            with tracing.request("solve"):
                with tracing.span("plan"):
                    pass
            with tracing.span("restarts"):
                pass
    ev = sorted(_krylov_events(prof), key=lambda e: e.start_ns())
    ids = [(e.name(), e.concrete_inputs()[0]) for e in ev]
    outer, _, inner, inner_plan, last = ids
    assert outer[1] == ids[1][1] == last[1] != inner[1] == inner_plan[1]
    assert tracing._state.request == 0


@pytest.mark.parametrize("kw, reads", [
    (dict(method="mrr"), 1),  # the b = 0 test; the fused route reads nothing else
    (dict(method="mrr", restarts=1), 2),  # and the restart decision
    (dict(method="cg"), 1),
])
def test_fused_route_host_reads(kw, reads):
    A, b = _system()
    before = _calls()
    res = krylov_tpu_torch.solve_device(A, b, tol=TOL, **kw)
    got = _delta(before)
    assert bool(res.converged)
    assert got["host_read"] == reads
    # a restart solves the defect only while the true residual is at or above tol
    assert got["run_fused"] in ((1,) if reads == 1 else (1, 2))
    assert got["solve_device"] == 1 and got["plan"] == 1
    assert "eager_bodies" not in got and "eager_loop" not in got
    assert got.get("restarts", 0) == kw.get("restarts", 0)


# (method, kwargs, the loop step at which a member that took `i` iterations
# is first seen converged)
EAGER = [
    ("pcg", {}, lambda i: i),
    ("pcg", {"M": "jacobi"}, lambda i: i),
    ("cg", {"fused": False}, lambda i: i),
    ("mrr", {"fused": False}, lambda i: i - 1),  # the half-iteration counts one
]


@pytest.mark.parametrize("method, kw, first", EAGER)
@pytest.mark.parametrize("n", [12, 16])
def test_eager_loop_reads_once_a_block_and_counts_its_bodies(method, kw, first, n):
    """An eager loop reads convergence once every SYNC_EVERY = 32 bodies and
    stops at the first read that finds it: ``1 + first // 32`` reads and
    ``32 (first // 32 + 1)`` bodies, besides the front door's one read."""
    A, b = _system(n)
    if kw.get("M") == "jacobi":
        kw = dict(kw, M=krylov_tpu_torch.precond.jacobi(A))
    before = _calls()
    res = krylov_tpu_torch.solve_device(A, b, method=method, tol=TOL, **kw)
    got = _delta(before)
    blocks = first(int(res.iterations)) // 32 + 1
    assert bool(res.converged)
    assert got["host_read"] == 1 + blocks
    assert got["eager_bodies"] == 32 * blocks
    assert got["eager_loop"] == 1 and "run_fused" not in got


def test_eager_loop_span_keeps_its_reads_apart(monkeypatch):
    """``eager_loop.read_ns`` holds the loop's own reads, not the front
    door's; ``solve_device.read_ns`` holds both."""
    A, b = _system()
    ticks = iter(range(0, 10**9, 10))
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    before = {name: _fields(name) for name in ("solve_device", "eager_loop", "host_read")}
    res = krylov_tpu_torch.solve_device(A, b, method="pcg", tol=TOL)
    got = {name: tuple(a - c for a, c in zip(_fields(name), before[name])) for name in before}
    loop_reads = int(res.iterations) // 32 + 1
    assert got["host_read"][0] == 1 + loop_reads
    assert got["eager_loop"][3] == 10 * loop_reads  # one tick inside each read
    assert got["solve_device"][3] == got["host_read"][1] == 10 * (1 + loop_reads)


def test_batched_and_guarded_loops_count_their_reads():
    """solve_batched reads the batch's b = 0 flags once; the CA loop's guard
    reads once an outer iteration, one body each."""
    A, b = _system()
    B = torch.stack([b, 2 * b, torch.zeros_like(b)])
    before = _calls()
    res = krylov_tpu_torch.solve_batched(A, B, method="mrr", tol=TOL)
    got = _delta(before)
    assert bool(res.converged.all())
    assert got["solve_batched"] == 1 and got["host_read"] == 1 and got["run_fused"] == 2
    before = _calls()
    res = krylov_tpu_torch.solve_device(A, b, method="cacg", k=4, tol=TOL, spectral_bounds=(0.01, 8.0))
    got = _delta(before)
    assert bool(res.converged)
    assert got["host_read"] == 1 + got["eager_bodies"] and got["eager_bodies"] >= int(res.index)


def test_solve_is_a_request_of_its_own():
    A, b = _system()
    before = _calls()
    x, info = krylov_tpu_torch.solve(A, b.numpy(), method="mrr", tol=TOL)
    got = _delta(before)
    assert info["converged"]
    assert got["solve"] == 1 and "solve_device" not in got and got["plan"] == 1 and got["host_read"] == 1


def test_scalar_on_counts_a_host_numbers_copy_to_the_card(monkeypatch):
    """A host number copied to a CUDA device is a read (torch synchronises
    the stream for it); a tensor, or a copy to the CPU, is not."""
    before = _calls()["host_read"]
    t = tracing.scalar_on(0.5, torch.float64, torch.device("cpu"))
    tracing.scalar_on(t, torch.float32, "cpu")
    assert _calls()["host_read"] == before and t.dtype == torch.float64 and float(t) == 0.5
    copies = []
    monkeypatch.setattr(torch, "as_tensor", lambda v, dtype, device: copies.append((v, dtype, device)) or t)
    assert tracing.scalar_on(1e-5, torch.float64, torch.device("cuda", 0)) is t
    assert _calls()["host_read"] == before + 1 and copies == [(1e-5, torch.float64, torch.device("cuda", 0))]
    tracing.scalar_on(t, torch.float64, torch.device("cuda", 0))
    assert _calls()["host_read"] == before + 1


def test_all_reduce_and_halo_spans(tmp_path):
    """mesh= in a gloo world of one (in this process, destroyed after):
    each collective is an ``all_reduce`` span and each sharded SpMV a
    ``halo`` span, as many as the counters the benchmark already reads."""
    import torch.distributed as dist

    from krylov_tpu_torch import context
    from krylov_tpu_torch.dist import make_mesh, spmv

    A, b = _system()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = make_mesh("cpu")
        before, reduces, matvecs = _calls(), context.all_reduce.calls, spmv.sharded_matvec.calls
        res = krylov_tpu_torch.solve_device(A, b, method="cg", tol=TOL, mesh=mesh)
        got = _delta(before)
    finally:
        dist.destroy_process_group()
    assert bool(res.converged)
    assert got["all_reduce"] == context.all_reduce.calls - reduces > 0
    assert got["halo"] == spmv.sharded_matvec.calls - matvecs > 0
    assert got["host_read"] >= 2 and got["eager_loop"] == 1


def _reading(store, group: str) -> dict:
    return dict(vars(getattr(store, group)))


def test_a_count_outside_a_capture_lands_in_totals(monkeypatch):
    """Off a capture a count adds to ``totals`` (``calls`` without a field)
    and leaves ``recorded`` as it was; with CUDA not initialised it asks
    CUDA nothing."""
    def refuse():
        raise AssertionError("a CUDA call before CUDA is initialised")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", refuse)
    before = {store: _reading(getattr(tracing, store), "cheb_apply") for store in ("totals", "recorded")}
    tracing.count("cheb_apply")
    tracing.count("cheb_apply", "calls", "fused", n=3)
    assert _reading(tracing.totals, "cheb_apply") == {"calls": before["totals"]["calls"] + 4,
                                                      "fused": before["totals"]["fused"] + 3}
    assert _reading(tracing.recorded, "cheb_apply") == before["recorded"]


def test_a_count_under_a_capture_lands_in_recorded(monkeypatch):
    """While the current stream captures, a count adds to ``recorded``
    alone: what a replay of the graph will run."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    before = {store: _reading(getattr(tracing, store), "stencil_matvec_2d") for store in ("totals", "recorded")}
    tracing.count("stencil_matvec_2d", "launches", n=2)
    assert _reading(tracing.recorded, "stencil_matvec_2d") == {"launches": before["recorded"]["launches"] + 2}
    assert _reading(tracing.totals, "stencil_matvec_2d") == before["totals"]


def test_a_group_the_runner_never_names_is_credited_once_a_replay(monkeypatch):
    """An emulated graph route (its streams no-ops, a capture that runs the
    block once as capturing and a replay that runs nothing): a fused
    wrapper's group, which the block runner never names, counted by the
    body, is recorded once a body at the capture and credited to
    ``totals`` once a replay, as if each replayed body had counted it."""
    import contextlib

    from krylov_tpu_torch.context import Context
    from krylov_tpu_torch.solvers import _common

    stream = type("Stream", (), {"cuda_stream": 0, "wait_stream": lambda self, other: None})()
    capturing = [False]

    def record(fn, device, pool=None):
        capturing[0] = True
        try:
            fn()
        finally:
            capturing[0] = False
        return lambda: None

    monkeypatch.setattr(_common, "graph_route", lambda ctx, state, steps: True)
    monkeypatch.setattr(_common, "_record", record)
    monkeypatch.setattr(_common, "_side_stream", lambda device: stream)
    monkeypatch.setattr(_common, "_BLOCKS", type(_common._BLOCKS)())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "_capturing", lambda: capturing[0])
    assert "fused_kskipcg" not in open(_common.__file__).read()

    def body(state):
        n, _ = state
        tracing.count("fused_kskipcg_solve_2d", "launches", "streaming")
        return n + 1, n + 1 >= 10**9

    group = "fused_kskipcg_solve_2d"
    before = _reading(tracing.totals, group), _reading(tracing.recorded, group)
    graph = tracing.totals.eager_graph.replays
    state = (torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.bool))
    _common.run_bodies(body, state, 32 * 5 + 3, Context())
    replays = tracing.totals.eager_graph.replays - graph
    ran, recorded = _reading(tracing.totals, group), _reading(tracing.recorded, group)
    assert replays == 4  # a warm-up block, its capture, four replays, the tail
    for field in ("launches", "streaming"):
        assert recorded[field] - before[1][field] == 32
        assert ran[field] - before[0][field] == 32 + 32 * replays + 3
    assert ran["resident"] == before[0]["resident"]


def test_fused_groups_hold_every_route_and_pass():
    """Each fused wrapper's group has a field for each route and for each
    stencil pass a launch can name on it (K4's specialisations and the
    masked pass)."""
    from krylov_tpu_torch.kernels import fused

    for name in ("fused_cg_solve_2d", "fused_mrr_solve_2d", "fused_kskipcg_solve_2d", "fused_kskipmrr_solve_2d"):
        fields = set(vars(getattr(tracing.totals, name)))
        assert fields == set(vars(getattr(tracing.recorded, name)))
        assert {"launches", "resident", "streaming"} <= fields
        assert {f"{route}_ns{ns}" for route in ("resident", "streaming") for ns in (0, *fused.PASS_TERMS)} <= fields
