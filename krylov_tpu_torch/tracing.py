"""Spans and host-read counters of the port's host work.

A :class:`span` times a stretch of host work on the host's clock
(``time.perf_counter_ns``) and adds, when it ends, to ``totals.<name>``:

- ``calls``: one;
- ``total_ns``: its nanoseconds;
- ``self_ns``: its nanoseconds less those of the spans opened inside it;
- ``read_ns``: the nanoseconds of the :func:`host_read` spans inside it,
  at any depth.

Only while a ``torch.profiler`` session records does a span also open a
user annotation ``krylov.<name>``, with the id of its request
(:class:`request`) as its one argument: a trace recorded with
``record_shapes=True`` shows the id as the annotation's ``Concrete
Inputs``.  The annotations nest as the spans ran, on the clock of the
trace's device activity.  With no profiler a span makes no annotation: two
clock reads and a few additions.

The spans of the solve path:

- ``solve_device``, ``solve``, ``solve_batched``: the entry points, each
  call a new request id;
- ``plan``: the options checked; operator, ``b`` and ``x0`` put on the
  device; the route chosen;
- ``run_fused``: the front door of the whole-solve kernels (``b``'s norm,
  the ``x0`` shift, the 2-D collapse, the result);
- ``launch``: a whole-solve kernel's launch on the card (plan, workspace,
  scalars, the C call);
- ``restarts``: the defect corrections of ``restarts=`` (their inner
  solves nest as ``run_fused`` or ``eager_loop``);
- ``eager_loop``: one call of an eager loop;
- ``host_read``: a call that waits for the card: a device-to-host read
  (the front door's ``b = 0`` test, on a mesh too, the restart decision,
  an eager loop's convergence read every ``SYNC_EVERY`` bodies, the
  adaptive k-skip and CA guards, K1's weights on a cache miss, the Lanczos
  bounds of the CA methods), or a host number's copy to the card
  (:func:`scalar_on`: ``tol`` at a whole-solve launch, at ``restarts=``,
  at a k-skip loop's start); ``calls`` counts them.  ``solve``'s ``info``
  and ``refine=`` read the result after the solve, outside these;
- ``all_reduce``, ``halo``: a collective and a sharded SpMV's exchange.

``totals.eager_bodies.calls`` counts the eager loop bodies run, frozen
ones included, those replayed in a CUDA graph too.  ``totals.eager_graph``
counts the graph route of :func:`krylov_tpu_torch.solvers._common.run_bodies`:
``captures`` (blocks of ``SYNC_EVERY`` bodies captured), ``replays`` and
``bodies`` (the bodies run inside replays).  ``totals.cheb_apply`` counts
the Chebyshev preconditioner's applications: ``calls``, and ``fused`` those
on the Chebyshev step; an application recorded into a CUDA graph counts
in ``captured`` (``captured_fused``) instead, and each replay of the graph
adds it to ``calls`` (``fused``).  The totals are plain
integers, cumulative from import; read the difference of two readings.  The spans keep their stack per
thread; the totals are shared and not locked.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
import types

import torch

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


class Total:
    """The totals of one span name (``eager_bodies``: ``calls`` alone)."""

    __slots__ = ("calls", "total_ns", "self_ns", "read_ns")

    def __init__(self):
        self.calls = self.total_ns = self.self_ns = self.read_ns = 0


class GraphTotal:
    """The totals of the eager loops' graph route (``eager_graph``)."""

    __slots__ = ("captures", "replays", "bodies")

    def __init__(self):
        self.captures = self.replays = self.bodies = 0


class ApplyTotal:
    """The totals of the Chebyshev preconditioner's applications
    (``cheb_apply``)."""

    __slots__ = ("calls", "fused", "captured", "captured_fused")

    def __init__(self):
        self.calls = self.fused = self.captured = self.captured_fused = 0


NAMES = ("solve_device", "solve", "solve_batched", "plan", "run_fused", "launch", "restarts", "eager_loop",
         "host_read", "all_reduce", "halo", "eager_bodies")
totals = types.SimpleNamespace(**{name: Total() for name in NAMES}, eager_graph=GraphTotal(),
                                cheb_apply=ApplyTotal())

_ids = itertools.count(1)


class _State(threading.local):
    def __init__(self):
        self.stack = []  # the open spans, innermost last
        self.request = 0  # id of the open request (0: none)


_state = _State()


class span:
    """Context manager: time the enclosed host work as ``name`` (one of
    :data:`NAMES`)."""

    __slots__ = ("name", "total", "t0", "child_ns", "read_ns", "handle")

    def __init__(self, name: str):
        self.name = name
        self.total = getattr(totals, name)

    def __enter__(self):
        self.child_ns = self.read_ns = 0
        self.handle = None
        if _profiling():
            self.handle = torch._C._autograd._record_function_with_args_enter(f"krylov.{self.name}",
                                                                                _state.request)
        _state.stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        ns = _clock() - self.t0
        stack = _state.stack
        stack.pop()
        t = self.total
        t.calls += 1
        t.total_ns += ns
        t.self_ns += ns - self.child_ns
        t.read_ns += self.read_ns
        if stack:
            parent = stack[-1]
            parent.child_ns += ns
            parent.read_ns += ns if t is totals.host_read else self.read_ns
        if self.handle is not None:
            torch._C._autograd._record_function_with_args_exit(self.handle)
        return False


class request(span):
    """The root span of one entry-point call: :class:`span` with a new
    request id, which the spans inside it carry."""

    __slots__ = ("outer",)

    def __enter__(self):
        self.outer = _state.request
        _state.request = next(_ids)
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        _state.request = self.outer
        return False


def host_read() -> span:
    """The span of one call that waits for the card.  Raises while the
    current CUDA stream captures a graph: a replay would not repeat the
    wait, so a read there is a fault of the captured code."""
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a host read inside a CUDA graph capture: the captured code must not wait for the card")
    return span("host_read")


def scalar_on(value, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)`` of a 0-d
    value.  Torch copies a host number to a CUDA device from pageable
    memory and synchronises the stream first, so the host waits there for
    the work queued before it: on a card that copy is a :func:`host_read`."""
    if isinstance(value, torch.Tensor) or torch.device(device).type != "cuda":
        return torch.as_tensor(value, dtype=dtype, device=device)
    with host_read():
        return torch.as_tensor(value, dtype=dtype, device=device)


def entry_point(fn):
    """``fn`` with each call inside a :class:`request` named after it."""
    name = fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with request(name):
            return fn(*args, **kwargs)

    return call
