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

The counters of the package are groups of plain integer fields in
``totals``, each group and field declared in :data:`GROUPS`:

- ``eager_bodies.calls``: the eager loop bodies run, frozen ones
  included, those replayed in a CUDA graph too;
- ``eager_graph``: the graph route of
  :func:`krylov_tpu_torch.solvers._common.run_bodies`: ``captures``
  (blocks of ``SYNC_EVERY`` bodies captured), ``replays`` and ``bodies``
  (the bodies run inside replays);
- ``cheb_apply``: the Chebyshev preconditioner's applications, ``calls``,
  and ``fused`` those on the Chebyshev step;
- ``pcg_body``: preconditioned CG's eager bodies, ``calls``, and
  ``fused`` those whose vector and scalar work ran on the kernels of
  :mod:`krylov_tpu_torch.kernels.pcg`;
- ``pcg_launches``: the launches of those four kernels, ``alpha``,
  ``xr``, ``ru`` and ``p``;
- ``stencil_matvec_2d.launches`` and ``chebyshev_apply.launches``: the
  launches of K1 and of the Chebyshev step;
- ``collectives.calls``: the all-reduces of a row-partitioned solve
  (:func:`krylov_tpu_torch.context.all_reduce`); ``sharded_matvec``: its
  SpMVs, ``calls``, and the bytes a rank received in them, ``halo_bytes``
  and ``gather_bytes`` (:func:`krylov_tpu_torch.dist.spmv.sharded_matvec`).
  Both functions read and set them as their attributes (:class:`counted`):
  ``all_reduce.calls``, ``sharded_matvec.halo_bytes``;
- ``fused_cg_solve_2d``, ``fused_mrr_solve_2d``, ``fused_kskipcg_solve_2d``
  and ``fused_kskipmrr_solve_2d``: the launches of each whole-solve
  wrapper (``launches``), by route (``resident``, ``streaming``), and by
  the stencil pass inside them (``resident_ns0``, ``_ns5``, ``_ns7``:
  K4's specialisation; ``streaming_ns0`` and so on: the streaming pass).

A count made while the current CUDA stream captures a graph goes to the
twin store ``recorded``, of the same shape, instead (:func:`count`): it
is recorded, not run.  :class:`recording` holds what a capture recorded
and :func:`credit` adds it to ``totals`` at each replay of the graph.
The totals are cumulative from import; read the difference of two
readings.  The spans keep their stack per thread; the totals are shared
and not locked.
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


NAMES = ("solve_device", "solve", "solve_batched", "plan", "run_fused", "launch", "restarts", "eager_loop",
         "host_read", "all_reduce", "halo", "eager_bodies")
_FUSED = ("launches", "resident", "streaming",
          *(f"{route}_ns{ns}" for route in ("resident", "streaming") for ns in (0, 5, 7)))
# every counter group and its fields: the spans' (and eager_bodies') totals,
# then the counts of what a CUDA graph capture can record
GROUPS = {
    **dict.fromkeys(NAMES, ("calls", "total_ns", "self_ns", "read_ns")),
    "eager_graph": ("captures", "replays", "bodies"),
    "cheb_apply": ("calls", "fused"),
    "pcg_body": ("calls", "fused"),
    "pcg_launches": ("alpha", "xr", "ru", "p"),
    "stencil_matvec_2d": ("launches",),
    "chebyshev_apply": ("launches",),
    "collectives": ("calls",),
    "sharded_matvec": ("calls", "halo_bytes", "gather_bytes"),
    **dict.fromkeys(("fused_cg_solve_2d", "fused_mrr_solve_2d", "fused_kskipcg_solve_2d",
                     "fused_kskipmrr_solve_2d"), _FUSED),
}


def _store() -> types.SimpleNamespace:
    return types.SimpleNamespace(**{group: types.SimpleNamespace(**dict.fromkeys(fields, 0))
                                    for group, fields in GROUPS.items()})


totals = _store()  # what ran
recorded = _store()  # what CUDA graph captures recorded


def _capturing() -> bool:
    """Whether the current CUDA stream captures a graph (no CUDA call
    before CUDA is initialised)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def count(group: str, *fields: str, n: int = 1) -> None:
    """Add ``n`` to each of ``fields`` (``calls`` without any) of
    ``totals.<group>``, or of ``recorded.<group>`` while the current
    stream captures a CUDA graph: a replay of the graph runs it then."""
    g = getattr(recorded if _capturing() else totals, group)
    for field in fields or ("calls",):
        setattr(g, field, getattr(g, field) + n)


def _reading(store) -> dict:
    return {(group, field): n for group, g in vars(store).items() for field, n in vars(g).items()}


class recording:
    """Context manager around a CUDA graph's capture: on its end
    ``counts`` holds what the capture recorded, ``(group, field, n)`` for
    each field it moved, which :func:`credit` adds at each replay."""

    __slots__ = ("before", "counts")

    def __enter__(self):
        self.before = _reading(recorded)
        return self

    def __exit__(self, *exc) -> bool:
        before = self.before
        self.counts = tuple((group, field, n - before[group, field])
                            for (group, field), n in _reading(recorded).items() if n != before[group, field])
        return False


def credit(counts: tuple) -> None:
    """Add a capture's :class:`recording` ``counts`` to ``totals``: what
    one replay of its graph runs."""
    for group, field, n in counts:
        g = getattr(totals, group)
        setattr(g, field, getattr(g, field) + n)


class counted:
    """``fn`` with the fields of ``totals.<group>`` as its attributes
    (``all_reduce.calls``, read and set as a function attribute), so that a
    CUDA graph's replays credit them as they credit every group."""

    def __init__(self, group: str, fn):
        vars(self).update(_group=group, __wrapped__=fn, __name__=fn.__name__, __doc__=fn.__doc__)

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    def __getattr__(self, field: str):
        return getattr(getattr(totals, self._group), field)

    def __setattr__(self, field: str, value) -> None:
        setattr(getattr(totals, self._group), field, value)


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
    if _capturing():
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
