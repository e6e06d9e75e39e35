"""Shared machinery for the eager solver loops.

The loops follow the JAX package's ``lax.while_loop`` solvers
(:mod:`krylov_tpu.solvers`): each body records ``residual[i]``, tests
convergence, computes the next state unconditionally and keeps the old state
once converged, so the reference's check-then-break order holds; a diverged
exit writes the final residual after the loop.

The convergence flag stays on the device.  The host reads it only every
:data:`SYNC_EVERY` iterations; the bodies run in between keep the frozen state
(and rewrite the same trace slot with the same value), so the result is the
same as a loop that stops at once.

:func:`run_bodies` drives a loop whose body is a function ``state ->
state``.  On the card it replays each block of :data:`SYNC_EVERY` bodies as
one captured CUDA graph where a capture pays back (a long solve, or an
operator that comes back; :func:`graph_route` and :func:`run_bodies` say
when), so a block costs one graph launch and its one read in place of some
thousands of launches made from Python; elsewhere it runs the bodies one by
one.  Both routes launch the same kernels in the same order, so they give
the same bits.  :func:`replay_step` does the same for one step of a loop
whose host reads each step's result (the adaptive k-skip loop's outer
iteration and its guard), a row-partitioned loop's included: its
all-reduces and halo exchanges are captured with the step.

The helpers take a leading batch axis (vectors ``(batch, n)``, scalars and
counters ``(batch,)``, traces ``(batch, L)``), so a loop written for one
system runs a batch as a ``vmap``-ped ``lax.while_loop`` does: every member
keeps its own counters, trace slot and convergence flag, and freezes on its
own.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Optional

import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.precond import ChebyshevPreconditioner
from krylov_tpu_torch.sparse.formats import _CONTAINERS

SYNC_EVERY = 32
# captured blocks kept, least recently used dropped first (each holds its
# graph's memory pool and one copy of its loop's state)
GRAPHS_KEPT = 8


def bcast(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``s`` (a scalar per batch member) with trailing unit axes up to
    ``v``'s rank, so it broadcasts over each member's vector."""
    return s if s.ndim == 0 else s.reshape(s.shape + (1,) * (v.ndim - s.ndim))


def tree_select(pred: torch.Tensor, on_true, on_false) -> tuple:
    """``torch.where(pred, a, b)`` leaf by leaf over two tuples (``pred`` is
    a bool per batch member)."""
    return tuple(torch.where(bcast(pred, a), a, b) for a, b in zip(on_true, on_false))


def all_converged(conv: torch.Tensor) -> bool:
    """Whether every member has converged: one
    :func:`~krylov_tpu_torch.tracing.host_read`."""
    with tracing.host_read():
        return bool(conv.all())


def synced_done(step: int, conv: torch.Tensor) -> bool:
    """The end of an eager loop's body ``step``: counted in
    ``tracing.totals.eager_bodies``; every :data:`SYNC_EVERY` bodies the
    host reads whether every member has converged (:func:`all_converged`)."""
    tracing.totals.eager_bodies.calls += 1
    return step % SYNC_EVERY == SYNC_EVERY - 1 and all_converged(conv)


def step_route(state: tuple) -> bool:
    """Whether :func:`replay_step` tries the graph route: every tensor of
    the state on the card and a stream not already capturing.  A process
    group's collectives are captured with the step (NCCL captures its
    all-reduces and point-to-point exchanges on the rank's stream), so a
    row-partitioned loop takes it too."""
    return (all(t.is_cuda for t in state if isinstance(t, torch.Tensor))
            and not torch.cuda.is_current_stream_capturing())


def graph_route(ctx: Context, state: tuple, steps: int) -> bool:
    """Whether :func:`run_bodies` tries the graph route: every tensor of
    the state on the card (a capture would take a CPU scalar's value as a
    constant), a single-process ``ctx`` (a sharded loop's collectives stay
    eager), a stream not already capturing, and at least one block of
    :data:`SYNC_EVERY` steps to run."""
    return (steps >= SYNC_EVERY and ctx.group is None
            and all(t.is_cuda for t in state if isinstance(t, torch.Tensor))
            and not torch.cuda.is_current_stream_capturing())


def run_bodies(body, state: tuple, steps: int, ctx: Context) -> tuple:
    """Run up to ``steps`` bodies ``state = body(state)`` of an eager loop
    and return the last state.

    ``state`` ends with ``conv`` (a bool per member); after every
    :data:`SYNC_EVERY`-th body the host reads it, as :func:`synced_done`
    does, and the loop stops once every member has converged.  Its other
    entries are tensors, or plain numbers the body reads (``tol``), which it
    returns unchanged.  The body reads every tensor of the request from the
    state, and nothing from its closure but the package's own operators and
    preconditioners, the context and plain numbers.

    On the card (:func:`graph_route`) full blocks of :data:`SYNC_EVERY`
    bodies replay one CUDA graph, kept under a key (:func:`_block_key`)
    that names the current stream.  A key's first block in a request that
    has no graph runs eagerly on a side stream, as torch's warm-up before a
    capture (it also fills K1's parameter cache, whose miss is a host read).
    The capture follows it where it can pay back: where two full blocks are
    left (a long solve), or one is and the key has come back (a repeated
    operator).  The request's state is copied into the graph's static
    buffers at the start and out of them at the end, so that a result never
    aliases them.  The last ``steps % SYNC_EVERY`` bodies run eagerly, so a
    replay never runs a body past ``steps``.  A request whose block another
    thread's request holds, or that would warm up while another thread
    captures, runs eagerly."""
    step = 0
    if graph_route(ctx, state, steps):
        with torch.cuda.device(state[-1].device):
            step, state, done = _replay_blocks(body, state, steps)
        if done:
            return state
    for step in range(step, steps):
        state = body(state)
        if synced_done(step, state[-1]):
            break
    return state


class _Block:
    """A key's entry: weak references to the operators the key names, the
    lock its request holds, whether a request has warmed it up, and once
    captured its graph's replay, its static state, what its capture
    recorded of the counters (:class:`~krylov_tpu_torch.tracing.recording`),
    which each replay runs, and, for a step graph, the memory pool it was
    captured into."""

    __slots__ = ("held", "busy", "seen", "replay", "static", "counts", "pool")

    def __init__(self, held):
        self.held, self.busy, self.seen = held, threading.Lock(), False
        self.replay, self.static, self.counts, self.pool = None, None, (), None


_BLOCKS: collections.OrderedDict = collections.OrderedDict()
_LOCK = threading.Lock()  # the cache's entries and their order
_CAPTURE = threading.Lock()  # one warm-up and capture at a time: they share the side stream
_SIDE: dict = {}  # device -> the side stream of warm-ups and captures
_OPERATORS = (*_CONTAINERS, ChebyshevPreconditioner)


def _plain(v) -> bool:
    return v is None or isinstance(v, (bool, int, float, str, torch.dtype)) or (
        isinstance(v, tuple) and all(_plain(u) for u in v))


def _fingerprint(obj):
    """What a key holds of an operator in a body's closure: its type and,
    field by field, a plain value, a tensor's identity and version (an
    operator changed in place is a new key, since K1 takes constant weights
    as kernel arguments) or a nested operator's fingerprint; a field that
    takes no part in the operator's equality is what it derives from the
    others, and is left out.  None where the object, or one it holds, is
    neither one of the package's own frozen containers and preconditioners
    nor an operator that declares itself keyed (``graph_keyed = True``, as
    :class:`~krylov_tpu_torch.dist.ShardedOperator` does): another object's
    ``matvec`` may read state that changes between requests, or wait for
    the card."""
    if not (isinstance(obj, _OPERATORS) or getattr(obj, "graph_keyed", False)):
        return None
    parts = [type(obj)]
    for f in dataclasses.fields(obj):
        if not f.compare:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            parts.append((id(v), v._version))
        elif isinstance(v, tuple) and v and all(isinstance(t, torch.Tensor) for t in v):
            parts.append(tuple((id(t), t._version) for t in v))
        elif _plain(v):
            parts.append(v)
        else:
            nested = _fingerprint(v)
            if nested is None:
                return None
            parts.append((id(v), nested))
    return tuple(parts)


def _block_key(body, state: tuple):
    """``(key, held)``: the key of ``body``'s block on ``state`` (the body's
    code; the device and its current stream, on which the replays, copies
    and clones run in order; the plain values of the closure, ``ctx``'s
    among them; the identity and fingerprint of each operator there, which
    ``held`` lists; the state's shapes, strides and dtypes and its plain
    numbers), or ``(None, None)`` where the closure holds an object that is
    not one of the package's operators.  Every part compares in C, so a
    weak reference's callback may drop a key while another thread looks
    one up."""
    device = state[-1].device
    parts, held = [body.__code__, device, torch.cuda.current_stream(device).cuda_stream], []
    for cell in body.__closure__ or ():
        v = cell.cell_contents
        if isinstance(v, torch.Tensor):
            raise TypeError(f"{body.__qualname__} reads a tensor from its closure: a replay would read the "
                            "capture's tensor; pass it in the state")
        if isinstance(v, Context):  # its process group: a replay runs the collectives captured on it
            parts.append((Context, v.axis, v.scalar_dtype, v.group))
        elif _plain(v):
            parts.append(v)
        else:
            found = _fingerprint(v)
            if found is None:
                return None, None
            held.append(v)
            parts.append((id(v), found))
    for t in state:
        parts.append((tuple(t.shape), t.stride(), t.dtype) if isinstance(t, torch.Tensor) else t)
    return tuple(parts), held


def _side_stream(device) -> torch.cuda.Stream:
    side = _SIDE.get(device)
    if side is None:
        side = _SIDE[device] = torch.cuda.Stream(device)
    return side


def _record(fn, device, pool=None):
    """``fn`` captured as a CUDA graph on the side stream of ``device``
    (the one that ran the warm-up), into the memory pool ``pool`` (a
    private one where None); returns the graph's replay.  The capture is
    begun and ended directly, without the synchronisation, ``gc.collect``
    and emptied allocator cache of ``torch.cuda.graph``: nothing runs while
    it records."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(_side_stream(device)):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    return graph.replay


def _capture(block: _Block, body, state: tuple, bodies: int = SYNC_EVERY, pool=None) -> None:
    """Capture ``bodies`` bodies into ``block`` from static copies of
    ``state``, ending with the copy of the last body's state back into
    them.  What the bodies count while the capture records, and the block's
    own count of one replay of ``bodies`` bodies, is the block's
    ``counts``, which each replay credits."""
    static = tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in state)

    def run():
        tracing.count("eager_graph", "replays")
        tracing.count("eager_graph", "bodies", n=bodies)
        tracing.count("eager_bodies", n=bodies)
        out = static
        for _ in range(bodies):
            out = body(out)
        for dst, src in zip(static, out):
            if isinstance(dst, torch.Tensor) and src is not dst:
                if any(src is t for t in static):
                    raise ValueError(f"{body.__qualname__} moves a state entry to another slot")
                dst.copy_(src)

    with tracing.recording() as recorded:
        block.replay = _record(run, state[-1].device, pool)
    block.static, block.counts = static, recorded.counts
    tracing.totals.eager_graph.captures += 1


def _entry(key, held) -> _Block:
    """The cache's entry for ``key`` (made, or moved to the recent end),
    under ``_LOCK``; a new one may push the least recently used out."""
    block = _BLOCKS.get(key)
    if block is not None and all(ref() is obj for ref, obj in zip(block.held, held)):
        _BLOCKS.move_to_end(key)
        return block

    def drop(_, key=key, blocks=_BLOCKS):  # the cache itself: the module may be gone when it runs
        blocks.pop(key, None)

    block = _BLOCKS[key] = _Block([weakref.ref(obj, drop) for obj in held])
    while len(_BLOCKS) > GRAPHS_KEPT:
        _BLOCKS.popitem(last=False)
    return block


def _replay_blocks(body, state: tuple, steps: int):
    """The graph route of :func:`run_bodies`: its full blocks, as
    ``(steps run, state, done)``, none where the block has no key or is in
    use by another thread's request."""
    key, held = _block_key(body, state)
    if key is None:
        return 0, state, False
    with _LOCK:
        block = _entry(key, held)
        if not block.busy.acquire(blocking=False):
            return 0, state, False
    try:
        if block.replay is None:
            return _warm_up(block, body, state, steps)
        for dst, src in zip(block.static, state):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        return _replays(block, 0, steps)
    finally:
        block.busy.release()


def _warm_up(block: _Block, body, state: tuple, steps: int):
    """A block of bodies run eagerly on the side stream, then the capture
    where it pays back (:func:`run_bodies`) and the replays left."""
    if not _CAPTURE.acquire(blocking=False):
        return 0, state, False
    try:
        main, side = torch.cuda.current_stream(), _side_stream(state[-1].device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for step in range(SYNC_EVERY):
                state = body(state)
                done = synced_done(step, state[-1])
        main.wait_stream(side)
        blocks_left = (steps - SYNC_EVERY) // SYNC_EVERY
        if done or blocks_left < (1 if block.seen else 2):
            block.seen = True
            return SYNC_EVERY, state, done
        _capture(block, body, state)
    finally:
        _CAPTURE.release()
    return _replays(block, SYNC_EVERY, steps)


def _replays(block: _Block, step: int, steps: int):
    """Replay ``block`` from step ``step`` while a full block is left and
    not every member has converged; returns ``(steps run, a copy of the
    static state, done)``."""
    static, done = block.static, False
    while not done and steps - step >= SYNC_EVERY:
        block.replay()
        tracing.credit(block.counts)
        step += SYNC_EVERY
        done = all_converged(static[-1])
    return step, tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in static), done


def replay_step(body, state: tuple) -> tuple:
    """One step ``state = body(state)`` of a loop whose host reads what
    each step gives (the adaptive k-skip loop: an outer iteration and the
    next guard's flags), counted as one body in
    ``tracing.totals.eager_bodies``.  Returns the new state.

    ``state``'s entries are tensors, or plain numbers the body reads; the
    body reads every tensor of the request from the state, and nothing
    from its closure but the package's own operators (a sharded one
    included), the context and plain numbers, as :func:`run_bodies` asks.
    On the card (:func:`step_route`) a key's first step (:func:`_block_key`)
    runs eagerly on the side stream, torch's warm-up before a capture (it
    fills K1's cache and starts a communicator's streams); its second is
    captured as a CUDA graph, into one memory pool for every step graph
    replayed on the stream (they never run at once), and each step of the
    key from then on is one replay of it.  A replay returns a copy of the
    graph's static state, as :func:`run_bodies` does: the key's next
    replay, another thread's too, overwrites the static state.  A step
    whose key another thread's request holds, or that would warm up or
    capture while another thread does, runs eagerly.  Both routes launch
    the same kernels in the same order, collectives included, so they give
    the same bits."""
    if step_route(state):
        with torch.cuda.device(state[-1].device):
            out = _replay_step(body, state)
        if out is not None:
            return out
    tracing.count("eager_bodies")
    return body(state)


def _replay_step(body, state: tuple):
    """The graph route of :func:`replay_step`: the new state, or None where
    the step runs eagerly on the current stream."""
    key, held = _block_key(body, state)
    if key is None:
        return None
    with _LOCK:
        block = _entry(key, held)
        if not block.busy.acquire(blocking=False):
            return None
    try:
        if block.replay is None:
            if not _CAPTURE.acquire(blocking=False):
                return None
            try:
                device = state[-1].device
                if not block.seen:
                    block.seen = True
                    main, side = torch.cuda.current_stream(), _side_stream(device)
                    side.wait_stream(main)
                    with torch.cuda.stream(side):
                        tracing.count("eager_bodies")
                        state = body(state)
                    main.wait_stream(side)
                    return state
                pool, owner = _shared_pool(key)
                _capture(block, body, state, bodies=1, pool=pool)
                del owner  # the new graph holds the pool now
                graph = getattr(block.replay, "__self__", None)  # the CUDA graph whose replay it is
                block.pool = pool if pool is not None or graph is None else graph.pool()
            finally:
                _CAPTURE.release()
        for dst, src in zip(block.static, state):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        block.replay()
        tracing.credit(block.counts)
        return tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in block.static)
    finally:
        block.busy.release()


def _shared_pool(key):
    """``(pool, owner)``: the memory pool of a step graph in the cache
    replayed on ``key``'s device and stream, for the next capture there to
    share, and that graph's replay (``(None, None)``: a pool of its own).
    A pool lives while a graph captured into it does, so it is taken from
    a cached graph, never kept apart; the caller holds ``owner`` until its
    capture has begun, or another thread's new key could push that graph
    out of the cache and free the pool first."""
    with _LOCK:
        return next(((block.pool, block.replay) for other, block in _BLOCKS.items()
                     if block.pool is not None and other[1:3] == key[1:3]), (None, None))


def read_flags(flags: torch.Tensor):
    """``flags`` on the host as numpy: one
    :func:`~krylov_tpu_torch.tracing.host_read`."""
    with tracing.host_read():
        return flags.cpu().numpy()


def guard_read(flags: torch.Tensor):
    """``flags`` on the host as numpy (:func:`read_flags`): the one read an
    outer iteration of the CA loops, counted as one body in
    ``tracing.totals.eager_bodies``."""
    tracing.totals.eager_bodies.calls += 1
    return read_flags(flags)


def pow2_scale(s: torch.Tensor) -> torch.Tensor:
    """Nearest power of two to ``s`` (1 where ``s <= 0`` or not finite).

    The ``basis_norm`` chains scale each basis vector by this: a power of
    two only moves the exponent, so the scaling adds no rounding.  The
    exponent is ``log2 s`` rounded half to even and clipped to [-126, 127],
    and ``2**e`` is built exactly from the float32 bit pattern
    ``(e + 127) << 23``, as :func:`krylov_tpu.solvers._common.pow2_scale`
    builds it (so a float64 norm beyond that range scales partially)."""
    ok = torch.isfinite(s) & (s > 0)
    e = torch.round(torch.log2(torch.where(ok, s, torch.ones_like(s)))).to(torch.int32)
    e = e.clamp(-126, 127)
    val = ((e + 127) << 23).view(torch.float32).to(s.dtype)
    return torch.where(ok, val, torch.ones_like(s))


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with exact-zero denominators mapped to 0 (a frozen
    update instead of a NaN at exact convergence)."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num), num / torch.where(zero, torch.ones_like(den), den))


def scale(alpha: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``alpha * v`` computed in ``alpha``'s (scalar) dtype, cast back to
    ``v``'s — the JAX solvers' ``(alpha * v).astype(v.dtype)``."""
    return (bcast(alpha, v) * v.to(alpha.dtype)).to(v.dtype)


def set_at(trace: torch.Tensor, idx: torch.Tensor, value: torch.Tensor, keep=None) -> None:
    """``trace[..., idx] = value`` on the device (``idx`` an integer per
    batch member), left as it was where the bool tensor ``keep`` is true."""
    i = idx.unsqueeze(-1)
    new = value.unsqueeze(-1).to(trace.dtype)
    if keep is not None:
        new = torch.where(keep.unsqueeze(-1), trace.gather(-1, i), new)
    trace.scatter_(-1, i, new)


def record_final(trace: torch.Tensor, i: torch.Tensor, conv: torch.Tensor, final: torch.Tensor):
    """Diverged exit: ``trace[..., i] = final`` unless converged (or ``i`` is
    past the trace, where the write is dropped)."""
    last = trace.shape[-1]
    set_at(trace, i.clamp(max=last - 1), final, conv | (i >= last))


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Fixed-shape result of a solve, as device tensors.

    ``residual_trace``/``nosl_trace``/``k_trace`` are fixed-size buffers
    (fewer slots on the fused path past its trace capacity); entries beyond
    ``index`` are undefined.  ``iterations`` is the number of solution
    updates, ``index`` the position of the final residual in the trace (the
    outer-iteration count of the k-skip family).  A batched solve stacks
    every field along a leading batch axis.
    """

    x: torch.Tensor
    residual_trace: torch.Tensor
    nosl_trace: torch.Tensor
    iterations: torch.Tensor
    index: torch.Tensor
    converged: torch.Tensor  # bool
    # k per outer iteration and the last k (adaptive k-skip MrR only)
    k_trace: Optional[torch.Tensor] = None
    final_k: Optional[torch.Tensor] = None
    # ||b - A x|| / ||b|| in working precision, set by the ``restarts=``
    # defect correction of :mod:`krylov_tpu_torch.api` (None otherwise)
    true_residual: Optional[torch.Tensor] = None
    # True when the fused path ran past its trace capacity and the tail of
    # the history was overwritten in the last slot (None off that path).
    trace_truncated: Optional[torch.Tensor] = None
    # the loop's state after its last iteration, with ``emit_carry=True``:
    # passed back as ``carry_in=(carry, True)``, the next chunk resumes the
    # recurrence exactly (``solve(chunk_iters=)``; None otherwise)
    carry: Optional[tuple] = None


def carried(carry_in):
    """The state of ``carry_in=(state, valid)`` when ``valid`` (a host
    bool), else None: the loop then starts from ``x0``."""
    if carry_in is None:
        return None
    state, valid = carry_in
    return state if valid else None


def scalar_dtype_of(ctx, b: torch.Tensor) -> torch.dtype:
    return ctx.scalar_dtype if ctx.scalar_dtype is not None else b.dtype


def check_square(A, b: torch.Tensor) -> int:
    n = b.shape[-1]
    if A.shape[0] != A.shape[1] or A.shape[0] != n:
        raise ValueError(f"system shape mismatch: A {A.shape}, b {tuple(b.shape)}")
    return n
