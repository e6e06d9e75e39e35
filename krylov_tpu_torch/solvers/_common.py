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

The helpers take a leading batch axis (vectors ``(batch, n)``, scalars and
counters ``(batch,)``, traces ``(batch, L)``), so a loop written for one
system runs a batch as a ``vmap``-ped ``lax.while_loop`` does: every member
keeps its own counters, trace slot and convergence flag, and freezes on its
own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from krylov_tpu_torch import tracing

SYNC_EVERY = 32


def bcast(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``s`` (a scalar per batch member) with trailing unit axes up to
    ``v``'s rank, so it broadcasts over each member's vector."""
    return s if s.ndim == 0 else s.reshape(s.shape + (1,) * (v.ndim - s.ndim))


def tree_select(pred: torch.Tensor, on_true, on_false) -> tuple:
    """``torch.where(pred, a, b)`` leaf by leaf over two tuples (``pred`` is
    a bool per batch member)."""
    return tuple(torch.where(bcast(pred, a), a, b) for a, b in zip(on_true, on_false))


def synced_done(step: int, conv: torch.Tensor) -> bool:
    """The end of an eager loop's body ``step``: counted in
    ``tracing.totals.eager_bodies``; every :data:`SYNC_EVERY` bodies the
    host reads whether every member has converged (one
    :func:`~krylov_tpu_torch.tracing.host_read`)."""
    tracing.totals.eager_bodies.calls += 1
    if step % SYNC_EVERY != SYNC_EVERY - 1:
        return False
    with tracing.host_read():
        return bool(conv.all())


def guard_read(flags: torch.Tensor):
    """``flags`` on the host as numpy: the one read an outer iteration of
    the guarded loops (adaptive k-skip MrR, the CA loops), counted as one
    body in ``tracing.totals.eager_bodies`` and one
    :func:`~krylov_tpu_torch.tracing.host_read`."""
    tracing.totals.eager_bodies.calls += 1
    with tracing.host_read():
        return flags.cpu().numpy()


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
