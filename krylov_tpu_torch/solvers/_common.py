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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SYNC_EVERY = 32


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with exact-zero denominators mapped to 0 (a frozen
    update instead of a NaN at exact convergence)."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num), num / torch.where(zero, torch.ones_like(den), den))


def scale(alpha: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``alpha * v`` computed in ``alpha``'s (scalar) dtype, cast back to
    ``v``'s — the JAX solvers' ``(alpha * v).astype(v.dtype)``."""
    return (alpha * v.to(alpha.dtype)).to(v.dtype)


def record_final(trace: torch.Tensor, i: torch.Tensor, conv: torch.Tensor, final: torch.Tensor):
    """Diverged exit: ``trace[i] = final`` unless converged (or ``i`` is past
    the trace, where the write is dropped)."""
    idx = i.clamp(max=trace.numel() - 1).view(1)
    keep = conv | (i >= trace.numel())
    trace.index_copy_(
        0, idx, torch.where(keep, trace.index_select(0, idx), final.view(1).to(trace.dtype))
    )


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Fixed-shape result of a solve, as device tensors.

    ``residual_trace``/``nosl_trace`` have ``maxiter + 1`` slots (fewer on
    the fused path past its trace capacity); entries beyond ``index`` are
    undefined.  ``iterations`` is the number of solution updates, ``index``
    the position of the final residual in the trace.
    """

    x: torch.Tensor
    residual_trace: torch.Tensor
    nosl_trace: torch.Tensor
    iterations: torch.Tensor
    index: torch.Tensor
    converged: torch.Tensor  # bool
    # True when the fused path ran past its trace capacity and the tail of
    # the history was overwritten in the last slot (None off that path).
    trace_truncated: Optional[torch.Tensor] = None


def scalar_dtype_of(ctx, b: torch.Tensor) -> torch.dtype:
    return ctx.scalar_dtype if ctx.scalar_dtype is not None else b.dtype


def check_square(A, b: torch.Tensor) -> int:
    n = b.shape[-1]
    if A.shape[0] != A.shape[1] or A.shape[0] != n:
        raise ValueError(f"system shape mismatch: A {A.shape}, b {tuple(b.shape)}")
    return n
