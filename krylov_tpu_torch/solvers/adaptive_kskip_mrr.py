"""Adaptive k-skip MrR as an eager loop.

Numerics follow
:func:`krylov_tpu.solvers.adaptive_kskip_mrr.adaptivekskipmrr_kernel`:
k-skip MrR with a residual guard at the top of every outer iteration.  If
the residual rose against the last accepted one, or is not finite, the
solve rolls back to the accepted ``pre_x``, takes one plain MrR half-step
from there and lowers k by one (floor 1); otherwise it accepts the state.
Either way it then takes a k-skip outer step at the current k.
``k_trace`` records k per outer index, seeded ``[k, k]``.

Unlike the static loops, this one reads the guard, the convergence flag
and so the current k on the host once an outer iteration (a rollback adds
one read): an outer iteration is k+1 solution updates and its trip counts
depend on k.
"""

from __future__ import annotations

from typing import Optional

import torch

from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import SolveResult, scalar_dtype_of
from krylov_tpu_torch.solvers.kskip_mrr import kskipmrr_outer, mrr_half_step


def adaptivekskipmrr_kernel(
    A, b: torch.Tensor, x0: torch.Tensor, *, tol: float = 1e-5, maxiter: int,
    k: int = 0, ctx: Context = DEFAULT_CONTEXT, basis_norm: bool = False,
    b_norm: Optional[torch.Tensor] = None,
) -> SolveResult:
    # b_norm divides the residuals (default ||b||): the plain K5/K6 pass
    # that of the unshifted b
    dev = b.device
    sdt = scalar_dtype_of(ctx, b)
    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=dev)
    b_norm = ctx.norm(b) if b_norm is None else b_norm

    trace_len = maxiter + 2
    rtrace = torch.zeros(trace_len, dtype=sdt, device=dev)
    ntrace = torch.zeros(trace_len, dtype=torch.int32, device=dev)
    ktrace = torch.zeros(trace_len, dtype=torch.int32, device=dev)
    ktrace[:2] = k

    *state, r0 = mrr_half_step(ctx, A, b, x0)
    res0 = ctx.norm(r0) / b_norm
    rtrace[0] = res0
    ntrace[1] = 1
    pre_x, pre_res = state[0], res0

    kk, i, index, conv = int(k), 1, 1, False
    while not conv and i < maxiter:
        res = ctx.norm(state[1]) / b_norm
        rtrace[index] = res
        # non-finite counts as rose: NaN compares false, and a blow-up inside
        # an outer step would otherwise be accepted for good
        rose, conv = torch.stack([(res > pre_res) | ~torch.isfinite(res), res < tol_t]).tolist()
        if rose:
            *state, _ = mrr_half_step(ctx, A, b, pre_x)
            i, index = i + 1, index + 1
            kk = kk - 1 if kk > 1 else kk
            res_n = ctx.norm(state[1]) / b_norm
            rtrace[index] = res_n
            ntrace[index] = i
            ktrace[index] = kk
            conv = bool(res_n < tol_t)
        else:
            pre_x, pre_res = state[0], res
        if conv:
            break
        _, state = kskipmrr_outer(ctx, A, kk, basis_norm, state)
        i, index = i + kk + 1, index + 1
        ntrace[index] = i
        ktrace[index] = kk

    if not conv:  # diverged exit writes the final residual
        rtrace[index] = ctx.norm(state[1]) / b_norm
    as_int = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
    return SolveResult(
        x=state[0],
        residual_trace=rtrace,
        nosl_trace=ntrace,
        iterations=as_int(i),
        index=as_int(index),
        converged=torch.tensor(conv, device=dev),
        k_trace=ktrace,
        final_k=as_int(kk),
    )
