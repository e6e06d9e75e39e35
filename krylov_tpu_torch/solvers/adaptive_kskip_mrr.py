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
depend on k.  The counters, k and the nosl/k traces therefore live on the
host, and go to the device once, with the result.

``b`` and ``x0`` may carry a leading batch axis ``(batch, n)``.  The
guard of the whole batch is then one ``(batch, 2)`` read; the rollback
half-step runs on the members that rolled back, and the outer step on the
live members grouped by their current k, one sub-batch a distinct k
(``index_select`` in, ``index_copy`` out; no copy when the group is the
whole batch).  Each member keeps its own counts, traces and k.

``carry_in=((x, r, y, z, Ar1, pre_x, pre_res, k_cur), valid)`` (``valid``
a host bool) resumes from a previous chunk's ``result.carry``: the
rollback snapshot ``(pre_x, pre_res)`` and the adapted ``k_cur`` cross the
chunk boundary, so a rollback that spans it behaves as in the unbroken
solve; the loop skips the init half-step, starts its counts at 0 and seeds
``k_trace[0:2]`` with the carried k.  ``emit_carry=True`` returns that
state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.solvers._common import SolveResult, carried, guard_read, scalar_dtype_of
from krylov_tpu_torch.solvers.kskip_mrr import kskipmrr_outer, mrr_half_step


def adaptivekskipmrr_kernel(
    A, b: torch.Tensor, x0: torch.Tensor, *, tol: float = 1e-5, maxiter: int,
    k: int = 0, ctx: Context = DEFAULT_CONTEXT, basis_norm: bool = False,
    b_norm: Optional[torch.Tensor] = None, carry_in=None, emit_carry: bool = False,
) -> SolveResult:
    # b_norm divides the residuals (default ||b||): the plain K5/K6 pass
    # that of the unshifted b
    dev = b.device
    sdt = scalar_dtype_of(ctx, b)
    tol_t = tracing.scalar_on(tol, b.dtype, dev)
    b_norm = ctx.norm(b) if b_norm is None else b_norm
    batch = b.shape[:-1]
    nb = b.shape[0] if batch else 1

    def rows(g: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(g, device=dev)

    def take(t: torch.Tensor, g: np.ndarray) -> torch.Tensor:
        """The members ``g`` of a per-member tensor (all of them: ``t``)."""
        return t if len(g) == nb else t.index_select(0, rows(g))

    def put(t: torch.Tensor, g: np.ndarray, v: torch.Tensor) -> torch.Tensor:
        """``t`` with the members ``g`` replaced by ``v``."""
        return v if len(g) == nb else t.index_copy(0, rows(g), v)

    def record(g: np.ndarray, v: torch.Tensor) -> None:
        """``rtrace[g, index[g]] = v`` on the device."""
        if not batch:
            rtrace[int(index[0])] = v
        else:
            rtrace[rows(g), rows(index[g])] = v.to(sdt)

    trace_len = maxiter + 2
    rtrace = torch.zeros(batch + (trace_len,), dtype=sdt, device=dev)
    ntrace = np.zeros((nb, trace_len), np.int32)
    ktrace = np.zeros((nb, trace_len), np.int32)

    state = carried(carry_in)
    if state is not None:
        *state, pre_x, pre_res, k_cur = state
        with tracing.host_read():
            kk = np.broadcast_to(torch.as_tensor(k_cur).reshape(-1).cpu().numpy(), (nb,)).astype(np.int64)
        i0 = 0
    else:
        *state, r0 = mrr_half_step(ctx, A, b, x0)
        pre_res = ctx.norm(r0) / b_norm
        rtrace[..., 0] = pre_res
        ntrace[:, 1] = 1
        pre_x = state[0]
        kk = np.full(nb, int(k), np.int64)
        i0 = 1
    ktrace[:, :2] = kk[:, None]
    i, index = np.full(nb, i0, np.int64), np.full(nb, i0, np.int64)
    conv = np.zeros(nb, bool)

    while True:
        live = np.flatnonzero(~conv & (i < maxiter))
        if live.size == 0:
            break
        res = ctx.norm(state[1]) / b_norm
        record(live, take(res, live))
        # non-finite counts as rose: NaN compares false, and a blow-up inside
        # an outer step would otherwise be accepted for good
        flags = guard_read(torch.stack([(res > pre_res) | ~torch.isfinite(res), res < tol_t], -1).reshape(nb, 2))
        rose, accept = live[flags[live, 0]], live[~flags[live, 0]]
        if accept.size:
            conv[accept] = flags[accept, 1]
            pre_x, pre_res = put(pre_x, accept, take(state[0], accept)), put(pre_res, accept, take(res, accept))
        if rose.size:
            *sub, _ = mrr_half_step(ctx, A, take(b, rose), take(pre_x, rose))
            state = [put(t, rose, v) for t, v in zip(state, sub)]
            i[rose] += 1
            index[rose] += 1
            kk[rose] = np.where(kk[rose] > 1, kk[rose] - 1, kk[rose])
            res_n = ctx.norm(sub[1]) / take(b_norm, rose)
            record(rose, res_n)
            ntrace[rose, index[rose]] = i[rose]
            ktrace[rose, index[rose]] = kk[rose]
            with tracing.host_read():
                conv[rose] = (res_n < tol_t).reshape(-1).cpu().numpy()
        stepping = live[~conv[live]]
        for kv in np.unique(kk[stepping]):
            g = stepping[kk[stepping] == kv]
            _, new = kskipmrr_outer(ctx, A, int(kv), basis_norm, [take(t, g) for t in state])
            state = [put(t, g, v) for t, v in zip(state, new)]
            i[g] += kv + 1
            index[g] += 1
            ntrace[g, index[g]] = i[g]
            ktrace[g, index[g]] = kv

    diverged = np.flatnonzero(~conv)
    if diverged.size:  # a diverged exit writes the final residual
        record(diverged, take(ctx.norm(state[1]) / b_norm, diverged))

    def member(a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(a, device=dev).to(dtype).reshape(batch + a.shape[1:])

    x, r, y, z, Ar1 = state
    return SolveResult(
        x=x,
        residual_trace=rtrace,
        nosl_trace=member(ntrace, torch.int32),
        iterations=member(i),
        index=member(index),
        converged=member(conv, torch.bool),
        k_trace=member(ktrace, torch.int32),
        final_k=member(kk),
        carry=(x, r, y, z, Ar1, pre_x, pre_res, member(kk)) if emit_carry else None,
    )
