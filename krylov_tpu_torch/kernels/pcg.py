"""The vector and scalar work of preconditioned CG's eager body
(:func:`krylov_tpu_torch.solvers.pcg_kernel`) as four steps around its
SpMV and its preconditioner:

- :func:`step_alpha`: ``<s, p>`` with ``s = A p``; the residual
  ``sqrt(rr) / |b|`` written to the trace at ``i``, ``conv``, ``alpha``
  and the next ``i``;
- :func:`step_xr`: ``x`` and ``r`` updated (kept where ``conv``) and
  ``rr = <r, r>`` of the kept ``r``;
- :func:`step_ru`: ``ru = <r, u>`` with ``u = M r`` (kept where ``conv``)
  and ``beta``;
- :func:`step_p`: ``p`` updated (kept where ``conv``).

Each takes one vector ``(n,)`` or a ``(batch, n)`` block with one scalar
a member.  Given the ``work`` of a solve (:func:`scratch`: the scratch of
the inner products, which one solve owns) a step is one launch of its
kernel in ``csrc/pcg.cu``, counted in ``tracing.totals.pcg_launches``, on
CUDA tensors that :func:`takes`; given None it runs torch's passes, with
``ctx``'s inner products and :func:`~krylov_tpu_torch.solvers._common.scale`'s
products in the scalar dtype.  The kernels' updates are torch's bit for
bit for given scalars; their inner products sum in a fixed order of their
own (see the note in ``csrc/pcg.cu``).
"""

from __future__ import annotations

import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.kernels import _build
from krylov_tpu_torch.solvers._common import bcast, safe_div, scale, set_at, tree_select

_DTYPES = (torch.float32, torch.float64)
THREADS = 256  # kThreads of csrc/reduce.cuh: the partials a member are ceil(n / THREADS)


def takes(b: torch.Tensor) -> bool:
    """Whether the kernels take a solve's ``b``: a contiguous float32 or
    float64 CUDA tensor ``(n,)`` or ``(batch, n)``, with 1 <= n < 2**31
    and 1 <= batch <= 65535."""
    return (b.is_cuda and b.dtype in _DTYPES and b.is_contiguous() and b.ndim in (1, 2)
            and 1 <= b.shape[-1] < 2**31 and (b.ndim == 1 or 1 <= b.shape[0] <= 65535))


def scratch(b: torch.Tensor) -> torch.Tensor:
    """The zeroed scratch of one solve's inner products on ``b``'s
    shape: ``ceil(n / THREADS)`` partials a member, then one ticket a
    member (an unsigned int in a slot of the dtype)."""
    batch = b.shape[0] if b.ndim == 2 else 1
    return torch.zeros(batch * (-(-b.shape[-1] // THREADS) + 1), dtype=b.dtype, device=b.device)


def _like(t: torch.Tensor, ref: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` contiguous, once it has ``ref``'s shape, dtype and device."""
    if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
        raise ValueError(f"pcg: {what} is {tuple(t.shape)} {t.dtype} on {t.device}, the vectors "
                         f"{tuple(ref.shape)} {ref.dtype} on {ref.device}")
    return t.contiguous()


def _launch(entry: str, v: torch.Tensor, *args) -> None:
    """Call ``krylov_pcg_<entry>`` on ``v``'s shape, tensors passed as
    their addresses, on torch's current stream of ``v``'s device; counted
    in ``tracing.totals.pcg_launches.<entry>``."""
    if not v.is_cuda:
        raise ValueError(f"pcg step_{entry}: the kernel takes CUDA tensors, got {v.device}")
    n, batch = v.shape[-1], v.shape[0] if v.ndim == 2 else 1
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    fn = getattr(_build.library(), f"krylov_pcg_{entry}")
    index = v.get_device()
    if index == torch.cuda.current_device():
        err = fn(v.element_size(), n, batch, *args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(v.element_size(), n, batch, *args, torch._C._cuda_getCurrentRawStream(index))
    _build.check(err, f"pcg step_{entry}")
    tracing.count("pcg_launches", entry)


def step_alpha(ctx, s, p, rr, b_norm, ru, tol, trace, i, work) -> tuple:
    """``(conv, alpha, i')``: ``res = sqrt(rr) / b_norm`` written to
    ``trace[..., i]``, ``conv = res < tol``, ``alpha = safe_div(ru, <s, p>)``
    and ``i' = i + !conv``.  On the kernel ``tol`` is a number or a 0-d
    tensor of the dtype on the card."""
    if work is None:
        res = torch.sqrt(rr) / b_norm
        set_at(trace, i, res)
        conv = res < tol
        return conv, safe_div(ru, ctx.dot(s, p)), i + (~conv).to(i.dtype)
    s = _like(s, p, "A p")
    conv, alpha, i_out = torch.empty_like(i, dtype=torch.bool), torch.empty_like(rr), torch.empty_like(i)
    at, value = (tol, 0.0) if isinstance(tol, torch.Tensor) else (None, float(tol))
    _launch("alpha", p, s, p, rr, b_norm, ru, at, value, trace, trace.shape[-1], i, conv, alpha, i_out, work)
    return conv, alpha, i_out


def step_xr(ctx, x, p, r, s, alpha, conv, rr, work) -> tuple:
    """``(x', r', rr')``: ``x + alpha p`` and ``r - alpha s`` (each product
    and sum rounded on its own) where not ``conv``, else ``x`` and ``r``;
    ``rr' = <r', r'>`` where not ``conv``, else ``rr``."""
    if work is None:
        x_n, r_n = x + scale(alpha, p), r - scale(alpha, s)
        return tree_select(conv, (x, r, rr), (x_n, r_n, ctx.dot(r_n, r_n)))
    x_out, r_out, rr_out = torch.empty_like(x), torch.empty_like(r), torch.empty_like(rr)
    _launch("xr", p, x, p, r, s, alpha, conv, rr, x_out, r_out, rr_out, work)
    return x_out, r_out, rr_out


def step_ru(ctx, r, u, ru, conv, work) -> tuple:
    """``(ru', beta)``: ``ru' = <r, u>`` where not ``conv``, else ``ru``;
    ``beta = safe_div(<r, u>, ru)`` where not ``conv``.  Where ``conv`` no
    step reads ``beta``: the kernel skips the product there and writes 0,
    torch's passes leave their quotient."""
    if work is None:
        ru_n = ctx.dot(r, u)
        return torch.where(conv, ru, ru_n), safe_div(ru_n, ru)
    u = _like(u, r, "M r")
    ru_out, beta = torch.empty_like(ru), torch.empty_like(ru)
    _launch("ru", r, r, u, ru, conv, ru_out, beta, work)
    return ru_out, beta


def step_p(u, p, beta, conv, work) -> torch.Tensor:
    """``u + beta p`` (each rounded on its own) where not ``conv``, else
    ``p``.  ``work`` chooses the kernel, as for the other steps; this one
    sums nothing."""
    if work is None:
        return torch.where(bcast(conv, p), p, u + scale(beta, p))
    u = _like(u, p, "M r")
    p_out = torch.empty_like(p)
    _launch("p", p, u, p, beta, conv, p_out)
    return p_out
