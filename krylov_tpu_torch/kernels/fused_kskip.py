"""K5/K6: whole-solve k-skip MrR (static or adaptive) and k-skip CG on a
2-D stencil operator in one launch.

The counterparts of :func:`krylov_tpu.kernels.fused_kskip.fused_kskipmrr_solve_2d`
and :func:`~krylov_tpu.kernels.fused_kskip.fused_kskipcg_solve_2d`, with
their signatures and return tuples.  On a CUDA tensor the wrappers launch the
persistent cooperative kernels of ``csrc/fused_kskip.cu``; on a CPU tensor
they run the plain PyTorch versions beside them, which are the eager loops
of :mod:`krylov_tpu_torch.solvers` on the stencil operator.  Both solve from
x0 = 0 (the caller shifts for x0).  ``k`` is a runtime value in ``[0, k_max]``.

Traces have ``min(maxiter, TRACE_CAP) + 2`` slots, indexed by the outer
iteration; a solve past the cap keeps iterating and records in the last
slot.  ``nosl`` holds the solution-update count per outer index and
``ktrace`` (K5) the k per outer index: the adaptive solve writes every
entry, the static one only ``ktrace[0..1] = k``; the rest stays 0.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Tuple

import torch

from krylov_tpu_torch.kernels import _build, fused
from krylov_tpu_torch.kernels.stencil import (
    geometry,
    require_cuda,
    stencil_matvec_2d_reference,
)
from krylov_tpu_torch.solvers import adaptivekskipmrr_kernel, kskipcg_kernel, kskipmrr_kernel

_METHOD_CODE = {"kskipcg": 0, "kskipmrr": 1}
_workspace = {}


def trace_length(maxiter: int) -> int:
    """Trace slots of a solve: ``min(maxiter, TRACE_CAP) + 2`` (the cap
    shared with K2/K3, read at call time)."""
    return min(maxiter, fused.TRACE_CAP) + 2


def _check_k(k, k_max: int) -> int:
    k = int(k)
    if not 0 <= k <= k_max:
        raise ValueError(f"k must lie in [0, k_max] = [0, {k_max}], got {k}")
    return k


def workspace(method: str, dtype: torch.dtype, n: int, k_max: int) -> Tuple[int, int, int, int]:
    """``(blocks, work, partials, smem)`` for a solve of ``n`` points with
    ``k <= k_max`` on the current CUDA device: the blocks of the cooperative
    grid (at most ``fused.MAX_BLOCKS`` when that is set), the elements of
    the two scratch buffers and the bytes of dynamic shared memory a block
    takes, as the C library sizes them.  Cached per device."""
    key = (method, dtype, n, k_max, fused.MAX_BLOCKS, torch.cuda.current_device())
    if key not in _workspace:
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        work, partials = ctypes.c_longlong(0), ctypes.c_longlong(0)
        _build.check(
            _build.library().krylov_kskip_workspace(
                _METHOD_CODE[method], dtype.itemsize, n, k_max, fused.MAX_BLOCKS, ctypes.byref(blocks),
                ctypes.byref(work), ctypes.byref(partials), ctypes.byref(smem),
            ),
            "krylov_kskip_workspace",
        )
        _workspace[key] = (blocks.value, work.value, partials.value, smem.value)
    return _workspace[key]


def _launch(method, coef, b, tol, b_norm, k, stencil, grid, maxiter, k_max, adaptive, sub):
    name = f"fused_{method}_solve_2d"
    require_cuda(name, coef, b, stencil, grid)
    lib = _build.library()
    dt, dev = b.dtype, b.device
    trace_len = trace_length(maxiter)
    with torch.cuda.device(dev):
        blocks, work_elems, partial_elems, smem = workspace(method, dt, b.numel(), k_max)
        x = torch.empty_like(b)
        trace = torch.zeros(trace_len, dtype=dt, device=dev)
        nosl = torch.zeros(trace_len, dtype=torch.int32, device=dev)
        ktrace = torch.zeros(trace_len, dtype=torch.int32, device=dev)
        stats = torch.zeros(4, dtype=torch.int32, device=dev)
        work = torch.empty(work_elems, dtype=dt, device=dev)
        partials = torch.empty(partial_elems, dtype=dt, device=dev)
        scal = torch.stack([
            torch.as_tensor(tol, dtype=dt, device=dev),
            torch.as_tensor(b_norm, dtype=dt, device=dev),
        ])
        err = lib.krylov_kskip_solve(
            _METHOD_CODE[method], b.element_size(), blocks, smem, k, k_max, int(adaptive),
            coef.data_ptr(), b.data_ptr(), scal.data_ptr(), x.data_ptr(), trace.data_ptr(),
            nosl.data_ptr(), ktrace.data_ptr(), stats.data_ptr(), work.data_ptr(), partials.data_ptr(),
            *geometry(stencil, grid, sub, coef.ndim == 1), maxiter, trace_len,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, name)
    return x, trace, nosl, ktrace, stats


def _plain(loop, coef, b, tol, b_norm, k, stencil, grid, maxiter, k_max, sub):
    """The eager loop ``loop`` of :mod:`krylov_tpu_torch.solvers` from
    x0 = 0 on the stencil operator, its residuals divided by ``b_norm``.
    Returns the loop's result, its residual and nosl traces laid out as the
    kernel writes them (``trace_length(maxiter)`` slots; when the final outer
    index lies past the last slot, its entry stands there), the iteration
    and outer counts as int32, and the layout function."""
    k = _check_k(k, k_max)
    op = SimpleNamespace(
        matvec=lambda v: stencil_matvec_2d_reference(coef, v, stencil=stencil, grid=grid, sub=sub)
    )
    res = loop(op, b, torch.zeros_like(b), tol=tol, maxiter=maxiter, k=k,
               b_norm=torch.as_tensor(b_norm, dtype=b.dtype, device=b.device))
    trace_len, index = trace_length(maxiter), int(res.index)
    last = min(index, trace_len - 1)

    def layout(v):
        out = torch.zeros(trace_len, dtype=v.dtype, device=b.device)
        out[:last] = v[:last]
        out[last] = v[index]
        return out

    def as_int(v):
        return torch.as_tensor(v, device=b.device).to(torch.int32)

    return (res, layout(res.residual_trace), layout(res.nosl_trace), as_int(res.iterations),
            as_int(res.index), layout)


def fused_kskipcg_solve_2d_reference(
    coef, b, tol, b_norm, k, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, k_max: int, sub=None,
):
    """Plain PyTorch K6: the eager k-skip CG loop from x0 = 0, in K6's
    output layout ``(x, trace, nosl, iters, conv, index)``."""
    res, trace, nosl, iters, index, _ = _plain(
        kskipcg_kernel, coef, b, tol, b_norm, k, stencil, grid, maxiter, k_max, sub
    )
    return res.x, trace, nosl, iters, res.converged, index


def fused_kskipmrr_solve_2d_reference(
    coef, b, tol, b_norm, k, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, k_max: int, adaptive: bool = False, sub=None,
):
    """Plain PyTorch K5: the eager k-skip MrR loop (``adaptive=True``: the
    adaptive one) from x0 = 0, in K5's output layout ``(x, trace, nosl,
    ktrace, iters, conv, index, final_k)``.  The static solve's ktrace holds
    k in its first two slots, as the kernel writes it."""
    loop = adaptivekskipmrr_kernel if adaptive else kskipmrr_kernel
    res, trace, nosl, iters, index, layout = _plain(
        loop, coef, b, tol, b_norm, k, stencil, grid, maxiter, k_max, sub
    )
    if adaptive:
        ktrace, final_k = layout(res.k_trace), res.final_k.to(torch.int32)
    else:
        ktrace = torch.zeros_like(nosl)
        ktrace[:2] = k
        final_k = torch.tensor(k, dtype=torch.int32, device=b.device)
    return res.x, trace, nosl, ktrace, iters, res.converged, index, final_k


def fused_kskipcg_solve_2d(
    coef, b, tol, b_norm, k, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, k_max: int, sub=None,
):
    """Whole k-skip CG solve in one launch.  Returns
    ``(x, trace, nosl, iters, conv, index)``."""
    if b.device.type == "cpu":
        return fused_kskipcg_solve_2d_reference(
            coef, b, tol, b_norm, k, stencil=stencil, grid=grid, maxiter=maxiter, k_max=k_max, sub=sub
        )
    x, trace, nosl, _, stats = _launch(
        "kskipcg", coef, b, tol, b_norm, _check_k(k, k_max), stencil, grid, maxiter, k_max, False, sub
    )
    fused_kskipcg_solve_2d.launches += 1
    return x, trace, nosl, stats[0], stats[1].bool(), stats[2]


def fused_kskipmrr_solve_2d(
    coef, b, tol, b_norm, k, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, k_max: int, adaptive: bool = False, sub=None,
):
    """Whole k-skip MrR (``adaptive=True``: adaptive k-skip MrR) solve in
    one launch.  Returns ``(x, trace, nosl, ktrace, iters, conv, index,
    final_k)``."""
    if b.device.type == "cpu":
        return fused_kskipmrr_solve_2d_reference(
            coef, b, tol, b_norm, k, stencil=stencil, grid=grid, maxiter=maxiter, k_max=k_max,
            adaptive=adaptive, sub=sub,
        )
    x, trace, nosl, ktrace, stats = _launch(
        "kskipmrr", coef, b, tol, b_norm, _check_k(k, k_max), stencil, grid, maxiter, k_max, adaptive, sub
    )
    fused_kskipmrr_solve_2d.launches += 1
    return x, trace, nosl, ktrace, stats[0], stats[1].bool(), stats[2], stats[3]


fused_kskipcg_solve_2d.launches = 0
fused_kskipmrr_solve_2d.launches = 0
