"""K2/K3: whole-solve MrR and CG on a 2-D stencil operator in one launch.

The counterparts of :func:`krylov_tpu.kernels.fused.fused_mrr_solve_2d` and
:func:`~krylov_tpu.kernels.fused.fused_cg_solve_2d`.  On a CUDA tensor the
wrappers launch the persistent cooperative kernels of ``csrc/fused.cu``
(the stencil inside them is the shared device function of
``csrc/stencil.cuh``); on a CPU tensor they run the plain PyTorch versions
beside them.  x0 is handled by the caller through the shift
``A (x0 + dx) = b  =>  A dx = b - A x0``, so both solve from zero.

Each returns ``(x, trace, iters, conv)``: ``trace`` has
``min(maxiter, TRACE_CAP) + 1`` slots and a solve running past the cap
keeps iterating, recording its residuals in the last slot.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from krylov_tpu_torch.kernels import _build
from krylov_tpu_torch.kernels.stencil import (
    geometry,
    require_cuda,
    stencil_matvec_2d_reference,
)
from krylov_tpu_torch.solvers._common import safe_div

TRACE_CAP = 65536
# cap on the cooperative grid of K2/K3/K5/K6, read at call time; 0 leaves
# it at the occupancy limit (set by diagnostics/grid_sweep.py)
MAX_BLOCKS = 0

_METHOD_CODE = {"cg": 0, "mrr": 1}
_workspace = {}


def workspace(method: str, dtype: torch.dtype, n: int) -> Tuple[int, int, int]:
    """``(blocks, work, partials)`` for a solve of ``n`` points on the
    current CUDA device: the blocks of the cooperative grid (all
    co-resident, at most ``MAX_BLOCKS`` when that is set) and the elements
    of the two scratch buffers, as the C library sizes them.  Cached per
    device."""
    key = (method, dtype, n, MAX_BLOCKS, torch.cuda.current_device())
    if key not in _workspace:
        blocks, work, partials = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_longlong(0)
        _build.check(
            _build.library().krylov_fused_workspace(
                _METHOD_CODE[method], dtype.itemsize, n, MAX_BLOCKS,
                ctypes.byref(blocks), ctypes.byref(work), ctypes.byref(partials),
            ),
            "krylov_fused_workspace",
        )
        _workspace[key] = (blocks.value, work.value, partials.value)
    return _workspace[key]


def _launch(method, coef, b, tol, b_norm, stencil, grid, maxiter, sub):
    require_cuda(f"fused_{method}_solve_2d", coef, b, stencil, grid)
    lib = _build.library()
    dt, dev = b.dtype, b.device
    trace_len = min(maxiter, TRACE_CAP) + 1
    with torch.cuda.device(dev):
        blocks, work_elems, partial_elems = workspace(method, dt, b.numel())
        x = torch.empty_like(b)
        trace = torch.zeros(trace_len, dtype=dt, device=dev)
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
        work = torch.empty(work_elems, dtype=dt, device=dev)
        partials = torch.empty(partial_elems, dtype=dt, device=dev)
        scal = torch.stack([
            torch.as_tensor(tol, dtype=dt, device=dev),
            torch.as_tensor(b_norm, dtype=dt, device=dev),
        ])
        err = lib.krylov_fused_solve(
            _METHOD_CODE[method], b.element_size(), blocks,
            coef.data_ptr(), b.data_ptr(), scal.data_ptr(), x.data_ptr(),
            trace.data_ptr(), stats.data_ptr(), work.data_ptr(), partials.data_ptr(),
            *geometry(stencil, grid, sub, coef.ndim == 1), maxiter, trace_len,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, f"fused_{method}_solve_2d")
    return x, trace, stats[0], stats[1].bool()


def _scalars(b, tol, b_norm):
    dt, dev = b.dtype, b.device
    return torch.as_tensor(tol, dtype=dt, device=dev), torch.as_tensor(b_norm, dtype=dt, device=dev)


def fused_cg_solve_2d_reference(
    coef, b, tol, b_norm, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, sub=None,
):
    """Plain PyTorch K3: the whole CG solve from x0 = 0."""
    tol, b_norm = _scalars(b, tol, b_norm)
    trace_len = min(maxiter, TRACE_CAP) + 1
    trace = torch.zeros(trace_len, dtype=b.dtype, device=b.device)
    r, p, x = b, b, torch.zeros_like(b)
    gamma = torch.sum(b * b)
    i, conv = 0, False
    while i < maxiter:
        res = torch.sqrt(gamma) / b_norm
        trace[min(i, trace_len - 1)] = res
        if bool(res < tol):
            conv = True
            break
        v = stencil_matvec_2d_reference(coef, p, stencil=stencil, grid=grid, sub=sub)
        alpha = safe_div(gamma, torch.sum(p * v))
        x = x + alpha * p
        r = r - alpha * v
        gamma_new = torch.sum(r * r)
        p = r + safe_div(gamma_new, gamma) * p
        gamma = gamma_new
        i += 1
    if not conv:  # diverged exit writes the final residual
        trace[min(i, trace_len - 1)] = torch.sqrt(gamma) / b_norm
    return x, trace, torch.tensor(i, dtype=torch.int32, device=b.device), torch.tensor(conv, device=b.device)


def fused_mrr_solve_2d_reference(
    coef, b, tol, b_norm, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, sub=None,
):
    """Plain PyTorch K2: the whole MrR solve from x0 = 0."""
    tol, b_norm = _scalars(b, tol, b_norm)
    trace_len = min(maxiter, TRACE_CAP) + 1
    trace = torch.zeros(trace_len, dtype=b.dtype, device=b.device)

    def A(v):
        return stencil_matvec_2d_reference(coef, v, stencil=stencil, grid=grid, sub=sub)

    # init half-iteration on r0 = b
    r = b
    trace[0] = torch.sqrt(torch.sum(r * r)) / b_norm
    Ar = A(r)
    zeta = safe_div(torch.sum(r * Ar), torch.sum(Ar * Ar))
    y = zeta * Ar
    z = -zeta * r
    r = r - y
    x = -z
    i, conv = 1, False
    while i < maxiter:
        res = torch.sqrt(torch.sum(r * r)) / b_norm
        trace[min(i, trace_len - 1)] = res
        if bool(res < tol):
            conv = True
            break
        Ar = A(r)
        gamma = safe_div(torch.sum(y * Ar), torch.sum(y * y))
        s = Ar - gamma * y
        zeta = safe_div(torch.sum(r * s), torch.sum(s * s))
        eta = -zeta * gamma
        y = eta * y + zeta * Ar
        z = eta * z - zeta * r
        r = r - y
        x = x - z
        i += 1
    if not conv:  # diverged exit writes the final residual
        trace[min(i, trace_len - 1)] = torch.sqrt(torch.sum(r * r)) / b_norm
    return x, trace, torch.tensor(i, dtype=torch.int32, device=b.device), torch.tensor(conv, device=b.device)


def fused_cg_solve_2d(
    coef, b, tol, b_norm, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, sub=None,
):
    """Whole CG solve in one launch.  Returns ``(x, trace, iters, conv)``."""
    if b.device.type == "cpu":
        return fused_cg_solve_2d_reference(
            coef, b, tol, b_norm, stencil=stencil, grid=grid, maxiter=maxiter, sub=sub
        )
    out = _launch("cg", coef, b, tol, b_norm, stencil, grid, maxiter, sub)
    fused_cg_solve_2d.launches += 1
    return out


def fused_mrr_solve_2d(
    coef, b, tol, b_norm, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], maxiter: int, sub=None,
):
    """Whole MrR solve in one launch.  Returns ``(x, trace, iters, conv)``."""
    if b.device.type == "cpu":
        return fused_mrr_solve_2d_reference(
            coef, b, tol, b_norm, stencil=stencil, grid=grid, maxiter=maxiter, sub=sub
        )
    out = _launch("mrr", coef, b, tol, b_norm, stencil, grid, maxiter, sub)
    fused_mrr_solve_2d.launches += 1
    return out


fused_cg_solve_2d.launches = 0
fused_mrr_solve_2d.launches = 0
