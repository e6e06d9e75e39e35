"""K2/K3: whole-solve MrR and CG on a 2-D stencil operator in one launch.

The counterparts of :func:`krylov_tpu.kernels.fused.fused_mrr_solve_2d` and
:func:`~krylov_tpu.kernels.fused.fused_cg_solve_2d`.  On a CUDA tensor the
wrappers launch one of two routes, as :func:`plan` decides from the grid,
the stencil, the dtype and the card's SM count:

- *resident* (``csrc/fused_resident.cu``): one block an SM at most, each
  owning a band of rows whose solver state stays in registers and shared
  memory; two grid syncs an iteration;
- *streaming* (``csrc/fused.cu``): grid-stride kernels whose vectors live
  in device memory, for systems whose bands do not fit; three grid syncs an
  iteration, 4 blocks an SM.

A launch or build failure on either route raises; neither route gives way
to the other or to the plain version.  On a CPU tensor the wrappers run the
plain PyTorch versions beside them.  x0 is handled by the caller through
the shift ``A (x0 + dx) = b  =>  A dx = b - A x0``, so both solve from zero.

Each returns ``(x, trace, iters, conv)``: ``trace`` has
``min(maxiter, TRACE_CAP) + 1`` slots and a solve running past the cap
keeps iterating, recording its residuals in the last slot.  Each wrapper
counts its launches in ``launches``, and by route in ``launches_resident``
and ``launches_streaming``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

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
# each route at its plan (set by diagnostics/grid_sweep.py)
MAX_BLOCKS = 0
# "resident" or "streaming" forces the route of K2/K3 and K5/K6, read at
# call time; None takes the plan's (a forced resident route raises where it
# does not fit)
ROUTE: Optional[str] = None

RESIDENT_THREADS = 512  # threads a resident block (kResThreads in fused_resident.cu)
RESIDENT_PPT = (1, 2, 4, 8)  # points a thread the resident kernels are built for
RESIDENT_MAX_BLOCKS = 160  # most bands the grid sums take (kResMaxBlocks)
# dynamic shared memory a resident block may take: the 232,448 bytes a
# Hopper block may use, less 1 KiB for the kernels' static shared memory
RESIDENT_SMEM = 232_448 - 1024
STREAM_THREADS = 256  # kThreads in reduce.cuh
STREAM_BLOCKS_PER_SM = 4  # the streaming grid (PERF.md: the grid-size sweep)

_METHOD_CODE = {"cg": 0, "mrr": 1}
_workspace = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a fused K2/K3 solve runs on the card.

    ``route`` is ``"resident"`` or ``"streaming"``; ``blocks`` the
    cooperative grid; ``threads`` a block.  On the resident route
    ``rows`` is the most rows a band holds, ``ppt`` the points a thread
    owns and ``smem`` the dynamic shared memory a block takes, in bytes
    (0 on the streaming route).  ``halo`` is ``h = max |d0|``."""

    route: str
    blocks: int
    threads: int
    rows: int
    ppt: int
    halo: int
    smem: int


def band_rows(g0: int, blocks: int):
    """``(first row, rows)`` of each band when ``g0`` rows are split among
    ``blocks`` (the split of ``band_of`` in ``csrc/fused_resident.cu``)."""
    base, extra = divmod(g0, blocks)
    return [(b * base + min(b, extra), base + (b < extra)) for b in range(blocks)]


def resident_bands(grid: Tuple[int, int], stencil, sms: int, max_blocks: int = 0) -> Tuple[int, int, int, int]:
    """``(bands, rows, ppt, h)`` of the resident route of K2/K3/K5/K6 on the
    collapsed ``(g0, g1)`` grid: one band of contiguous rows a block, at
    most one block an SM (and ``max_blocks``, if set) and at least
    ``h = max |d0|`` rows a band, so halos come from the two neighbours
    alone; ``rows`` the most rows a band holds and ``ppt`` the fewest
    points a thread of ``RESIDENT_THREADS`` that hold them (0 if 8 do
    not)."""
    g0, g1 = grid
    h = max(abs(d[0]) for d in stencil)
    bands = max(1, min(sms, RESIDENT_MAX_BLOCKS, g0 // max(h, 1), max_blocks or sms))
    rows = -(-g0 // bands)
    ppt = next((p for p in RESIDENT_PPT if p * RESIDENT_THREADS >= rows * g1), 0)
    return bands, rows, ppt, h


def plan(method: str, grid: Tuple[int, int], stencil, dtype: torch.dtype, sms: int,
         max_blocks: int = 0, route: Optional[str] = None) -> Plan:
    """The route and launch shape of a K2 (``"mrr"``) or K3 (``"cg"``)
    solve on the collapsed ``(g0, g1)`` grid of a card with ``sms`` SMs.

    Resident: the bands of :func:`resident_bands`; it fits when a band's
    points fit ``RESIDENT_THREADS`` threads of at most 8 points each and
    its shared memory (the mirror of band and ``2 h`` halo rows, and x;
    MrR also a halo copy of y and z) fits ``RESIDENT_SMEM``.  Otherwise
    streaming: ``STREAM_BLOCKS_PER_SM`` blocks an SM, no more than the
    points need.  ``max_blocks`` caps either grid; ``route`` forces one."""
    if route not in (None, "resident", "streaming"):
        raise ValueError(f"route must be None, 'resident' or 'streaming', got {route!r}")
    g0, g1 = grid
    bands, rows, ppt, h = resident_bands(grid, stencil, sms, max_blocks)
    # the mirror (band and 2 h halo rows) and x; MrR also y's halo and z
    smem = ((rows + 2 * h) * g1 + rows * g1 + ((2 * h + rows) * g1 if method == "mrr" else 0)) * dtype.itemsize
    fits = ppt > 0 and smem <= RESIDENT_SMEM
    if route == "resident" and not fits:
        raise ValueError(f"the resident route does not fit grid {grid} in {dtype} ({bands} bands of {rows} rows, "
                         f"{smem} bytes of shared memory a block)")
    if route == "resident" or (route is None and fits):
        return Plan("resident", bands, RESIDENT_THREADS, rows, ppt, h, smem)
    need = -(-g0 * g1 // STREAM_THREADS)
    blocks = max(1, min(STREAM_BLOCKS_PER_SM * sms, need, max_blocks or need))
    return Plan("streaming", blocks, STREAM_THREADS, 0, 0, h, 0)


def device_plan(method: str, grid, stencil, dtype: torch.dtype, device=None) -> Plan:
    """:func:`plan` on a CUDA device (the current one by default), with
    ``MAX_BLOCKS`` and ``ROUTE``."""
    sms = torch.cuda.get_device_properties(device or torch.cuda.current_device()).multi_processor_count
    return plan(method, grid, stencil, dtype, sms, MAX_BLOCKS, ROUTE)


def workspace(method: str, dtype: torch.dtype, n: int, max_blocks: int) -> Tuple[int, int, int]:
    """``(blocks, work, partials)`` of a streaming solve of ``n`` points on
    the current CUDA device: the blocks of the cooperative grid (at most
    ``max_blocks``, all co-resident) and the elements of the two scratch
    buffers, as the C library sizes them.  Cached per device."""
    key = (method, dtype, n, max_blocks, torch.cuda.current_device())
    if key not in _workspace:
        blocks, work, partials = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_longlong(0)
        _build.check(
            _build.library().krylov_fused_workspace(
                _METHOD_CODE[method], dtype.itemsize, n, max_blocks,
                ctypes.byref(blocks), ctypes.byref(work), ctypes.byref(partials),
            ),
            "krylov_fused_workspace",
        )
        _workspace[key] = (blocks.value, work.value, partials.value)
    return _workspace[key]


def resident_buffers(p: Plan, grid) -> Tuple[int, int]:
    """16-byte words of the resident route's scratch, both zero at launch:
    the edge-row exchange (``2 h g1`` a block) and the sums (2 sets of 3
    partials a block, then 2 sets of 3 totals)."""
    return max(1, p.blocks * 2 * p.halo * grid[1]), 6 * p.blocks + 6


def _launch(method, coef, b, tol, b_norm, stencil, grid, maxiter, sub):
    """Launch the route of the plan; returns ``((x, trace, iters, conv), route)``."""
    require_cuda(f"fused_{method}_solve_2d", coef, b, stencil, grid)
    lib = _build.library()
    dt, dev = b.dtype, b.device
    trace_len = min(maxiter, TRACE_CAP) + 1
    with torch.cuda.device(dev):
        p = device_plan(method, grid, stencil, dt, dev)
        x = torch.empty_like(b)
        trace = torch.zeros(trace_len, dtype=dt, device=dev)
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
        scal = torch.stack([
            torch.as_tensor(tol, dtype=dt, device=dev),
            torch.as_tensor(b_norm, dtype=dt, device=dev),
        ])
        geom = geometry(stencil, grid, sub, coef.ndim == 1)
        stream = torch.cuda.current_stream().cuda_stream
        if p.route == "resident":
            xbuf_words, partial_words = resident_buffers(p, grid)
            xbuf = torch.zeros(2 * xbuf_words, dtype=torch.int64, device=dev)
            partials = torch.zeros(2 * partial_words, dtype=torch.int64, device=dev)
            err = lib.krylov_resident_solve(
                _METHOD_CODE[method], b.element_size(), p.blocks, p.threads, p.ppt, p.halo, p.smem,
                coef.data_ptr(), b.data_ptr(), scal.data_ptr(), x.data_ptr(), trace.data_ptr(),
                stats.data_ptr(), xbuf.data_ptr(), partials.data_ptr(), *geom, maxiter, trace_len, stream,
            )
        else:
            blocks, work_elems, partial_elems = workspace(method, dt, b.numel(), p.blocks)
            work = torch.empty(work_elems, dtype=dt, device=dev)
            partials = torch.empty(partial_elems, dtype=dt, device=dev)
            err = lib.krylov_fused_solve(
                _METHOD_CODE[method], b.element_size(), blocks,
                coef.data_ptr(), b.data_ptr(), scal.data_ptr(), x.data_ptr(),
                trace.data_ptr(), stats.data_ptr(), work.data_ptr(), partials.data_ptr(),
                *geom, maxiter, trace_len, stream,
            )
    _build.check(err, f"fused_{method}_solve_2d ({p.route} route)")
    return (x, trace, stats[0], stats[1].bool()), p.route


def _count(fn, route: str) -> None:
    fn.launches += 1
    setattr(fn, f"launches_{route}", getattr(fn, f"launches_{route}") + 1)


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
    out, route = _launch("cg", coef, b, tol, b_norm, stencil, grid, maxiter, sub)
    _count(fused_cg_solve_2d, route)
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
    out, route = _launch("mrr", coef, b, tol, b_norm, stencil, grid, maxiter, sub)
    _count(fused_mrr_solve_2d, route)
    return out


for _fn in (fused_cg_solve_2d, fused_mrr_solve_2d):
    _fn.launches = _fn.launches_resident = _fn.launches_streaming = 0
