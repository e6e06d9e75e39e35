"""K5/K6: whole-solve k-skip MrR (static or adaptive) and k-skip CG on a
2-D stencil operator in one launch.

The counterparts of :func:`krylov_tpu.kernels.fused_kskip.fused_kskipmrr_solve_2d`
and :func:`~krylov_tpu.kernels.fused_kskip.fused_kskipcg_solve_2d`, with
their signatures and return tuples.  On a CUDA tensor the wrappers launch one
of two routes, as :func:`plan` decides from the grid, the stencil, the
dtype, ``k_max`` and the card's SM count:

- *resident* (``csrc/fused_kskip_resident.cu``): one block an SM at most,
  each owning a band of rows whose state and Krylov bases stay in registers
  and shared memory; neighbour-only halo exchanges and one grid sum an
  outer iteration;
- *streaming* (``csrc/fused_kskip.cu``): a persistent cooperative grid
  whose vectors live in device memory, for systems whose bands do not fit;
  its stencil pass is specialised on the term count where K4's is
  (:func:`krylov_tpu_torch.kernels.fused.pass_terms`: NS = 5 or 7, tiles
  of contiguous points, the weights as arguments), else the masked
  grid-stride pass (NS = 0).

``kernels.fused.ROUTE`` forces a route and ``kernels.fused.MAX_BLOCKS``
caps the grid, as for K2/K3.  A launch or build failure on either route
raises; neither route gives way to the other or to the plain version.  On
a CPU tensor the wrappers run the plain PyTorch versions beside them, which
are the eager loops of :mod:`krylov_tpu_torch.solvers` on the stencil
operator.  Both solve from x0 = 0 (the caller shifts for x0).  ``k`` is a
runtime value in ``[0, k_max]``.  Each wrapper counts its launches in
``launches``, by route in ``launches_resident`` and
``launches_streaming``, its resident launches by K4's specialisation in
``launches_ns0``, ``launches_ns5`` and ``launches_ns7``
(:func:`krylov_tpu_torch.kernels.fused.pass_terms`), and its streaming
launches by their pass in ``launches_streaming_ns0``, ``_ns5`` and
``_ns7``.

Traces have ``min(maxiter, TRACE_CAP) + 2`` slots, indexed by the outer
iteration; a solve past the cap keeps iterating and records in the last
slot.  ``nosl`` holds the solution-update count per outer index and
``ktrace`` (K5) the k per outer index: the adaptive solve writes every
entry, the static one only ``ktrace[0..1] = k``; the rest stays 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.kernels import _build, fused
from krylov_tpu_torch.kernels.stencil import (
    geometry,
    require_cuda,
    stencil_matvec_2d_reference,
)
from krylov_tpu_torch.solvers import adaptivekskipmrr_kernel, kskipcg_kernel, kskipmrr_kernel

_METHOD_CODE = {"kskipcg": 0, "kskipmrr": 1, "probe": 2}
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


def workspace(method: str, dtype: torch.dtype, n: int, k_max: int, ns_pass: int = 0) -> Tuple[int, int, int, int]:
    """``(blocks, work, partials, smem)`` for a streaming solve of ``n``
    points with ``k <= k_max`` and the stencil pass ``ns_pass``
    (:func:`krylov_tpu_torch.kernels.fused.pass_terms`) on the current CUDA
    device: the blocks of the cooperative grid (as many as the kernel of
    that pass fits at once, at most ``fused.MAX_BLOCKS`` when that is set),
    the elements of the two scratch buffers and the bytes of dynamic shared
    memory a block takes, as the C library sizes them.  ``method``
    ``"probe"`` sizes :func:`sweep_probe`'s.  Cached per device."""
    key = (method, dtype, n, k_max, ns_pass, fused.MAX_BLOCKS, torch.cuda.current_device())
    if key not in _workspace:
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        work, partials = ctypes.c_longlong(0), ctypes.c_longlong(0)
        _build.check(
            _build.library().krylov_kskip_workspace(
                _METHOD_CODE[method], dtype.itemsize, n, k_max, fused.MAX_BLOCKS, ns_pass, ctypes.byref(blocks),
                ctypes.byref(work), ctypes.byref(partials), ctypes.byref(smem),
            ),
            "krylov_kskip_workspace",
        )
        _workspace[key] = (blocks.value, work.value, partials.value, smem.value)
    return _workspace[key]


def resident_values(method: str, rows: int, halo: int, g1: int, k_max: int) -> int:
    """Values of dynamic shared memory a resident K5/K6 block takes: two
    mirrors of ``rows + 2 halo`` rows (the stencils' inputs), the band-only
    arrays (K6: x; K5: x, z and pre_x), the per-warp and block bundle sums
    (``(RESIDENT_THREADS / 32 + 1)(6 k_max + 6)``) and the ``2 (k_max + 1)``
    step coefficients (the layout of ``csrc/fused_kskip_resident.cu``)."""
    band_arrays = 1 if method == "kskipcg" else 3
    m = 6 * k_max + 6
    return (2 * (rows + 2 * halo) * g1 + band_arrays * rows * g1
            + (fused.RESIDENT_THREADS // 32 + 1) * m + 2 * (k_max + 1))


def plan(method: str, grid: Tuple[int, int], stencil, dtype: torch.dtype, sms: int, k_max: int,
         max_blocks: int = 0, route: Optional[str] = None) -> fused.Plan:
    """The route and launch shape of a K5 (``"kskipmrr"``) or K6
    (``"kskipcg"``) solve with ``k <= k_max`` on the collapsed ``(g0, g1)``
    grid of a card with ``sms`` SMs.

    Resident: the bands of :func:`krylov_tpu_torch.kernels.fused.resident_bands`
    (one a block, at most one block an SM, at least ``h`` rows each, at
    most 8 points a thread of ``RESIDENT_THREADS``), fitting when
    :func:`resident_values` of them fit ``RESIDENT_SMEM``.  Otherwise
    streaming, whose plan carries no grid (``blocks`` 0): the C library
    sizes it at launch by what the card holds at once, at most
    ``fused.MAX_BLOCKS`` (:func:`workspace`; :func:`device_plan` fills it
    in).  ``max_blocks`` caps the resident grid; ``route`` forces one (a
    resident route that does not fit raises)."""
    if route not in (None, "resident", "streaming"):
        raise ValueError(f"route must be None, 'resident' or 'streaming', got {route!r}")
    if method not in _METHOD_CODE:
        raise ValueError(f"method must be one of {tuple(_METHOD_CODE)}, got {method!r}")
    bands, rows, ppt, h = fused.resident_bands(grid, stencil, sms, max_blocks)
    smem = resident_values(method, rows, h, grid[1], k_max) * dtype.itemsize
    fits = ppt > 0 and smem <= fused.RESIDENT_SMEM
    if route == "resident" and not fits:
        raise ValueError(f"the resident route does not fit grid {grid} in {dtype} at k_max {k_max} ({bands} bands "
                         f"of {rows} rows, {smem} bytes of shared memory a block)")
    if route == "resident" or (route is None and fits):
        return fused.Plan("resident", bands, fused.RESIDENT_THREADS, rows, ppt, h, smem)
    return fused.Plan("streaming", 0, fused.STREAM_THREADS, 0, 0, h, 0)


def device_plan(method: str, grid, stencil, dtype: torch.dtype, k_max: int, device=None,
                is_const: bool = True) -> fused.Plan:
    """:func:`plan` on a CUDA device (the current one by default), with
    ``fused.MAX_BLOCKS`` and ``fused.ROUTE``; a streaming plan carries the
    grid :func:`workspace` sizes on the current device for the pass of the
    stencil's form (``is_const``: the constant-weight one), which its launch
    takes."""
    sms = torch.cuda.get_device_properties(device or torch.cuda.current_device()).multi_processor_count
    p = plan(method, grid, stencil, dtype, sms, k_max, fused.MAX_BLOCKS, fused.ROUTE)
    if p.route == "streaming":
        blocks = workspace(method, dtype, grid[0] * grid[1], k_max, fused.pass_terms(stencil, is_const))[0]
        p = dataclasses.replace(p, blocks=blocks)
    return p


def resident_buffers(p: fused.Plan, grid, k_max: int) -> Tuple[int, int]:
    """16-byte words of the resident route's scratch, both zero at launch:
    the neighbour exchange (2 sets of 2 vectors of ``2 h g1`` words a band)
    and the sums (2 sets of 3 partials a band and 2 of 3 totals for the
    small sums, then 2 sets of ``6 k_max + 6`` a band and 2 of totals for
    the bundle)."""
    m = 6 * k_max + 6
    return max(1, p.blocks * 8 * p.halo * grid[1]), 6 * p.blocks + 6 + 2 * m * (p.blocks + 1)


def _launch(method, coef, b, tol, b_norm, k, stencil, grid, maxiter, k_max, adaptive, sub):
    """Launch the route of the plan; returns ``((x, trace, nosl, ktrace,
    stats), route, ns_pass)``."""
    name = f"fused_{method}_solve_2d"
    require_cuda(name, coef, b, stencil, grid)
    lib = _build.library()
    dt, dev = b.dtype, b.device
    trace_len = trace_length(maxiter)
    with torch.cuda.device(dev):
        p = device_plan(method, grid, stencil, dt, k_max, dev, coef.ndim == 1)
        x = torch.empty_like(b)
        trace = torch.zeros(trace_len, dtype=dt, device=dev)
        nosl = torch.zeros(trace_len, dtype=torch.int32, device=dev)
        ktrace = torch.zeros(trace_len, dtype=torch.int32, device=dev)
        stats = torch.zeros(4, dtype=torch.int32, device=dev)
        scal = torch.stack([tracing.scalar_on(tol, dt, dev), tracing.scalar_on(b_norm, dt, dev)])
        geom = geometry(stencil, grid, sub, coef.ndim == 1)
        outs = (x.data_ptr(), trace.data_ptr(), nosl.data_ptr(), ktrace.data_ptr(), stats.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        ns_pass = None
        if p.route == "resident":
            xbuf_words, partial_words = resident_buffers(p, grid, k_max)
            xbuf = torch.zeros(2 * xbuf_words, dtype=torch.int64, device=dev)
            partials = torch.zeros(2 * partial_words, dtype=torch.int64, device=dev)
            ns_pass, weights = fused.pass_args(coef, b, stencil, grid, sub)
            err = lib.krylov_kskip_resident_solve(
                _METHOD_CODE[method], b.element_size(), p.blocks, p.threads, p.ppt, p.halo, p.smem, k, k_max,
                int(adaptive), coef.data_ptr(), b.data_ptr(), scal.data_ptr(), *outs,
                xbuf.data_ptr(), partials.data_ptr(), *geom, maxiter, trace_len, ns_pass, weights, stream,
            )
        else:
            ns_pass, weights = fused.pass_args(coef, b, stencil, grid, sub)
            _, work_elems, partial_elems, smem = workspace(method, dt, b.numel(), k_max, ns_pass)
            work = torch.empty(work_elems, dtype=dt, device=dev)
            partials = torch.empty(partial_elems, dtype=dt, device=dev)
            err = lib.krylov_kskip_solve(
                _METHOD_CODE[method], b.element_size(), p.blocks, smem, k, k_max, int(adaptive),
                coef.data_ptr(), b.data_ptr(), scal.data_ptr(), *outs, work.data_ptr(), partials.data_ptr(),
                *geom, maxiter, trace_len, ns_pass, weights, stream,
            )
    _build.check(err, f"{name} ({p.route} route)")
    return (x, trace, nosl, ktrace, stats), p.route, ns_pass


SWEEP_MODES = ("stream", "steps", "syncs", "bundle", "pass")  # sweep_probe's modes


def sweep_probe(coef, v, mode: str, k: int, *, stencil, grid, sub=None, ns_pass: Optional[int] = None,
                reps: int = 1) -> torch.Tensor:
    """One kind of the streaming K5's sweeps alone on the card, ``reps``
    times in one cooperative launch (``csrc/fused_kskip.cu``,
    ``kskip_sweep_probe``), for timing it: ``"stream"`` the k + 1 stream
    stages and the bundle reduction, ``"steps"`` the k + 1 steps and the
    pass forming A r, ``"syncs"`` the 2k + 3 grid syncs of an outer
    iteration, ``"bundle"`` the bundle reduction, ``"pass"`` the stencil
    pass alone (A v into the second work vector, a grid sync after it), at
    k on the streaming grid of a K5 solve with the pass ``ns_pass`` (None:
    :func:`krylov_tpu_torch.kernels.fused.pass_terms`'s; 0: the masked pass).  The 11 work vectors start as
    copies of ``v``; returns them, ``(11, n)``: after ``"pass"`` row 1 is
    ``A v``, the pass's own result.  Its launches count toward no wrapper:
    it measures and checks the pieces of K5, which the solves launch."""
    require_cuda("sweep_probe", coef, v, stencil, grid)
    dev, dt = v.device, v.dtype
    with torch.cuda.device(dev):
        if ns_pass is None:
            ns_pass = fused.pass_terms(stencil, coef.ndim == 1)
        weights = fused.host_weights(coef, v, stencil, grid, sub) if ns_pass else None
        # the grid of a K5 solve with this pass, which the probe's own
        # occupancy holds at once
        probe_blocks, work_elems, partial_elems, smem = workspace("probe", dt, v.numel(), k, ns_pass)
        blocks = min(probe_blocks, workspace("kskipmrr", dt, v.numel(), k, ns_pass)[0])
        work = v.repeat(work_elems // v.numel())
        partials = torch.zeros(partial_elems, dtype=dt, device=dev)
        err = _build.library().krylov_kskip_sweep_probe(
            v.element_size(), blocks, smem, SWEEP_MODES.index(mode), k, reps, coef.data_ptr(), work.data_ptr(),
            partials.data_ptr(), *geometry(stencil, grid, sub, coef.ndim == 1), ns_pass, weights,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, f"sweep_probe ({mode}, NS = {ns_pass})")
    return work.view(-1, v.numel())


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
    with tracing.span("launch"):
        (x, trace, nosl, _, stats), route, ns_pass = _launch(
            "kskipcg", coef, b, tol, b_norm, _check_k(k, k_max), stencil, grid, maxiter, k_max, False, sub
        )
    fused._count(fused_kskipcg_solve_2d, route, ns_pass)
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
    with tracing.span("launch"):
        (x, trace, nosl, ktrace, stats), route, ns_pass = _launch(
            "kskipmrr", coef, b, tol, b_norm, _check_k(k, k_max), stencil, grid, maxiter, k_max, adaptive, sub
        )
    fused._count(fused_kskipmrr_solve_2d, route, ns_pass)
    return x, trace, nosl, ktrace, stats[0], stats[1].bool(), stats[2], stats[3]


for _fn in (fused_kskipcg_solve_2d, fused_kskipmrr_solve_2d):
    fused.reset_counts(_fn)
