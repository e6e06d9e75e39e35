"""K2/K3: whole-solve MrR and CG on a 2-D stencil operator in one launch.

The counterparts of :func:`krylov_tpu.kernels.fused.fused_mrr_solve_2d` and
:func:`~krylov_tpu.kernels.fused.fused_cg_solve_2d`.  On a CUDA tensor the
wrappers launch one of two routes, as :func:`plan` decides from the grid,
the stencil, the dtype and the card's SM count:

- *resident* (``csrc/fused_resident.cu``): one block an SM at most, each
  owning a band of rows whose solver state stays in registers and shared
  memory; two grid syncs an iteration;
- *streaming* (``csrc/fused.cu``): persistent cooperative kernels whose
  vectors live in device memory, for systems whose bands do not fit
  (every 2-D system above about 0.54M points, every 3-D one from 65^3
  up); ``STREAM_BLOCKS_PER_SM`` blocks an SM as their occupancy allows;
  their stencil pass specialised on the term count as K4's is
  (:func:`pass_terms`), on tiles of 16-byte chunks of a row or one point a
  thread, else the masked pass on the grid-stride walk.  Each instance
  (method, pass, dtype) is built in one form (``STREAM_FORMS``: the words
  a point an iteration it moves, :func:`stream_words`, and its grid syncs)
  on one walk (``STREAM_WALKS``), ``STREAM_SHIPPED``'s.

A launch or build failure on either route raises; neither route gives way
to the other or to the plain version.  On a CPU tensor the wrappers run the
plain PyTorch versions beside them.  x0 is handled by the caller through
the shift ``A (x0 + dx) = b  =>  A dx = b - A x0``, so both solve from zero.

Each returns ``(x, trace, iters, conv)``: ``trace`` has
``min(maxiter, TRACE_CAP) + 1`` slots and a solve running past the cap
keeps iterating, recording its residuals in the last slot.  Each wrapper
counts its launches in ``launches``, and by route in ``launches_resident``
and ``launches_streaming``; its resident launches also by the
specialisation of K4, the stencil pass inside them (:func:`pass_terms`), in
``launches_ns0``, ``launches_ns5`` and ``launches_ns7``, and its streaming
ones by their pass in ``launches_streaming_ns0`` and so on.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.kernels import _build
from krylov_tpu_torch.kernels.stencil import (
    geometry,
    host_weights,
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
STREAM_BLOCKS_PER_SM = 4  # the streaming grid, as the kernels' occupancy allows (PERF.md: the grid-size sweep)
# the forms of the streaming route by method, in the order of their codes
# in csrc/fused.cu: CG "three-pass" (v = A p, the x/r update, p = r + beta
# p and a grid sync: 3 syncs) and "stored" (p = r + beta p_prev formed in
# the stencil pass wherever it is read, A p stored by it: 2 syncs); MrR
# "stored" (A r stored and read back)
STREAM_FORMS = {"cg": ("three-pass", "stored"), "mrr": ("stored",)}
# the walks, in the order of their codes in csrc/fused.cu: one point a
# thread on the grid-stride walk (the masked pass's walk too), tiles of
# 16-byte chunks of a row built for four blocks an SM, the same built for
# two
STREAM_WALKS = ("points", "tiles-4", "tiles")
# the (form, walk) each streaming instance is built in, by method, pass
# (pass_terms) and dtype, as csrc/fused.cu's kFormOf and kWalkOf build it
# (a launch that names another pair raises): the fastest of the grid sweep
# at N = 2.25M (NS 5) and at BASELINE row 5 (NS 7) on an H100 among those
# that spill no more than the three-pass CG and stored MrR on one point a
# thread (PERF.md); the masked pass (NS 0) takes those
STREAM_SHIPPED = {
    **{(m, 0, dt): (f, "points") for m, f in (("cg", "three-pass"), ("mrr", "stored"))
       for dt in (torch.float64, torch.float32)},
    ("cg", 5, torch.float64): ("stored", "points"),
    ("cg", 5, torch.float32): ("three-pass", "points"),
    ("cg", 7, torch.float64): ("stored", "tiles-4"),
    ("cg", 7, torch.float32): ("stored", "tiles-4"),
    ("mrr", 5, torch.float64): ("stored", "points"),
    ("mrr", 5, torch.float32): ("stored", "points"),
    ("mrr", 7, torch.float64): ("stored", "tiles-4"),
    ("mrr", 7, torch.float32): ("stored", "tiles"),
}
# the passes of each form (the pass probe's, stream_probe), and the words a
# point each moves, every vector it reads or writes once, a stencil's
# neighbours as cache hits
FORM_PASSES = {
    ("cg", "three-pass"): ("stencil", "update", "direction"),
    ("cg", "stored"): ("form-store", "update"),
    ("mrr", "stored"): ("sums-y", "sums-s", "update"),
}
# the pass probe's passes by method, in the order of their codes in
# csrc/fused.cu (k23_pass_probe), with the work vectors w0..w4 each reads
# and writes
PROBE_PASSES = {
    "cg": ("stencil",  # v = A p: p w1 -> v w3
           "update",  # x += alpha p, r -= alpha v: p w1, v w3, x w4, r w0
           "direction",  # p = r + beta p: r w0, p w1
           "form-store"),  # p = r + beta q formed where read: r w0, q w1 -> p w2, and A p -> v w3
    "mrr": ("sums-y",  # Ar = A r, <y,y>, <y,Ar>: r w0, y w1 -> Ar w3
            "sums-s",  # <r,s>, <s,s>: r w0, y w1, Ar w3
            "update"),  # y, z, r (in place), x: w1, w2, w0, w4, Ar w3
}
PASS_WORDS = {
    ("cg", "stencil"): 2, ("cg", "update"): 6, ("cg", "direction"): 3, ("cg", "form-store"): 4,
    ("mrr", "sums-y"): 3, ("mrr", "sums-s"): 3, ("mrr", "update"): 9,
}

# term counts of the specialised resident stencil pass, K4 (the NS of
# stencil_pass in csrc/resident.cuh; 0 is the masked pass)
PASS_TERMS = (5, 7)

_METHOD_CODE = {"cg": 0, "mrr": 1}
_workspace = {}


def stream_shape(method: str, ns_pass: int, dtype: torch.dtype) -> Tuple[str, str]:
    """``(form, walk)`` of a streaming K3 (``"cg"``) or K2 (``"mrr"``)
    launch with the stencil pass ``ns_pass`` in ``dtype``:
    ``STREAM_SHIPPED``'s."""
    return STREAM_SHIPPED[method, ns_pass, dtype]


def stream_words(method: str, form: str) -> int:
    """Words a point that one iteration of the streaming K3 (``"cg"``) or
    K2 (``"mrr"``) moves in ``form``, every
    vector a pass reads or writes counted once and a stencil's neighbours
    as cache hits, pass by pass:

    - CG three-pass: v = A p (p read, v written: 2); the update (x, p, r, v
      read, x, r written: 6); p = r + beta p (r, p read, p written: 3); 11.
    - CG stored: p = r + beta p_prev with A p (r, p_prev read, p and v
      written: 4); the update (6); 10.
    - MrR stored: A r with <y,y>, <y,Ar> (r, y read, Ar written: 3); <r,s>,
      <s,s> (Ar, r, y read: 3); the update (Ar, r, y, z, x read, y, z, r, x
      written: 9); 15."""
    return sum(PASS_WORDS[method, name] for name in FORM_PASSES[method, form])


def pass_terms(stencil, is_const: bool) -> int:
    """K4's specialisation for a stencil on the collapsed grid: its term
    count where the constant form has 5 terms (the 2-D 5-point stencil) or
    7 (the collapsed 3-D 7-point one), else 0, the masked pass (the
    grid-coefficient form, other counts)."""
    return len(stencil) if is_const and len(stencil) in PASS_TERMS else 0


def pass_args(coef, b, stencil, grid, sub) -> tuple:
    """``(ns_pass, weights)`` of a resident launch: K4's specialisation and,
    for a specialised one, the constant weights on the host (else None)."""
    ns_pass = pass_terms(stencil, coef.ndim == 1)
    return ns_pass, host_weights(coef, b, stencil, grid, sub) if ns_pass else None


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


def workspace(method: str, dtype: torch.dtype, n: int, max_blocks: int, ns_pass: int = 0,
              probe: bool = False) -> Tuple[int, int, int]:
    """``(blocks, work, partials)`` of a streaming solve of ``n`` points
    (``probe``: of the pass probe) with the stencil pass ``ns_pass``
    (:func:`pass_terms`) in :func:`stream_shape`'s form and walk on the
    current CUDA device: the blocks of the cooperative grid (at most
    ``max_blocks``, all co-resident) and the elements of the two scratch
    buffers, as the C library sizes them.  Cached per device."""
    form, walk = stream_shape(method, ns_pass, dtype)
    code = -1 if probe else STREAM_FORMS[method].index(form)
    walk_code = STREAM_WALKS.index(walk)
    key = (method, code, walk_code, dtype, n, max_blocks, ns_pass, torch.cuda.current_device())
    if key not in _workspace:
        blocks, work, partials = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_longlong(0)
        _build.check(
            _build.library().krylov_fused_workspace(
                _METHOD_CODE[method], code, walk_code, dtype.itemsize, n, max_blocks, ns_pass,
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
    """Launch the route of the plan; returns ``((x, trace, iters, conv),
    route, ns_pass)``."""
    require_cuda(f"fused_{method}_solve_2d", coef, b, stencil, grid)
    lib = _build.library()
    dt, dev = b.dtype, b.device
    trace_len = min(maxiter, TRACE_CAP) + 1
    with torch.cuda.device(dev):
        p = device_plan(method, grid, stencil, dt, dev)
        x = torch.empty_like(b)
        trace = torch.zeros(trace_len, dtype=dt, device=dev)
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
        scal = torch.stack([tracing.scalar_on(tol, dt, dev), tracing.scalar_on(b_norm, dt, dev)])
        geom = geometry(stencil, grid, sub, coef.ndim == 1)
        stream = torch.cuda.current_stream().cuda_stream
        ns_pass = None
        if p.route == "resident":
            xbuf_words, partial_words = resident_buffers(p, grid)
            xbuf = torch.zeros(2 * xbuf_words, dtype=torch.int64, device=dev)
            partials = torch.zeros(2 * partial_words, dtype=torch.int64, device=dev)
            ns_pass, weights = pass_args(coef, b, stencil, grid, sub)
            err = lib.krylov_resident_solve(
                _METHOD_CODE[method], b.element_size(), p.blocks, p.threads, p.ppt, p.halo, p.smem,
                coef.data_ptr(), b.data_ptr(), scal.data_ptr(), x.data_ptr(), trace.data_ptr(),
                stats.data_ptr(), xbuf.data_ptr(), partials.data_ptr(), *geom, maxiter, trace_len, ns_pass,
                weights, stream,
            )
        else:
            ns_pass, weights = pass_args(coef, b, stencil, grid, sub)
            form, walk = stream_shape(method, ns_pass, dt)
            blocks, work_elems, partial_elems = workspace(method, dt, b.numel(), p.blocks, ns_pass)
            work = torch.empty(work_elems, dtype=dt, device=dev)
            partials = torch.empty(partial_elems, dtype=dt, device=dev)
            err = lib.krylov_fused_solve(
                _METHOD_CODE[method], STREAM_FORMS[method].index(form), STREAM_WALKS.index(walk),
                b.element_size(), blocks,
                coef.data_ptr(), b.data_ptr(), scal.data_ptr(), x.data_ptr(),
                trace.data_ptr(), stats.data_ptr(), work.data_ptr(), partials.data_ptr(),
                *geom, maxiter, trace_len, ns_pass, weights, stream,
            )
    _build.check(err, f"fused_{method}_solve_2d ({p.route} route)")
    return (x, trace, stats[0], stats[1].bool()), p.route, ns_pass


def stencil_pass_probe(coef, x, *, stencil, grid, sub=None, ns_pass: Optional[int] = None, split: bool = False,
                       reps: int = 1):
    """K4 alone on the card (``csrc/resident_probe.cu``): ``reps`` resident
    stencil passes over ``x`` on the bands of the resident plan of this
    grid (:func:`resident_bands`, ``MAX_BLOCKS`` applied), each block's
    band and halo rows mirrored in shared memory, a ``__syncthreads`` after
    each pass as in the solves.  ``ns_pass`` is K4's specialisation (None:
    :func:`pass_terms`'s; 0: the masked pass); ``split`` takes its split
    form of 2 points at a time, as K6 takes it in float32
    (``csrc/resident.cuh``: the test-free loads of slices whose terms are
    all on the grid), instead of the predicated one.  Returns ``(y, sums, cycles)``: the last pass's
    ``A x``, the sum of the passes at every point, and each band's clock
    cycles over the passes (int64).  Its
    launches count toward no wrapper: it measures and checks K4, which the
    solves launch."""
    require_cuda("stencil_pass_probe", coef, x, stencil, grid)
    dev = x.device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        bands, _, ppt, h = resident_bands(grid, stencil, sms, MAX_BLOCKS)
        if ppt == 0:
            raise ValueError(f"stencil_pass_probe: grid {grid} does not fit the resident plan")
        if ns_pass is None:
            ns_pass = pass_terms(stencil, coef.ndim == 1)
        weights = host_weights(coef, x, stencil, grid, sub) if ns_pass else None
        y, sums = torch.empty_like(x), torch.empty_like(x)
        cycles = torch.zeros(bands, dtype=torch.int64, device=dev)
        err = _build.library().krylov_stencil_probe(
            x.element_size(), ns_pass, int(split), bands, ppt, h, coef.data_ptr(), x.data_ptr(), y.data_ptr(),
            sums.data_ptr(), cycles.data_ptr(), *geometry(stencil, grid, sub, coef.ndim == 1), weights, reps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, f"stencil_pass_probe (NS = {ns_pass}{', split' if split else ''})")
    return y, sums, cycles


def stream_probe(coef, v, method: str, pass_name: str, *, stencil, grid, sub=None, ns_pass: Optional[int] = None,
                 reps: int = 1) -> torch.Tensor:
    """One pass of the streaming K3 (``method="cg"``) or K2 (``"mrr"``)
    alone on the card, ``reps`` times in one cooperative launch, each
    ending in its grid sum as in a solve (``csrc/fused.cu``,
    ``k23_pass_probe``), at fixed coefficients (beta, gamma, zeta 0.5;
    alpha 0.25; eta -0.25), for timing it: ``pass_name`` one of
    ``PROBE_PASSES[method]``, on the walk and grid of a streaming solve
    with the pass ``ns_pass`` (None: :func:`pass_terms`'s; 0: the masked
    pass).  The 5 work vectors start as copies of ``v``; returns them,
    ``(5, n)``: after one ``"stencil"`` pass row 3 is ``A v``, after
    ``"form-store"`` row 2 is ``p = v + 0.5 v`` and row 3 ``A p``, after
    ``"sums-y"`` row 3 is ``A v``.  Its launches count toward no wrapper:
    it measures and checks the passes of K2/K3, which the solves launch."""
    require_cuda("stream_probe", coef, v, stencil, grid)
    dev, dt = v.device, v.dtype
    with torch.cuda.device(dev):
        if ns_pass is None:
            ns_pass = pass_terms(stencil, coef.ndim == 1)
        weights = host_weights(coef, v, stencil, grid, sub) if ns_pass else None
        # the grid of a streaming solve with this pass, which the probe's
        # own occupancy holds at once
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream_blocks = plan(method, grid, stencil, dt, sms, MAX_BLOCKS, "streaming").blocks
        solve_blocks = workspace(method, dt, v.numel(), stream_blocks, ns_pass)[0]
        blocks, work_elems, partial_elems = workspace(method, dt, v.numel(), solve_blocks, ns_pass, probe=True)
        walk = stream_shape(method, ns_pass, dt)[1]
        work = v.repeat(work_elems // v.numel())
        partials = torch.zeros(partial_elems, dtype=dt, device=dev)
        err = _build.library().krylov_fused_pass_probe(
            _METHOD_CODE[method], PROBE_PASSES[method].index(pass_name), STREAM_WALKS.index(walk),
            v.element_size(), blocks, reps,
            coef.data_ptr(), work.data_ptr(), partials.data_ptr(), *geometry(stencil, grid, sub, coef.ndim == 1),
            ns_pass, weights, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, f"stream_probe ({method} {pass_name}, NS = {ns_pass}, walk {walk})")
    return work.view(-1, v.numel())


def _count(fn, route: str, ns_pass) -> None:
    """One launch of ``fn`` on ``route``; a resident one also under its K4
    specialisation ``ns_pass``, a streaming one that names its pass under
    ``launches_streaming_ns{ns_pass}``."""
    fn.launches += 1
    setattr(fn, f"launches_{route}", getattr(fn, f"launches_{route}") + 1)
    if route == "resident":
        setattr(fn, f"launches_ns{ns_pass}", getattr(fn, f"launches_ns{ns_pass}") + 1)
    elif ns_pass is not None:
        setattr(fn, f"launches_streaming_ns{ns_pass}", getattr(fn, f"launches_streaming_ns{ns_pass}") + 1)


def reset_counts(fn) -> None:
    """Set every launch count of the fused wrapper ``fn`` to 0."""
    for name in COUNTS:
        setattr(fn, name, 0)


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
    with tracing.span("launch"):
        out, route, ns_pass = _launch("cg", coef, b, tol, b_norm, stencil, grid, maxiter, sub)
    _count(fused_cg_solve_2d, route, ns_pass)
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
    with tracing.span("launch"):
        out, route, ns_pass = _launch("mrr", coef, b, tol, b_norm, stencil, grid, maxiter, sub)
    _count(fused_mrr_solve_2d, route, ns_pass)
    return out


# the launch counts of each fused wrapper (K2/K3 here, K5/K6 in fused_kskip;
# streaming launches also by their pass, the streaming form of K4)
COUNTS = ("launches", "launches_resident", "launches_streaming", *(f"launches_ns{n}" for n in (0, *PASS_TERMS)),
          *(f"launches_streaming_ns{n}" for n in (0, *PASS_TERMS)))
for _fn in (fused_cg_solve_2d, fused_mrr_solve_2d):
    reset_counts(_fn)
