"""Profiling hooks: device traces and phase timing, on ``torch.profiler``.

The counterpart of :mod:`krylov_tpu.diagnostics.profiling`:

- :func:`trace` — a ``torch.profiler`` session that writes a Chrome/Perfetto
  trace (``*.pt.trace.json``, TensorBoard's layout) into ``log_dir``.  It
  records the CUDA activity whenever the solve's device is a card, so the
  trace names every hand-written kernel launch (K1's ``stencil2d_kernel``,
  the fused solves' ``*_resident_kernel``, streaming K2/K3's
  ``*_stream_kernel`` and streaming K5/K6's ``*_fused_kernel``), each torch
  launch and copy, beside the host calls.
- :func:`trace_solve` — :func:`krylov_tpu_torch.solve` under :func:`trace`.
- :func:`phase_times` — coarse host-side phases (first call with the
  kernels' build at first use, a second solve, the fetch to the host) for
  quick regressions without a trace viewer.
"""

from __future__ import annotations

import contextlib
import time

import torch

from krylov_tpu_torch.device import resolve


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Context manager: profile the enclosed code and write its trace into
    ``log_dir`` when it exits; yields the ``torch.profiler.profile``, whose
    ``key_averages()`` the caller may read after the block.  ``device``
    (default: the port's default device) is the solve's: a CUDA device
    adds the CUDA activity to the CPU's, and its work is synchronised
    before the trace closes.  On an H100 machine, traces taken long after
    the profiler's first use in a process have come back without some of
    their kernels' records: read the trace, and trace early in a process
    where it matters."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = resolve(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)


def trace_solve(A, b, log_dir: str, **solve_kwargs):
    """Run :func:`krylov_tpu_torch.solve` under :func:`trace` on the
    operator's device; returns ``(x, info)``."""
    from krylov_tpu_torch.api import solve
    from krylov_tpu_torch.sparse.formats import as_operator

    A = as_operator(A, device=b.device if isinstance(b, torch.Tensor) else None)
    with trace(log_dir, A.device):
        out = solve(A, b, **solve_kwargs)
    return out


def phase_times(A, b, **solve_kwargs) -> dict:
    """Host-side phase breakdown: the first call (on a card, with the
    kernels' build at first use), a second solve, each to device
    completion (``torch.cuda.synchronize``), then the fetch of ``x`` and
    the residual trace to the host."""
    from krylov_tpu_torch.api import solve_device

    def timed():
        t0 = time.perf_counter()
        res = solve_device(A, b, **solve_kwargs)
        if res.x.is_cuda:
            torch.cuda.synchronize(res.x.device)
        return res, time.perf_counter() - t0

    _, compile_and_first = timed()
    res, solve_t = timed()
    t0 = time.perf_counter()
    res.x.cpu()
    res.residual_trace.cpu()
    fetch_t = time.perf_counter() - t0
    return {
        "compile_plus_first_solve_s": compile_and_first,
        "solve_s": solve_t,
        "fetch_s": fetch_t,
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
    }
