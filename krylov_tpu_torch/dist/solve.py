"""Row-partitioned solves: the same eager loops on every rank's row block.

The counterpart of :mod:`krylov_tpu.dist.solve`.  The loop functions of
:mod:`krylov_tpu_torch.solvers` run unchanged; only the
:class:`~krylov_tpu_torch.context.Context` (the rows axis and its process
group: one all-reduce a reduction) and the operator
(:class:`~krylov_tpu_torch.dist.ShardedOperator`: its own halo or
all-gather exchange) change.  Every rank runs the same program on its own
rows, as a ``torch.distributed`` program does, where the JAX package is one
controller over ``shard_map``.

The reductions are summed by all-reduce, whose result is the same on every
rank, so every rank's traces, counts and host branches (the loops' reads of
the convergence flag, the adaptive guard, the CA guard) are the same: a
rank that branched alone would leave the others waiting in a collective.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref

import torch
import torch.distributed as dist

from krylov_tpu_torch import tracing
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.dist.spmv import gather_rows, shard_operator
from krylov_tpu_torch.solvers._common import _fingerprint
from krylov_tpu_torch.sparse.convert import pad_to_multiple


def pad_preconditioner(M, multiple: int):
    """Zero-pad a preconditioner so that ``multiple`` divides its N
    (:func:`krylov_tpu.dist.solve.pad_preconditioner`): padding rows get a
    unit diagonal, as :func:`~krylov_tpu_torch.sparse.convert.pad_to_multiple`
    gives the operator, so the padded preconditioner is the identity on the
    pad block, where every Krylov vector stays zero.  A Chebyshev
    preconditioner pads its inner operator (its polynomial is then the
    scalar p(1) on the pad block, harmless for the same reason)."""
    from krylov_tpu_torch.precond import ChebyshevPreconditioner

    if M is None:
        return None
    if isinstance(M, ChebyshevPreconditioner):
        A_p, _, _ = pad_to_multiple(M.A, torch.zeros(M.A.shape[0], dtype=M.A.dtype), multiple)
        return dataclasses.replace(M, A=A_p)
    M_p, _, _ = pad_to_multiple(M, torch.zeros(M.shape[0], dtype=M.dtype), multiple)
    return M_p


def shard_preconditioner(M, mesh):
    """This rank's block of a preconditioner (:func:`krylov_tpu.dist.solve.shard_preconditioner`):
    Jacobi's diagonal (a ``DiaMatrix``) or any container shards as an
    operator; a Chebyshev preconditioner's inner operator is sharded, so its
    recurrence runs the same halo or all-gather SpMV as ``A``."""
    from krylov_tpu_torch.precond import ChebyshevPreconditioner

    if M is None:
        return None
    if isinstance(M, ChebyshevPreconditioner):
        return dataclasses.replace(M, A=shard_operator(M.A, mesh))
    return shard_operator(M, mesh)


# id(A) -> (a weak reference to A, {process group: (A's fingerprint, sharded operator, padding)})
_SHARDED: dict = {}
_SHARDED_LOCK = threading.Lock()


def sharded_operator(A, mesh, b: torch.Tensor):
    """``(op, pad)``: this rank's :class:`~krylov_tpu_torch.dist.ShardedOperator`
    of ``A`` padded so that the number of ranks divides N, and the number
    of padding rows (``b``, a vector, is what
    :func:`~krylov_tpu_torch.sparse.convert.pad_to_multiple` pads beside
    ``A``).  Made once for each ``A`` and process group while ``A`` lives
    and its tensors are not changed in place (``A``'s fingerprint, the
    version of each tensor, is kept with it), so that a request that comes
    back on the same operator finds the same sharded operator, and so the
    CUDA graphs keyed on it; an ``A`` changed in place is sharded anew, and
    dropping ``A`` drops it.  An operator that is not one of the package's
    own is sharded at every call."""
    group = mesh.get_group()
    version = _fingerprint(A)
    entry = None if version is None else _cache_entry(A)
    found = None if entry is None else entry[1].get(group)
    if found is None or found[0] != version:
        A_p, _, _ = pad_to_multiple(A, b, dist.get_world_size(group))
        found = (version, shard_operator(A_p, mesh), A_p.shape[0] - A.shape[0])
        if entry is not None:
            with _SHARDED_LOCK:
                kept = entry[1].get(group)
                if kept is None or kept[0] != version:
                    entry[1][group] = found
                else:  # another thread sharded the same version first
                    found = kept
    return found[1:]


def _cache_entry(A):
    """``A``'s entry in the cache of sharded operators (made where it has
    none), dropped when ``A`` dies."""
    key = id(A)
    with _SHARDED_LOCK:
        entry = _SHARDED.get(key)
        if entry is None or entry[0]() is not A:

            def drop(ref, key=key, cache=_SHARDED):  # the cache itself: the module may be gone when it runs
                if cache.get(key, (None,))[0] is ref:
                    del cache[key]

            entry = _SHARDED[key] = (weakref.ref(A, drop), {})
        return entry


def _same_bounds(bounds, ctx: Context, device):
    """The spectral bounds as group rank 0 has them, on every rank: the CA
    loops' guard reads the host, so every rank must hold the same floats."""
    t = torch.tensor(bounds, dtype=torch.float64, device=device)
    dist.broadcast(t, src=dist.get_global_rank(ctx.group, 0), group=ctx.group)
    return tuple(float(v) for v in t.tolist())


def solve_sharded(
    A, b: torch.Tensor, x0, *, tol, method: str, maxiter: int, k: int = 0, M=None, mesh,
    scalar_dtype=None, basis_norm: bool = False, spectral_bounds=None, gather: bool = True,
    return_times: bool = False, restarts: int = 0,
):
    """Row-partition the system over ``mesh`` and run the eager loop of
    ``method`` on this rank's rows (:func:`krylov_tpu.dist.solve.solve_sharded`),
    then ``restarts`` defect corrections on them (one ``(N,)`` system;
    :func:`krylov_tpu_torch.api._run_single`).

    ``A`` is the whole operator and ``b``/``x0`` (``x0`` may be None) the
    whole ``(N,)`` or ``(batch, N)`` tensors, the same on every rank, on the
    device of ``A``, whose type must be the mesh's.  The system is padded so
    that the number of ranks divides N; the spectral bounds of ``cacg``/
    ``camrr`` are resolved once on the whole ``A`` and taken from group rank
    0.  A batch runs as one ``(batch, n_local)`` loop, with one all-reduce a
    reduction for the whole batch.  The sharded operator is made once for
    each ``(A, mesh)`` (:func:`sharded_operator`).

    With ``return_times=True`` returns ``(result, exec_seconds)``: the
    timed window starts after a barrier of the rows group and runs
    between device synchronisations (NCCL runs on its own streams, so the
    whole device is synchronised; :func:`krylov_tpu_torch.solve` builds the
    kernels before it).  After the solve ``x`` is gathered once and the
    padding stripped: ``gather=False`` returns this rank's rows of the
    unpadded ``x`` instead.  The traces are the same on every rank."""
    from krylov_tpu_torch.api import (
        _CACG_METHODS,
        _resolve_bounds,
        _run_base,
        _run_single,
        _skip_zero_members,
        _zero_result,
    )

    (axis,) = mesh.mesh_dim_names
    group = mesh.get_group()
    n_devices, rank = dist.get_world_size(group), dist.get_rank(group)
    device = A.device
    if device.type != mesh.device_type:
        raise ValueError(f"the operator lies on {device}, the mesh is over {mesh.device_type} devices")
    batched = b.ndim == 2
    n_orig = b.shape[-1]
    op, pad = sharded_operator(A, mesh, b[0] if batched else b)
    if x0 is None:
        x0 = torch.zeros_like(b)
    b_p, x0_p = (torch.nn.functional.pad(v, (0, pad)) for v in (b, x0))
    m_op = shard_preconditioner(pad_preconditioner(M, n_devices) if pad else M, mesh)
    ctx = Context(axis=axis, scalar_dtype=scalar_dtype, group=group)
    n = op.local_n
    b_l, x0_l = (v[..., rank * n: (rank + 1) * n].contiguous() for v in (b_p, x0_p))
    # the front door's b = 0 test on the all-reduced norm, so that every
    # rank takes the same branch; a zero member runs no loop
    zero = ctx.norm(b_l) == 0
    with tracing.host_read():
        zero = zero.reshape(-1).tolist()
    bounds = None
    if method in _CACG_METHODS and not all(zero):
        bounds = _same_bounds(_resolve_bounds(A, method, spectral_bounds), ctx, device)

    on_cuda = device.type == "cuda"
    if return_times:
        dist.barrier(group=group)
        if on_cuda:
            torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run = dict(tol=tol, method=method, maxiter=maxiter, k=k, scalar_dtype=scalar_dtype, use_fused=False,
               basis_norm=basis_norm, M=m_op, bounds=bounds, ctx=ctx)
    if batched:
        result = _skip_zero_members(lambda B_, X0_: _run_base(op, B_, X0_, **run), b_l, x0_l, zero, method, k,
                                    scalar_dtype, False)
    elif zero[0]:
        result = _zero_result(b_l, method, k, scalar_dtype, False, restarts)
    else:
        result = _run_single(op, b_l, x0_l, restarts=restarts, **run)
    if return_times and on_cuda:
        torch.cuda.synchronize(device)
    exec_s = time.perf_counter() - t0

    if gather:
        x = gather_rows(result.x, n_devices, group)[..., :n_orig]
    else:
        x = result.x[..., : max(0, min(n, n_orig - rank * n))]
    result = dataclasses.replace(result, x=x)
    if return_times:
        return result, exec_s
    return result
