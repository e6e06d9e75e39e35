"""Row-partitioned SpMV on ``torch.distributed``: halo exchange or all-gather.

The counterpart of :mod:`krylov_tpu.dist.spmv`.  Each rank holds its row
block of the operator (:class:`ShardedOperator`, built by
:func:`shard_operator`) and of every vector, and the matvec makes the one
exchange the sparsity needs:

- ``halo`` (stencils along the leading grid axis, DIA bands): each rank
  exchanges its boundary strips with its left and right neighbours in one
  ``batch_isend_irecv``.  The exchange is **not a ring**, as the JAX
  package's ``ppermute`` is: a rank at a global edge sends and receives
  nothing across it, and one rank exchanges nothing.  The JAX wrap-around
  strips are multiplied by structural zeros (or zeroed outright for the
  constant stencil), so leaving them out gives the same product, and a
  send to itself, which gloo and NCCL refuse, never happens.  The transfers
  are posted first; the bulk, the whole band on the zero-padded local block,
  runs while they are in flight (a stencil's bulk is K1,
  :func:`krylov_tpu_torch.kernels.stencil.stencil_matvec_2d`, on the rank's
  slab as a grid of its own); only the rows next to a neighbour are then
  recomputed from the received strips.
- ``allgather`` (ELL, HYB, dense, and DIA where the band does not fit a
  block): one all-gather of ``x`` into a buffer kept by the operator, then
  the local row block through the gathers and sorted scatter-add of
  :mod:`krylov_tpu_torch.sparse.formats`.

``x`` is ``(n_local,)`` or a ``(batch, n_local)`` block (one exchange for
the block).  :func:`sharded_matvec` counts the SpMVs and the bytes each rank
receives in them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from krylov_tpu_torch import tracing
from krylov_tpu_torch.sparse.formats import (
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    StencilMatrix,
    _gather_sum,
    _scatter_add_rows,
)

# tags of the two halo strips: planes moving to the next rank (its top halo)
# and to the previous one (its bottom halo)
_TO_NEXT, _TO_PREV = 0, 1


@dataclasses.dataclass(frozen=True)
class ShardedOperator:
    """This rank's row block of a row-partitioned operator.

    ``arrays`` hold the format's data leaves cut to the rank's rows, as the
    JAX package's partition specs cut them inside ``shard_map`` (the
    constant stencil's weights whole); ``kind``/``offsets``/``shape``/
    ``n_devices``/``strategy``/``grid`` are those of
    :class:`krylov_tpu.dist.ShardedOperator`, and ``rank`` is the rank's
    place in the rows group.  For stencils ``offsets`` carries the
    displacement tuples and ``grid`` the global grid, partitioned along its
    leading axis."""

    kind: str  # 'dia' | 'stencil' | 'ell' | 'hyb' | 'dense'
    arrays: Tuple[torch.Tensor, ...]
    offsets: Optional[Tuple]
    shape: Tuple[int, int]  # global (padded) shape
    n_devices: int
    strategy: str  # 'halo' | 'allgather'
    rank: int
    grid: Optional[Tuple[int, ...]] = None  # stencil only
    # built once at shard time: the stencil's fix-up coefficients; and the
    # all-gather buffers by (shape, dtype), reused from call to call
    aux: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    needs_ctx = True
    # its matvec reads its fields, what ``aux`` derives from them and the
    # context alone: a CUDA graph of the solvers may be keyed on it
    graph_keyed = True

    def __post_init__(self):
        if self.kind == "stencil":
            self.aux.update(_stencil_fixup(self))

    @property
    def dtype(self) -> torch.dtype:
        return self.arrays[0].dtype

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device

    @property
    def local_n(self) -> int:
        return self.shape[0] // self.n_devices

    def matvec(self, x_local: torch.Tensor, ctx) -> torch.Tensor:
        return sharded_matvec(self, x_local, ctx)


def _sharded_matvec(op: ShardedOperator, x: torch.Tensor, ctx) -> torch.Tensor:
    """``op``'s row block of ``A x`` from this rank's block of ``x``.
    ``sharded_matvec.calls`` counts the calls; ``.halo_bytes`` and
    ``.gather_bytes`` the bytes this rank received in them
    (``tracing.totals.sharded_matvec``; a call captured in a CUDA graph
    counts at each replay)."""
    tracing.count("sharded_matvec")
    with tracing.span("halo"):
        if op.kind == "stencil":
            return _stencil_halo_matvec(op, x, ctx)
        if op.strategy == "halo":
            return _dia_halo_matvec(op, x, ctx)
        return _allgather_matvec(op, x, ctx)


sharded_matvec = tracing.counted("sharded_matvec", _sharded_matvec)


def _post_halo(x: torch.Tensor, lo: int, hi: int, width: int, op: ShardedOperator, ctx):
    """Post the neighbour exchange: this rank's last ``lo`` strips of
    ``width`` entries go to the next rank, its first ``hi`` to the
    previous one.  Returns ``(pending, top, bottom)``: the posted requests
    (with the tensors they read, held until :func:`_wait`), the ``lo``
    strips received from the previous rank and the ``hi`` from the next,
    None at a global edge or for a zero width."""
    batch, rank, group = x.shape[:-1], op.rank, ctx.group
    ops, top, bottom = [], None, None
    if rank > 0:
        prev = dist.get_global_rank(group, rank - 1)
        if lo:
            top = x.new_empty(batch + (lo * width,))
            ops.append(dist.P2POp(dist.irecv, top, prev, group, tag=_TO_NEXT))
        if hi:
            ops.append(dist.P2POp(dist.isend, x[..., : hi * width].contiguous(), prev, group, tag=_TO_PREV))
    if rank < op.n_devices - 1:
        nxt = dist.get_global_rank(group, rank + 1)
        if hi:
            bottom = x.new_empty(batch + (hi * width,))
            ops.append(dist.P2POp(dist.irecv, bottom, nxt, group, tag=_TO_PREV))
        if lo:
            ops.append(dist.P2POp(dist.isend, x[..., x.shape[-1] - lo * width:].contiguous(), nxt, group,
                                  tag=_TO_NEXT))
    pending = (dist.batch_isend_irecv(ops), ops) if ops else None
    for t in (top, bottom):
        if t is not None:
            tracing.count("sharded_matvec", "halo_bytes", n=t.numel() * t.element_size())
    return pending, top, bottom


def _wait(pending) -> None:
    if pending is not None:
        for work in pending[0]:
            work.wait()


def _band(data: torch.Tensor, offsets, x_ext: torch.Tensor, left: int, out_n: int, row0: int) -> torch.Tensor:
    """The band applied to ``x_ext`` (input rows ``[row0 - left, row0 +
    out_n + right)``) for output rows ``[row0, row0 + out_n)``."""
    y = x_ext.new_zeros(x_ext.shape[:-1] + (out_n,))
    for d, off in enumerate(offsets):
        start = left + off
        y = y + data[d, row0: row0 + out_n] * x_ext[..., start: start + out_n]
    return y


def _dia_halo_matvec(op: ShardedOperator, x: torch.Tensor, ctx) -> torch.Tensor:
    """Banded SpMV of the row block (``data[d, i] = A[row0 + i, row0 + i +
    offsets[d]]``), bulk first, then the first ``left`` and last ``right``
    rows from the received strips (:func:`krylov_tpu.dist.spmv._dia_halo_matvec`).
    Needs ``left + right <= local_n`` (:func:`shard_operator` checks)."""
    (data,) = op.arrays
    n = x.shape[-1]
    left, right = max(0, -min(op.offsets)), max(0, max(op.offsets))
    pending, top, bottom = _post_halo(x, left, right, 1, op, ctx)
    y = _band(data, op.offsets, torch.nn.functional.pad(x, (left, right)), left, n, 0)
    _wait(pending)
    if top is not None:
        y[..., :left] = _band(data, op.offsets, torch.cat([top, x[..., : left + right]], -1), left, left, 0)
    if bottom is not None:
        ext = torch.cat([x[..., n - right - left:], bottom], -1)
        y[..., n - right:] = _band(data, op.offsets, ext, left, right, n - right)
    return y


def _reaches(offsets, axis: int) -> Tuple[int, int]:
    """How far the stencil reaches back and forward along ``axis``."""
    return max(0, -min(d[axis] for d in offsets)), max(0, max(d[axis] for d in offsets))


def _stencil_fixup(op: ShardedOperator) -> dict:
    """What the stencil matvec needs besides ``coef``, built once: the
    leading-axis reach ``lo0``/``hi0``, the plane size, and the
    coefficients of the two extended slabs the boundary planes are
    recomputed on (halo planes with zero coefficients, then the local
    planes they feed; the constant form's weights serve as they are)."""
    (coef,) = op.arrays
    lo0, hi0 = _reaches(op.offsets, 0)
    rest = tuple(op.grid[1:])
    fix = {"lo0": lo0, "hi0": hi0, "plane": int(np.prod(rest)), "local_g0": op.grid[0] // op.n_devices}
    if coef.ndim == 1:
        fix["top_coef"] = fix["bottom_coef"] = coef
    else:
        g0 = fix["local_g0"]
        ns = coef.shape[0]
        fix["top_coef"] = torch.cat([coef.new_zeros((ns, lo0) + rest), coef[:, : lo0 + hi0]], 1).contiguous()
        fix["bottom_coef"] = torch.cat([coef[:, g0 - hi0 - lo0:], coef.new_zeros((ns, hi0) + rest)], 1).contiguous()
    return fix


def _stencil_halo_matvec(op: ShardedOperator, x: torch.Tensor, ctx) -> torch.Tensor:
    """Stencil SpMV of the rank's slab of ``grid[0] / n_devices`` leading
    planes (:func:`krylov_tpu.dist.spmv._stencil_halo_matvec`): the halo
    planes posted, the bulk while they travel, then the boundary planes."""
    fix = op.aux
    x = x.contiguous()  # K1 reads a contiguous block, as StencilMatrix.matvec hands it one
    pending, top, bottom = _post_halo(x, fix["lo0"], fix["hi0"], fix["plane"], op, ctx)
    y = stencil_bulk(op, x)
    _wait(pending)
    return stencil_boundary(op, x, y, top, bottom)


def stencil_bulk(op: ShardedOperator, x: torch.Tensor) -> torch.Tensor:
    """K1 on the rank's slab as a grid of its own.  K1 zero-pads beyond it:
    that is the JAX package's zero-padded bulk, and it is exact at a global
    edge (the grid form stores zeros there, the constant form reads zero
    padding)."""
    from krylov_tpu_torch.kernels.stencil import stencil_matvec_2d

    return stencil_matvec_2d(op.arrays[0], x, stencil=op.offsets, grid=(op.aux["local_g0"],) + tuple(op.grid[1:]))


def stencil_boundary(op: ShardedOperator, x: torch.Tensor, y: torch.Tensor, top, bottom) -> torch.Tensor:
    """``y``, the bulk, with the planes next to a neighbour recomputed (in
    place): the first ``lo0`` from the ``top`` halo planes, the last
    ``hi0`` from the ``bottom`` ones (None at a global edge).  Each is K1
    on a small extended slab, the halo planes and the ``lo0 + hi0`` local
    planes that output reads, of which the middle planes are kept, so every
    output plane is summed in stencil order as the single-device K1 sums
    it."""
    from krylov_tpu_torch.kernels.stencil import stencil_matvec_2d

    if top is None and bottom is None:
        return y
    fix = op.aux
    lo0, hi0, plane, g0 = fix["lo0"], fix["hi0"], fix["plane"], fix["local_g0"]
    rest, batch = tuple(op.grid[1:]), x.shape[:-1]
    xg, yg = x.view(batch + (g0, plane)), y.view(batch + (g0, plane))
    if top is not None:
        ext = torch.cat([top.view(batch + (lo0, plane)), xg[..., : lo0 + hi0, :]], -2)
        out = stencil_matvec_2d(fix["top_coef"], ext.reshape(batch + (-1,)), stencil=op.offsets,
                                grid=(2 * lo0 + hi0,) + rest)
        yg[..., :lo0, :] = out.view(batch + (2 * lo0 + hi0, plane))[..., lo0: 2 * lo0, :]
    if bottom is not None:
        ext = torch.cat([xg[..., g0 - hi0 - lo0:, :], bottom.view(batch + (hi0, plane))], -2)
        out = stencil_matvec_2d(fix["bottom_coef"], ext.reshape(batch + (-1,)), stencil=op.offsets,
                                grid=(lo0 + 2 * hi0,) + rest)
        yg[..., g0 - hi0:, :] = out.view(batch + (lo0 + 2 * hi0, plane))[..., lo0: lo0 + hi0, :]
    return y


def _all_gather_single(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """``dist.all_gather_single`` where torch has it (it deprecates
    ``all_gather_into_tensor`` from 2.13), else the older name."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)


def gather_rows(x: torch.Tensor, n_devices: int, group, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole ``(N,)`` or ``(batch, N)`` vector from every rank's row
    block (one all-gather), into ``out`` (flat, ``n_devices * x.numel()``)
    when given."""
    flat = x.contiguous().view(-1)
    if out is None:
        out = flat.new_empty(n_devices * flat.numel())
    _all_gather_single(out, flat, group)
    if x.ndim == 1:
        return out
    batch, n = x.shape
    return out.view(n_devices, batch, n).transpose(0, 1).reshape(batch, n_devices * n)


def _allgather_matvec(op: ShardedOperator, x: torch.Tensor, ctx) -> torch.Tensor:
    """The row block's SpMV on the whole ``x``, gathered into a buffer the
    operator keeps for this shape (:func:`krylov_tpu.dist.spmv._allgather_matvec`)."""
    key = (tuple(x.shape), x.dtype)
    buf = op.aux.get(key)
    if buf is None:
        buf = op.aux[key] = x.new_empty(op.n_devices * x.numel())
    x_full = gather_rows(x, op.n_devices, ctx.group, buf)
    tracing.count("sharded_matvec", "gather_bytes", n=(op.n_devices - 1) * x.numel() * x.element_size())
    if op.kind == "ell":
        data, indices = op.arrays
        return _gather_sum(data, indices, x_full)
    if op.kind == "hyb":
        ell_data, ell_idx, tail_rows, tail_data, tail_idx = op.arrays
        y = _gather_sum(ell_data, ell_idx, x_full)
        # tail_rows are LOCAL row ids (shard_operator re-bases them)
        return _scatter_add_rows(y, tail_rows, _gather_sum(tail_data, tail_idx, x_full))
    if op.kind == "dense":
        (data,) = op.arrays
        return data @ x_full if x_full.ndim == 1 else x_full @ data.T
    if op.kind == "dia":
        (data,) = op.arrays
        n = x.shape[-1]
        row0 = op.rank * n
        pad = max(abs(o) for o in op.offsets)
        # zero-padded: out-of-range band columns read zeros (their band
        # entries are structurally zero anyway)
        x_pad = torch.nn.functional.pad(x_full, (pad, pad))
        y = torch.zeros_like(x)
        for d, off in enumerate(op.offsets):
            y = y + data[d] * x_pad[..., row0 + off + pad: row0 + off + pad + n]
        return y
    raise ValueError(f"unknown kind {op.kind}")


# the data leaves each kind shards along the rows (axis of the row
# partition, None: the leaf is whole on every rank), as the JAX package's
# partition specs of shard_operator put them
_ROW_AXES = {
    "dia": (1,),
    "stencil": (1,),  # the constant form's (ns,) weights stay whole
    "ell": (0, 0),
    "hyb": (0, 0, 0, 0, 0),
    "dense": (0,),
}


def local_block(kind: str, arrays, n_devices: int, rank: int) -> Tuple[torch.Tensor, ...]:
    """``rank``'s block of globally shaped data leaves: each row-sharded
    leaf cut into ``n_devices`` equal blocks along its row axis, as
    ``shard_map`` cuts it (a copy, contiguous)."""
    out = []
    for a, axis in zip(arrays, _ROW_AXES[kind]):
        if kind == "stencil" and a.ndim == 1:
            out.append(a)
            continue
        size = a.shape[axis] // n_devices
        out.append(a.narrow(axis, rank * size, size).contiguous())
    return tuple(out)


def _regroup_tail(A: HybMatrix, n_devices: int, local_n: int):
    """The HYB tail regrouped by owning row block
    (:func:`krylov_tpu.dist.spmv.shard_operator`): every block gets the
    same number of slots (the most any block needs, at least 1, padded with
    zero chunks naming row 0) and row ids local to the block, so the
    scatter-add needs no offset.  Chunks keep their order within a block.
    Returns the globally shaped ``(rows, data, indices)``."""
    t_rows = A.tail_rows.cpu().numpy()
    t_data = A.tail_data.cpu().numpy()
    t_idx = A.tail_indices.cpu().numpy()
    real = np.flatnonzero(np.any(t_data != 0, axis=1))
    block = t_rows[real] // local_n
    tmax = max(int(np.bincount(block, minlength=n_devices).max(initial=0)), 1)
    wt = t_data.shape[1]
    g_rows = np.zeros((n_devices, tmax), dtype=t_rows.dtype)
    g_data = np.zeros((n_devices, tmax, wt), dtype=t_data.dtype)
    g_idx = np.zeros((n_devices, tmax, wt), dtype=t_idx.dtype)
    # the slot of each real chunk: its place among the chunks of its block
    order = np.argsort(block, kind="stable")
    starts = np.searchsorted(block[order], np.arange(n_devices))
    slot = np.empty_like(order)
    slot[order] = np.arange(order.size) - starts[block[order]]
    g_rows[block, slot] = t_rows[real] - block * local_n
    g_data[block, slot] = t_data[real]
    g_idx[block, slot] = t_idx[real]
    dev = A.device
    return (torch.as_tensor(g_rows.reshape(-1), device=dev), torch.as_tensor(g_data.reshape(-1, wt), device=dev),
            torch.as_tensor(g_idx.reshape(-1, wt), device=dev))


def partition(A, n_devices: int):
    """``(kind, globally shaped arrays, offsets, strategy, grid)`` of ``A``
    row-partitioned over ``n_devices`` ranks, by the rules of
    :func:`krylov_tpu.dist.spmv.shard_operator`:

    - a stencil takes the halo when ``grid[0] % n_devices == 0`` and its
      leading-axis reach fits a slab (``lo0 + hi0 <= grid[0] / n_devices``),
      else it goes through :meth:`~krylov_tpu_torch.sparse.StencilMatrix.to_dia`;
    - DIA takes the halo when ``left + right <= local_n`` and there is more
      than one rank, else the all-gather;
    - ELL, HYB (its tail regrouped by block) and dense take the all-gather."""
    n = A.shape[0]
    if n % n_devices != 0:
        raise ValueError(
            f"N={n} not divisible by n_devices={n_devices}; pad first "
            "(krylov_tpu_torch.sparse.convert.pad_to_multiple)"
        )
    local_n = n // n_devices
    if isinstance(A, StencilMatrix):
        lo0, hi0 = _reaches(A.stencil, 0)
        if A.grid[0] % n_devices == 0 and lo0 + hi0 <= A.grid[0] // n_devices:
            return "stencil", (A.coef,), A.stencil, "halo", A.grid
        return partition(A.to_dia(), n_devices)
    if isinstance(A, DiaMatrix):
        left = max(0, -min(A.offsets)) if A.offsets else 0
        right = max(0, max(A.offsets)) if A.offsets else 0
        strategy = "halo" if left + right <= local_n and n_devices > 1 else "allgather"
        return "dia", (A.data,), A.offsets, strategy, None
    if isinstance(A, EllMatrix):
        return "ell", (A.data, A.indices), None, "allgather", None
    if isinstance(A, HybMatrix):
        return "hyb", (A.ell_data, A.ell_indices) + _regroup_tail(A, n_devices, local_n), None, "allgather", None
    if isinstance(A, DenseMatrix):
        return "dense", (A.data,), None, "allgather", None
    raise TypeError(f"cannot shard operator of type {type(A).__name__}")


def shard_operator(A, mesh) -> ShardedOperator:
    """This rank's :class:`ShardedOperator` of ``A`` over the 1-D ``mesh``
    (:func:`krylov_tpu_torch.dist.make_mesh`), on ``A``'s device.

    The caller pads the system first so that the number of ranks divides N
    (:func:`krylov_tpu_torch.sparse.convert.pad_to_multiple`); otherwise
    ``ValueError``.  The strategy rules are :func:`partition`'s."""
    group = mesh.get_group()
    n_devices, rank = dist.get_world_size(group), dist.get_rank(group)
    kind, arrays, offsets, strategy, grid = partition(A, n_devices)
    return ShardedOperator(kind=kind, arrays=local_block(kind, arrays, n_devices, rank), offsets=offsets,
                           shape=tuple(A.shape), n_devices=n_devices, strategy=strategy, rank=rank, grid=grid)
