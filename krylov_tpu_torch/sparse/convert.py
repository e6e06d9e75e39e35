"""Conversions from host formats (scipy CSR/COO, dense) into this package's
containers, the host float64 matvec, and the carry-over from the JAX
package's containers.

The counterparts of :mod:`krylov_tpu.sparse.convert`: the sparsity pattern
is analysed once on the host with numpy/scipy and the arrays are built as
the JAX package builds them, then moved to ``device`` as tensors (by
default the CUDA device, see :mod:`krylov_tpu_torch.device`).  ``dtype``
is a torch or numpy dtype (None keeps the input's); index arrays are int32.

:func:`from_jax_operator` reads a ``krylov_tpu`` container's leaves through
``np.array`` (so this module never imports jax) and builds the matching
container of this package, which lets one operator feed both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from krylov_tpu_torch.device import resolve
from krylov_tpu_torch.sparse.formats import (
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    Operator,
    StencilMatrix,
    _host,
    as_numpy_dtype,
    as_torch_dtype,
)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=resolve(device))


def _csr_parts(A):
    csr = A.tocsr()
    csr.sum_duplicates()
    return csr


def analyze(A) -> dict:
    """Host-side pattern analysis used to pick a container format."""
    csr = _csr_parts(A)
    n, m = csr.shape
    coo = csr.tocoo()
    offs = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))
    row_nnz = np.diff(csr.indptr)
    return {
        "shape": (n, m),
        "nnz": int(csr.nnz),
        "num_offsets": int(offs.size),
        "offsets": offs,
        "max_row_nnz": int(row_nnz.max(initial=0)),
        "mean_row_nnz": float(row_nnz.mean()) if n else 0.0,
    }


def from_scipy(A, dtype=None, max_dia_offsets: int = 32, device=None) -> Operator:
    """Pick the container for a scipy sparse matrix, as the JAX package
    picks it: :class:`DiaMatrix` for few, dense diagonals; else
    :class:`HybMatrix` when its storage (:func:`hyb_split_width`) is at most
    half of max-width ELL's, and :class:`EllMatrix` otherwise."""
    info = analyze(A)
    n, m = info["shape"]
    if info["num_offsets"] <= max_dia_offsets and info["num_offsets"] * n <= 8 * max(info["nnz"], 1):
        return to_dia(A, dtype=dtype, device=device)
    csr = _csr_parts(A)
    row_nnz = np.diff(csr.indptr)
    w, hyb_slots = hyb_split_width(row_nnz)
    ell_slots = n * max(int(row_nnz.max(initial=1)), 1)
    if hyb_slots * 2 <= ell_slots:
        return to_hyb(csr, dtype=dtype, width=w, device=device)
    return to_ell(csr, dtype=dtype, device=device)


def hyb_split_width(row_nnz: np.ndarray, tail_width: int = 32) -> Tuple[int, int]:
    """The ELL width ``w`` of an ELL + tail split that minimises storage.

    Storage(w) = n*w + the overflow past w + half a tail chunk of padding
    per long row, evaluated at every distinct row width (the only places
    the minimum can move).  Returns ``(w, storage_slots)``."""
    n = row_nnz.shape[0]
    sorted_nnz = np.sort(row_nnz).astype(np.int64)
    suffix = np.concatenate([np.cumsum(sorted_nnz[::-1])[::-1], [0]])
    cands = np.unique(np.concatenate([[1], np.unique(sorted_nnz)]))
    cands = cands[cands >= 1].astype(np.int64)
    lo = np.searchsorted(sorted_nnz, cands, side="right")
    t = n - lo  # rows with nnz > w
    overflow = suffix[lo] - t * cands  # entries past w
    cost = n * cands + overflow + t * (tail_width // 2)
    best = int(np.argmin(cost))
    return int(cands[best]), int(cost[best])


def to_dia(A, dtype=None, device=None) -> DiaMatrix:
    """Row-indexed diagonal storage: ``data[d, i] = A[i, i + offsets[d]]``."""
    csr = _csr_parts(A)
    n, m = csr.shape
    coo = csr.tocoo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    offs = np.unique(cols - rows)
    data = np.zeros((len(offs), n), dtype=as_numpy_dtype(dtype) or coo.data.dtype)
    data[np.searchsorted(offs, cols - rows), rows] = coo.data
    return DiaMatrix(_tensor(data, device), tuple(int(o) for o in offs), (n, m))


def _ell_arrays(csr, w: int, dtype):
    """(data, indices) of the first ``w`` entries of every row, and the
    flat (entry -> row, slot) maps the tail build reads."""
    n = csr.shape[0]
    row_nnz = np.diff(csr.indptr)
    entry_row = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    slot = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1].astype(np.int64), row_nnz)
    data = np.zeros((n, w), dtype=dtype)
    indices = np.zeros((n, w), dtype=np.int32)
    keep = slot < w
    data[entry_row[keep], slot[keep]] = csr.data[keep]
    indices[entry_row[keep], slot[keep]] = csr.indices[keep]
    return data, indices, entry_row, slot


def to_ell(A, dtype=None, width: Optional[int] = None, device=None) -> EllMatrix:
    """ELLPACK with rows padded to the max (or the given) width."""
    csr = _csr_parts(A)
    n, m = csr.shape
    row_nnz = np.diff(csr.indptr)
    w = max(int(width if width is not None else row_nnz.max(initial=1)), 1)
    data, indices, _, _ = _ell_arrays(csr, w, as_numpy_dtype(dtype) or csr.data.dtype)
    return EllMatrix(_tensor(data, device), _tensor(indices, device), (n, m))


def to_hyb(
    A, dtype=None, width: Optional[int] = None, tail_width: int = 32,
    tail_multiple: int = 8, device=None,
) -> HybMatrix:
    """Hybrid ELL + tail storage (:class:`HybMatrix`).

    ``width`` is the ELL split point (:func:`hyb_split_width` when
    omitted).  A row longer than ``width`` spills its overflow into
    ceil(overflow / tail_width) consecutive chunks of the tail block, all
    naming that row; the chunk count is padded to a multiple of
    ``tail_multiple``."""
    csr = _csr_parts(A)
    n, m = csr.shape
    row_nnz = np.diff(csr.indptr).astype(np.int64)
    wmax = int(row_nnz.max(initial=1))
    w = int(width) if width is not None else hyb_split_width(row_nnz, tail_width)[0]
    w = max(min(w, wmax), 1)
    dtype = as_numpy_dtype(dtype) or csr.data.dtype
    data, indices, entry_row, slot = _ell_arrays(csr, w, dtype)

    wt = int(tail_width)
    chunks_per_row = -(-np.maximum(row_nnz - w, 0) // wt)  # ceil
    t = int(chunks_per_row.sum())
    t_pad = max(-(-max(t, 1) // tail_multiple) * tail_multiple, tail_multiple)
    tail_rows = np.zeros(t_pad, dtype=np.int32)
    tail_data = np.zeros((t_pad, wt), dtype=dtype)
    tail_indices = np.zeros((t_pad, wt), dtype=np.int32)
    if t:
        long_rows = np.flatnonzero(chunks_per_row)
        tail_rows[:t] = np.repeat(long_rows, chunks_per_row[long_rows])
        # first chunk of each row, then (chunk, position) per overflow entry
        chunk_start = np.zeros(n, dtype=np.int64)
        chunk_start[1:] = np.cumsum(chunks_per_row)[:-1]
        over = slot >= w
        p = slot[over] - w
        tr = chunk_start[entry_row[over]] + p // wt
        tail_data[tr, p % wt] = csr.data[over]
        tail_indices[tr, p % wt] = csr.indices[over]
    return HybMatrix(
        *(_tensor(a, device) for a in (data, indices, tail_rows, tail_data, tail_indices)), (n, m)
    )


def to_dense(A, dtype=None, device=None) -> DenseMatrix:
    arr = A.toarray() if hasattr(A, "toarray") else np.asarray(A)
    return DenseMatrix(_tensor(np.asarray(arr, dtype=as_numpy_dtype(dtype)), device))


def pad_to_multiple(A: Operator, b, multiple: int) -> Tuple[Operator, torch.Tensor, int]:
    """Zero-pad the system so that ``multiple`` divides N.

    Padding rows get a unit diagonal, so the operator stays SPD and the
    padded entries of the solution are zero for a zero right-hand side.  A
    stencil operator loses its grid and pads as DIA.  Returns
    ``(padded_A, padded_b, original_N)``, ``padded_b`` a tensor on ``A``'s
    device."""
    n = A.shape[0]
    pad = (-n) % multiple
    b = torch.as_tensor(b, device=A.device)
    if pad == 0:
        return A, b, n
    if isinstance(A, StencilMatrix):
        return pad_to_multiple(A.to_dia(), b, multiple)
    b_p = torch.cat([b, b.new_zeros(pad)])
    new_rows = torch.arange(n, n + pad, device=A.device)
    if isinstance(A, DiaMatrix):
        offsets, data = A.offsets, A.data
        if 0 not in offsets:
            offsets, data = (0,) + offsets, torch.cat([data.new_zeros((1, n)), data])
        new = torch.cat([data, data.new_zeros((data.shape[0], pad))], dim=1)
        new[offsets.index(0), n:] = 1.0
        return DiaMatrix(new, offsets, (n + pad, n + pad)), b_p, n

    def padded_ell(data, idx):
        new_data = torch.cat([data, data.new_zeros((pad, data.shape[1]))])
        new_idx = torch.cat([idx, idx.new_zeros((pad, idx.shape[1]))])
        new_data[n:, 0] = 1.0
        new_idx[n:, 0] = new_rows.to(idx.dtype)
        return new_data, new_idx

    if isinstance(A, EllMatrix):
        return EllMatrix(*padded_ell(A.data, A.indices), (n + pad, n + pad)), b_p, n
    if isinstance(A, HybMatrix):
        hyb = HybMatrix(*padded_ell(A.ell_data, A.ell_indices), A.tail_rows, A.tail_data,
                        A.tail_indices, (n + pad, n + pad))
        return hyb, b_p, n
    if isinstance(A, DenseMatrix):
        new = A.data.new_zeros((n + pad, n + pad))
        new[:n, :n] = A.data
        new[new_rows, new_rows] = 1.0
        return DenseMatrix(new), b_p, n
    raise TypeError(f"cannot pad operator of type {type(A).__name__}")


def host64(v) -> np.ndarray:
    """``v`` (a tensor on any device or an array) as a float64 numpy array."""
    if isinstance(v, torch.Tensor):
        v = _host(v)
    return np.asarray(v, dtype=np.float64)


def host_matvec64(A: Operator, x) -> np.ndarray:
    """``A @ x`` in float64 numpy on the host, for any container.

    The ``refine=`` path of :func:`krylov_tpu_torch.solve` forms its defect
    ``b - A x`` with it, below the float32 representation floor.  The
    operator's tensors are read through ``.cpu().numpy()``."""
    x = host64(x)
    if isinstance(A, StencilMatrix):
        A = A.to_dia()
    if isinstance(A, DiaMatrix):
        n = A.shape[0]
        data = host64(A.data)
        y = np.zeros(n)
        for d, off in enumerate(A.offsets):
            lo, hi = max(0, -off), min(n, n - off)
            if hi > lo:
                y[lo:hi] += data[d, lo:hi] * x[lo + off: hi + off]
        return y
    if isinstance(A, EllMatrix):
        return (host64(A.data) * x[_host(A.indices)]).sum(axis=-1)
    if isinstance(A, HybMatrix):
        y = (host64(A.ell_data) * x[_host(A.ell_indices)]).sum(axis=-1)
        extra = (host64(A.tail_data) * x[_host(A.tail_indices)]).sum(axis=-1)
        np.add.at(y, _host(A.tail_rows), extra)
        return y
    if isinstance(A, DenseMatrix):
        return host64(A.data) @ x
    raise TypeError(f"no host matvec for {type(A).__name__}")


_FROM_JAX = {cls.__name__: cls for cls in (StencilMatrix, DiaMatrix, EllMatrix, HybMatrix, DenseMatrix)}


def from_jax_operator(A, device=None, dtype=None, rank=None):
    """Convert a ``krylov_tpu`` container (``StencilMatrix``, ``DiaMatrix``,
    ``EllMatrix``, ``HybMatrix`` or ``DenseMatrix``) into this package's;
    a ``krylov_tpu.precond.ChebyshevPreconditioner`` becomes
    :class:`krylov_tpu_torch.precond.ChebyshevPreconditioner` with its
    operator converted and its ``lmin``, ``lmax`` and ``degree`` kept (a
    Jacobi preconditioner is a ``DiaMatrix`` already).  A
    ``krylov_tpu.dist.ShardedOperator`` (globally shaped, as
    ``krylov_tpu.dist.shard_operator`` returns it) becomes rank ``rank``'s
    :class:`krylov_tpu_torch.dist.ShardedOperator`, its leaves cut as the
    JAX package's partition specs cut them inside ``shard_map``
    (:func:`krylov_tpu_torch.dist.spmv.local_block`).

    ``dtype`` (torch or numpy) casts the floating-point leaves and defaults
    to their own dtype; index leaves keep theirs."""
    if type(A).__name__ == "ChebyshevPreconditioner":
        from krylov_tpu_torch.precond import ChebyshevPreconditioner

        return ChebyshevPreconditioner(A=from_jax_operator(A.A, device, dtype), lmin=float(A.lmin),
                                       lmax=float(A.lmax), degree=int(A.degree))
    if type(A).__name__ == "ShardedOperator":
        from krylov_tpu_torch.dist.spmv import ShardedOperator, local_block

        if rank is None:
            raise ValueError("from_jax_operator of a ShardedOperator needs the rank whose block it returns")
        arrays = []
        for a in A.arrays:
            t = _tensor(np.array(a), device)
            arrays.append(t.to(as_torch_dtype(dtype)) if dtype is not None and t.is_floating_point() else t)
        offsets = A.offsets
        if offsets is not None:
            offsets = tuple(tuple(int(d) for d in o) if A.kind == "stencil" else int(o) for o in offsets)
        return ShardedOperator(
            kind=A.kind, arrays=local_block(A.kind, arrays, A.n_devices, rank), offsets=offsets,
            shape=tuple(int(g) for g in A.shape), n_devices=int(A.n_devices), strategy=A.strategy, rank=int(rank),
            grid=None if A.grid is None else tuple(int(g) for g in A.grid))
    cls = _FROM_JAX.get(type(A).__name__)
    if cls is None:
        raise TypeError(f"from_jax_operator takes a krylov_tpu container ({', '.join(_FROM_JAX)}), a "
                        f"ChebyshevPreconditioner or a dist.ShardedOperator, got {type(A).__name__}")
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(A, f.name)
        if f.name == "stencil":
            kw[f.name] = tuple(tuple(int(d) for d in disp) for disp in v)
        elif f.name in ("grid", "offsets", "shape"):
            kw[f.name] = tuple(int(g) for g in v)
        else:
            t = _tensor(np.array(v), device)
            kw[f.name] = t.to(as_torch_dtype(dtype)) if dtype is not None and t.is_floating_point() else t
    return cls(**kw)
