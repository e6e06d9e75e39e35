"""Matrix loading: Matrix Market (.mtx), scipy .npz and dense .npy.

The counterparts of :mod:`krylov_tpu.sparse.io`.  ``.mtx`` parsing takes
the native C++ path of :mod:`krylov_tpu_torch.native` when its library
loads, and scipy otherwise.  ``dtype`` is a torch or numpy dtype (None
keeps float64); the container lands on ``device`` (by default the CUDA
device, see :mod:`krylov_tpu_torch.device`).
"""

from __future__ import annotations

import numpy as np

from krylov_tpu_torch import native
from krylov_tpu_torch.device import resolve
from krylov_tpu_torch.sparse import convert
from krylov_tpu_torch.sparse.formats import (
    DiaMatrix,
    EllMatrix,
    Operator,
    as_operator,
    as_torch_dtype,
)


def load_mtx(path: str, dtype=None, prefer: str = "auto", device=None) -> Operator:
    """Load a Matrix Market file into the best-fitting container.

    prefer: 'auto' (pattern analysis), 'dia', 'ell', 'hyb' or 'dense'."""
    rows, cols, vals, shape = native.read_mtx(path)
    n = shape[0]
    indptr, indices, data = native.coo_to_csr(n, rows, cols, vals)
    return _from_csr_arrays(n, shape, indptr, indices, data, dtype, prefer, device)


def load_npz(path: str, dtype=None, prefer: str = "auto", device=None) -> Operator:
    """Load a scipy-saved sparse matrix (.npz)."""
    import scipy.sparse as sp

    csr = sp.load_npz(path).tocsr()
    build = {"auto": convert.from_scipy, "dia": convert.to_dia, "ell": convert.to_ell,
             "hyb": convert.to_hyb, "dense": convert.to_dense}.get(prefer)
    if build is None:
        raise ValueError(f"unknown prefer={prefer!r}")
    return build(csr, dtype=dtype, device=device)


def load_npy(path: str, dtype=None, device=None) -> Operator:
    """Load a dense .npy matrix."""
    return as_operator(np.load(path), dtype=dtype, device=device)


def _from_csr_arrays(n, shape, indptr, indices, data, dtype, prefer, device):
    import torch

    def tensor(a, cast=True):
        t = torch.as_tensor(a, device=resolve(device))
        return t.to(as_torch_dtype(dtype)) if cast and dtype is not None else t

    if prefer == "dense":
        dense = np.zeros(shape)
        np.add.at(dense, (np.repeat(np.arange(n), np.diff(indptr)), indices), data)
        return as_operator(dense, dtype=dtype, device=device)

    row_nnz = np.diff(indptr)
    if prefer == "dia" or (prefer == "auto" and _diagonal_count(n, indptr, indices) <= 32):
        offsets, dia = native.csr_to_dia(n, indptr, indices, data)
        return DiaMatrix(tensor(dia), tuple(int(o) for o in offsets), shape)
    width = int(row_nnz.max(initial=1))
    if prefer in ("auto", "hyb"):
        w, hyb_slots = convert.hyb_split_width(row_nnz)
        if prefer == "hyb" or hyb_slots * 2 <= n * width:
            import scipy.sparse as sp

            csr = sp.csr_matrix((data, indices, indptr), shape=shape)
            return convert.to_hyb(csr, dtype=dtype, width=w, device=device)
    ell_data, ell_idx = native.csr_to_ell(n, indptr, indices, data, width)
    return EllMatrix(tensor(ell_data), tensor(ell_idx, cast=False), shape)


def _diagonal_count(n, indptr, indices) -> int:
    offs = indices.astype(np.int64) - np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return len(np.unique(offs))
