"""ctypes bindings for the native preprocessing library (native/).

A copy of :mod:`krylov_tpu.native` (numpy and ctypes only), which cannot be
imported here: importing ``krylov_tpu`` imports jax.  Loads the repository's
``native/libkrylov_native.so`` (built with ``make -C native``; or the file
``KRYLOV_NATIVE_LIB`` names) and exposes the host-side hot paths — Matrix
Market parsing, COO→CSR, CSR→ELL/DIA packing — with the same numpy/scipy
fallbacks when the library is absent.  A library that is present but does
not load on this host (another C library, another architecture) falls back
too; :data:`load_error` then says why.

Everything here is host preprocessing; the device path is PyTorch and the
CUDA kernels.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
load_error: Optional[str] = None  # why a present library did not load


def _find_lib() -> Optional[str]:
    cand = os.environ.get("KRYLOV_NATIVE_LIB")
    if cand and os.path.exists(cand):
        return cand
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(here, "native", "libkrylov_native.so")
    return cand if os.path.exists(cand) else None


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, load_error
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        load_error = f"{path}: {e}"
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)

    lib.mm_read_header.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, ip, ip]
    lib.mm_read_header.restype = ctypes.c_int
    lib.mm_read_data.argtypes = [
        ctypes.c_char_p, i32p, i32p, f64p, ctypes.c_int64, i64p,
    ]
    lib.mm_read_data.restype = ctypes.c_int
    lib.coo_to_csr.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, f64p, i64p, i32p, f64p,
    ]
    lib.coo_to_csr.restype = ctypes.c_int
    lib.csr_max_row_nnz.argtypes = [ctypes.c_int64, i64p, i32p]
    lib.csr_max_row_nnz.restype = ctypes.c_int64
    lib.csr_to_ell.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p, f64p, i32p,
    ]
    lib.csr_to_ell.restype = ctypes.c_int
    lib.csr_count_diagonals.argtypes = [
        ctypes.c_int64, i64p, i32p, ctypes.c_int64, i64p,
    ]
    lib.csr_count_diagonals.restype = ctypes.c_int64
    lib.csr_to_dia.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, i32p, f64p, f64p,
    ]
    lib.csr_to_dia.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return load_library() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_mtx(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Parse a Matrix Market coordinate file -> (rows, cols, values, shape).

    Symmetric files are expanded (mirrored off-diagonal entries).  Uses the
    native parser when built; falls back to ``scipy.io.mmread``.
    """
    lib = load_library()
    if lib is None:
        import scipy.io

        coo = scipy.io.mmread(path).tocoo()
        return (
            coo.row.astype(np.int32),
            coo.col.astype(np.int32),
            coo.data.astype(np.float64),
            coo.shape,
        )
    r = ctypes.c_int64()
    c = ctypes.c_int64()
    nnz = ctypes.c_int64()
    sym = ctypes.c_int()
    pat = ctypes.c_int()
    rc = lib.mm_read_header(
        path.encode(), ctypes.byref(r), ctypes.byref(c), ctypes.byref(nnz),
        ctypes.byref(sym), ctypes.byref(pat),
    )
    if rc != 0:
        raise IOError(f"mm_read_header failed ({rc}) for {path}")
    n = nnz.value
    rows = np.empty(n, np.int32)
    cols = np.empty(n, np.int32)
    vals = np.empty(n, np.float64)
    out_n = ctypes.c_int64()
    rc = lib.mm_read_data(
        path.encode(), _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctypes.c_double), n, ctypes.byref(out_n),
    )
    if rc != 0:
        raise IOError(f"mm_read_data failed ({rc}) for {path}")
    rows, cols, vals = rows[: out_n.value], cols[: out_n.value], vals[: out_n.value]
    if sym.value:
        off = rows != cols
        r0, c0 = rows, cols
        rows = np.concatenate([r0, c0[off]])
        cols = np.concatenate([c0, r0[off]])
        vals = np.concatenate([vals, vals[off]])
    return rows, cols, vals, (r.value, c.value)


def coo_to_csr(
    nrows: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO -> CSR (native counting sort, or scipy fallback)."""
    lib = load_library()
    if lib is None:
        import scipy.sparse as sp

        csr = sp.coo_matrix(
            (vals, (rows, cols)), shape=(nrows, int(cols.max()) + 1)
        ).tocsr()
        return csr.indptr.astype(np.int64), csr.indices.astype(np.int32), csr.data
    nnz = rows.shape[0]
    indptr = np.empty(nrows + 1, np.int64)
    indices = np.empty(nnz, np.int32)
    data = np.empty(nnz, np.float64)
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    rc = lib.coo_to_csr(
        nrows, nnz, _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctypes.c_double), _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32), _ptr(data, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(f"coo_to_csr failed ({rc})")
    return indptr, indices, data


def csr_to_ell(
    nrows: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    width: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> padded ELL arrays (native, or numpy loop fallback)."""
    lib = load_library()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    if lib is None:
        w = width or int(np.diff(indptr).max(initial=1))
        ell_data = np.zeros((nrows, w))
        ell_idx = np.zeros((nrows, w), np.int32)
        for i in range(nrows):
            lo, hi = indptr[i], indptr[i + 1]
            m = min(hi - lo, w)
            ell_data[i, :m] = data[lo : lo + m]
            ell_idx[i, :m] = indices[lo : lo + m]
        return ell_data, ell_idx
    if width is None:
        width = int(lib.csr_max_row_nnz(nrows, _ptr(indptr, ctypes.c_int64), None))
        width = max(width, 1)
    ell_data = np.empty((nrows, width), np.float64)
    ell_idx = np.empty((nrows, width), np.int32)
    rc = lib.csr_to_ell(
        nrows, width, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_double), _ptr(ell_data, ctypes.c_double),
        _ptr(ell_idx, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError(f"csr_to_ell failed ({rc})")
    return ell_data, ell_idx


def csr_to_dia(
    nrows: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    max_offsets: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> row-indexed DIA arrays (offsets, dia_data), native fast path."""
    lib = load_library()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    if lib is None:
        offs = np.unique(indices.astype(np.int64) - np.repeat(
            np.arange(nrows), np.diff(indptr)
        ))
        dia = np.zeros((len(offs), nrows))
        lut = {int(o): i for i, o in enumerate(offs)}
        for r in range(nrows):
            for k in range(indptr[r], indptr[r + 1]):
                dia[lut[int(indices[k]) - r], r] += data[k]
        return offs, dia
    offsets = np.empty(max_offsets, np.int64)
    cnt = lib.csr_count_diagonals(
        nrows, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        max_offsets, _ptr(offsets, ctypes.c_int64),
    )
    if cnt < 0:
        raise ValueError(
            f"matrix has more than {max_offsets} distinct diagonals"
        )
    offsets = offsets[:cnt]
    dia = np.empty((cnt, nrows), np.float64)
    rc = lib.csr_to_dia(
        nrows, cnt, _ptr(offsets, ctypes.c_int64), _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32), _ptr(data, ctypes.c_double),
        _ptr(dia, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(f"csr_to_dia failed ({rc})")
    return offsets, dia
