"""Sparse operator containers holding torch tensors.

The counterparts of :mod:`krylov_tpu.sparse.formats`: :class:`DiaMatrix`
(banded storage), :class:`StencilMatrix` (a stencil on a structured grid,
with per-term coefficient grids or constant per-term weights),
:class:`EllMatrix` (padded fixed-width rows), :class:`HybMatrix` (ELL plus
a tail of fixed-width chunks for long rows) and :class:`DenseMatrix`.
Containers are frozen dataclasses; structural metadata (offsets, stencil,
grid, shape) is plain Python, the numeric data are tensors on the device
the operator runs on.

Every ``matvec`` takes ``x`` of shape ``(n,)`` or ``(batch, n)``.  The
gather containers (ELL, HYB) gather with the batch leading, one element
per stored index and member, and add each HYB tail chunk as one
batch-wide row.  The JAX package's ``vmap`` rules gather batch-wide rows
of an ``(n, batch)`` block instead.  On an H100 with PyTorch 2.11, torch's
row gathers of such a block (``index_select``, indexing, ``gather``) take
10-19 ms at 2^20 rows and 16 slots a row for any batch of 2 or more (one
thread block per index), against 0.94 ms for the leading-batch gather of
8 members; the HYB matvec of 8 right-hand sides takes 17.6 ms one way and
4.8 ms the other.  The JAX package's slice-gather formulation
of ``gather_rows`` is a TPU addressing device and has no counterpart
here: a GPU gathers elements directly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from krylov_tpu_torch.device import default_device


def as_torch_dtype(dtype):
    """The torch dtype of a torch or numpy dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def as_numpy_dtype(dtype):
    """The numpy dtype of a torch or numpy dtype (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pad_shift(x: torch.Tensor, pads, shifts, size):
    """Shifted window of the zero-padded ``x`` (one slice per trailing
    axis; leading axes are batch axes)."""
    xp = torch.nn.functional.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    idx = tuple(
        slice(lo + d, lo + d + g) for (lo, _), d, g in zip(pads, shifts, size)
    )
    return xp[(...,) + idx]


def _gather_sum(data: torch.Tensor, indices: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sum_s data[i, s] * x[..., indices[i, s]]`` for ``x`` of shape
    ``(n,)`` or ``(batch, n)``: one element gather per stored index and
    batch member."""
    g = x.index_select(-1, indices.reshape(-1)).view(x.shape[:-1] + indices.shape)
    return (data * g).sum(-1)


def _scatter_add_rows(y: torch.Tensor, rows: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """``y[..., rows] += extra``, duplicate rows accumulating (in place).

    The rows are indexed on a view with the batch axis trailing, so each
    index adds a batch-wide row.  On CUDA, ``index_add_`` accumulates
    duplicates with atomics, whose order (and so the last bits of a row fed
    by several HYB tail chunks) changes from run to run;
    ``index_put_(accumulate=True)`` sorts the rows first and is
    deterministic there.  On the CPU, ``index_add_`` adds in index order,
    as the JAX package's scatter does."""
    yt, et = y.movedim(-1, 0), extra.movedim(-1, 0)
    if y.device.type == "cuda":
        yt.index_put_((rows,), et, accumulate=True)
    else:
        yt.index_add_(0, rows, et)
    return y


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Banded matrix in row-indexed diagonal storage.

    ``data[d, i] == A[i, i + offsets[d]]``; entries whose column index falls
    outside ``[0, N)`` must be stored as zero.
    """

    data: torch.Tensor  # (ndiags, nrows)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        # Upper bound (stored entries); exact for fixtures without in-band zeros.
        n = self.shape[0]
        return sum(n - abs(o) for o in self.offsets)

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y[i] = sum_d data[d, i] * x[i + offsets[d]] via zero-padded shifts."""
        n = self.shape[0]
        pads = [(max(0, -min(self.offsets)), max(0, max(self.offsets)))]
        y = x.new_zeros(x.shape[:-1] + (n,))
        for d, off in enumerate(self.offsets):
            y = y + self.data[d] * _pad_shift(x, pads, (off,), (n,))
        return y

    def todense(self) -> np.ndarray:
        n, m = self.shape
        data = _host(self.data)
        out = np.zeros((n, m), dtype=data.dtype)
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, m - off))
            out[i, i + off] = data[d, i]
        return out


@dataclasses.dataclass(frozen=True)
class StencilMatrix:
    """A stencil on a structured d-dim grid.

    ``coef[s, *g] = A[flat(g), flat(g + stencil[s])]`` — row-indexed, like
    :class:`DiaMatrix`; couplings leaving the grid are stored as zero.

    **Constant-coefficient form**: ``coef`` may instead be a flat
    ``(nstencil,)`` vector of per-term weights.  Dirichlet boundaries come
    out the same: a coupling leaving the grid reads the zero padding of
    ``x``.
    """

    coef: torch.Tensor  # (nstencil, *grid) or (nstencil,) constant weights
    stencil: Tuple[Tuple[int, ...], ...]  # per-term grid displacement
    grid: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, int]:
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.coef.dtype

    @property
    def device(self) -> torch.device:
        return self.coef.device

    @property
    def nnz(self) -> int:
        return len(self.stencil) * self.shape[0]  # upper bound (stored entries)

    @property
    def is_constant(self) -> bool:
        """True for the constant-coefficient (per-term scalar weight) form."""
        return self.coef.ndim == 1

    def grid_coef(self) -> torch.Tensor:
        """Full ``(nstencil, *grid)`` coefficients; for the constant form the
        weights broadcast over the grid with leaving-the-grid couplings
        zeroed."""
        if not self.is_constant:
            return self.coef
        ns = len(self.stencil)
        mask = torch.ones((ns,) + self.grid, dtype=torch.bool, device=self.device)
        for s, disp in enumerate(self.stencil):
            for ax, d in enumerate(disp):
                if d == 0:
                    continue
                sl = [s] + [slice(None)] * len(self.grid)
                sl[1 + ax] = slice(self.grid[ax] - d, None) if d > 0 else slice(0, -d)
                mask[tuple(sl)] = False
        w = self.coef.reshape((ns,) + (1,) * len(self.grid))
        return torch.where(mask, w, torch.zeros((), dtype=self.dtype, device=self.device))

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Flat DIA offsets equivalent to the stencil displacements."""
        strides = np.cumprod((1,) + self.grid[:0:-1])[::-1]
        return tuple(
            int(sum(d * s for d, s in zip(disp, strides))) for disp in self.stencil
        )

    def _pads(self):
        return [
            (max(0, -min(d[ax] for d in self.stencil)), max(0, max(d[ax] for d in self.stencil)))
            for ax in range(len(self.grid))
        ]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A x`` for ``x`` of shape ``(n,)`` or ``(batch, n)``: on a CUDA
        tensor of a 2-D/3-D grid through K1
        (:func:`krylov_tpu_torch.kernels.stencil.stencil_matvec`, one launch
        for the block), else as the chain of shifted windows of the
        zero-padded grid."""
        if x.is_cuda and len(self.grid) in (2, 3):
            from krylov_tpu_torch.kernels.stencil import stencil_matvec

            return stencil_matvec(self, x.contiguous())
        xg = x.reshape(x.shape[:-1] + self.grid)
        pads = self._pads()
        y = torch.zeros_like(xg)
        for s, disp in enumerate(self.stencil):
            y = y + self.coef[s] * _pad_shift(xg, pads, disp, self.grid)
        return y.reshape(x.shape)

    def collapse_to_2d(self):
        """Collapse a 3-D stencil operator to the 2-D form the kernels take:
        grid ``(g0, g1*g2)``, displacement ``(d0, d1, d2) -> (d0, d1*g2 + d2)``.

        Exact for grid-coefficient operators (their stored boundary zeros
        kill couplings that leave the grid).  The constant form loses the
        inner-axis boundary, so the returned ``sub = (g2, per-term d2)`` tells
        the kernel which lanes to mask.

        Returns ``(coef2, stencil2, grid2, sub)``.
        """
        if len(self.grid) == 2:
            return self.coef, self.stencil, self.grid, None
        if len(self.grid) != 3:
            raise ValueError(f"collapse_to_2d supports 2-D/3-D grids, got {self.grid}")
        g0, g1, g2 = self.grid
        stencil2 = tuple((d0, d1 * g2 + d2) for d0, d1, d2 in self.stencil)
        if self.is_constant:
            sub = (g2, tuple(d2 for _, _, d2 in self.stencil))
            return self.coef, stencil2, (g0, g1 * g2), sub
        coef2 = self.coef.reshape(len(self.stencil), g0, g1 * g2)
        return coef2, stencil2, (g0, g1 * g2), None

    def to_dia(self) -> DiaMatrix:
        """Exact conversion to flat DIA storage (duplicate offsets merged)."""
        n = self.shape[0]
        coef = self.grid_coef().reshape(len(self.stencil), n)
        merged: dict = {}
        for s, off in enumerate(self.offsets):
            merged[off] = merged[off] + coef[s] if off in merged else coef[s].clone()
        keys = sorted(merged)
        return DiaMatrix(torch.stack([merged[o] for o in keys]), tuple(keys), (n, n))

    def todense(self) -> np.ndarray:
        return self.to_dia().todense()


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK (padded fixed-width rows).

    ``data[i, s]`` is the value of the ``s``-th stored entry of row ``i``
    and ``indices[i, s]`` (int32) its column.  Padding slots hold value 0
    with an in-range column, so they add nothing to the matvec
    ``(data * x[indices]).sum(-1)``.
    """

    data: torch.Tensor  # (nrows, width)
    indices: torch.Tensor  # (nrows, width) int32
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.data))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _gather_sum(self.data, self.indices, x)

    def todense(self) -> np.ndarray:
        data, idx = _host(self.data), _host(self.indices)
        out = np.zeros(self.shape, dtype=data.dtype)
        np.add.at(out, (np.arange(idx.shape[0])[:, None], idx), data)
        return out


@dataclasses.dataclass(frozen=True)
class HybMatrix:
    """Hybrid ELL + tail storage for skewed row-nnz distributions.

    The first ``w`` entries of every row live in an ELL block
    (``ell_data``/``ell_indices``, ``(n, w)``).  The overflow of each
    longer row is split into chunks of the fixed-width tail block
    (``tail_data``/``tail_indices``, ``(t, w_tail)``), each chunk naming
    its row in ``tail_rows``; the chunks of a row are added to it by a
    scatter-add.  Padding slots hold value 0 with an in-range column;
    padding chunks name row 0 with all-zero data.  ``w`` is chosen at
    conversion time to minimise storage
    (:func:`krylov_tpu_torch.sparse.convert.hyb_split_width`).
    """

    ell_data: torch.Tensor  # (n, w)
    ell_indices: torch.Tensor  # (n, w) int32
    tail_rows: torch.Tensor  # (t,) int32
    tail_data: torch.Tensor  # (t, w_tail)
    tail_indices: torch.Tensor  # (t, w_tail) int32
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.ell_data.dtype

    @property
    def device(self) -> torch.device:
        return self.ell_data.device

    @property
    def width(self) -> int:
        return self.ell_data.shape[1]

    @property
    def tail_width(self) -> int:
        return self.tail_data.shape[1]

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.ell_data)) + int(torch.count_nonzero(self.tail_data))

    @property
    def stored_entries(self) -> int:
        """Padded storage slots in all (what HYB minimises against ELL)."""
        return self.ell_data.numel() + self.tail_data.numel()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = _gather_sum(self.ell_data, self.ell_indices, x)
        return _scatter_add_rows(y, self.tail_rows, _gather_sum(self.tail_data, self.tail_indices, x))

    def todense(self) -> np.ndarray:
        data, idx = _host(self.ell_data), _host(self.ell_indices)
        out = np.zeros(self.shape, dtype=data.dtype)
        np.add.at(out, (np.arange(idx.shape[0])[:, None], idx), data)
        t_idx = _host(self.tail_indices)
        np.add.at(out, (_host(self.tail_rows)[:, None], t_idx), _host(self.tail_data))
        return out


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operand; the matvec is one matrix product."""

    data: torch.Tensor  # (nrows, ncols)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return self.data.shape[0] * self.data.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.data @ x if x.ndim == 1 else x @ self.data.T

    def todense(self) -> np.ndarray:
        return _host(self.data)


Operator = DiaMatrix | StencilMatrix | EllMatrix | HybMatrix | DenseMatrix
_CONTAINERS = (DiaMatrix, StencilMatrix, EllMatrix, HybMatrix, DenseMatrix)


def to_device(A: Operator, device) -> Operator:
    """``A`` with its tensor leaves moved to ``device`` (a plain ``.to()``)."""
    moved = {
        f.name: getattr(A, f.name).to(device)
        for f in dataclasses.fields(A)
        if isinstance(getattr(A, f.name), torch.Tensor)
    }
    return dataclasses.replace(A, **moved)


def as_operator(A, dtype=None, device=None) -> Operator:
    """Coerce ``A`` into one of this package's containers.

    The containers pass unchanged.  A scipy sparse matrix goes through
    :func:`krylov_tpu_torch.sparse.convert.from_scipy` (DIA, ELL or HYB by
    its pattern) and a 2-D numpy array or tensor becomes a
    :class:`DenseMatrix`; ``dtype`` (torch or numpy) casts them, and they
    land on ``device`` (a host input defaults to the CUDA device, see
    :mod:`krylov_tpu_torch.device`; a tensor stays where it is).
    ``krylov_tpu`` containers carry across with
    :func:`krylov_tpu_torch.sparse.convert.from_jax_operator`."""
    from krylov_tpu_torch.sparse import convert

    if isinstance(A, _CONTAINERS):
        return A
    if hasattr(A, "tocsr") and hasattr(A, "nnz"):  # scipy sparse
        return convert.from_scipy(A, dtype=dtype, device=device)
    if isinstance(A, (np.ndarray, torch.Tensor)):
        if device is None and isinstance(A, np.ndarray):
            device = default_device()
        data = torch.as_tensor(A, device=device)
        if dtype is not None:
            data = data.to(as_torch_dtype(dtype))
        if data.ndim != 2:
            raise ValueError(f"expected a 2-D operand, got shape {tuple(data.shape)}")
        return DenseMatrix(data)
    raise TypeError(
        f"krylov_tpu_torch takes its own containers, scipy sparse matrices and "
        f"2-D numpy arrays or tensors, got {type(A).__module__}.{type(A).__name__}; "
        "krylov_tpu containers convert with sparse.convert.from_jax_operator"
    )
