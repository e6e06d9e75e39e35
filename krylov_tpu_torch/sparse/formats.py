"""Sparse operator containers holding torch tensors.

The counterparts of :mod:`krylov_tpu.sparse.formats` for the stencil main
path: :class:`DiaMatrix` (banded storage) and :class:`StencilMatrix`
(a stencil on a structured grid, with per-term coefficient grids or
constant per-term weights).  Containers are frozen dataclasses; structural
metadata (offsets, stencil, grid, shape) is plain Python, the numeric data
is one tensor whose device is the device the operator runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _pad_shift(x: torch.Tensor, pads, shifts, size):
    """Shifted window of the zero-padded ``x`` (one slice per axis)."""
    xp = torch.nn.functional.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    idx = tuple(
        slice(lo + d, lo + d + g) for (lo, _), d, g in zip(pads, shifts, size)
    )
    return xp[idx]


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
        y = torch.zeros(n, dtype=x.dtype, device=x.device)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d] * _pad_shift(x, pads, (off,), (n,))
        return y

    def todense(self) -> np.ndarray:
        n, m = self.shape
        data = self.data.cpu().numpy()
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
        xg = x.reshape(self.grid)
        pads = self._pads()
        y = torch.zeros_like(xg)
        for s, disp in enumerate(self.stencil):
            y = y + self.coef[s] * _pad_shift(xg, pads, disp, self.grid)
        return y.reshape(-1)

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


Operator = DiaMatrix | StencilMatrix


def to_device(A: Operator, device) -> Operator:
    """``A`` with its tensor leaves moved to ``device`` (a plain ``.to()``)."""
    field = "data" if isinstance(A, DiaMatrix) else "coef"
    return dataclasses.replace(A, **{field: getattr(A, field).to(device)})


def as_operator(A) -> Operator:
    """Return ``A`` if it is one of this package's containers.

    Scipy sparse matrices, dense arrays and the ELL/HYB/dense containers
    are not ported yet (ROADMAP queue 1, item 8: irregular operators and
    IO)."""
    if isinstance(A, (DiaMatrix, StencilMatrix)):
        return A
    raise TypeError(
        f"krylov_tpu_torch takes DiaMatrix or StencilMatrix operators, got "
        f"{type(A).__name__}; scipy/dense/ELL/HYB inputs wait for the "
        "'irregular operators and IO' port (ROADMAP queue 1, item 8); "
        "krylov_tpu containers convert with sparse.convert.from_jax_operator"
    )
