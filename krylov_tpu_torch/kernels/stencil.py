"""K1: structured-grid stencil SpMV, ``y = A x`` on a 2-D grid.

The counterpart of :func:`krylov_tpu.kernels.stencil.stencil_matvec_2d`.
On a CUDA tensor :func:`stencil_matvec_2d` launches the hand-written kernel
in ``csrc/stencil.cu`` (one thread per output point, see the note there);
on a CPU tensor it runs :func:`stencil_matvec_2d_reference`, the plain
PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from krylov_tpu_torch.kernels import _build
from krylov_tpu_torch.sparse.formats import StencilMatrix, _pad_shift


def geometry(stencil, grid, sub, is_const: bool) -> tuple:
    """The geometry arguments of the C entry points,
    ``(ns, g0, g1, g2, is_const, disp)``, where ``disp`` is the (3, ns)
    ctypes int array of the displacements d0, d1 and d2."""
    ns = len(stencil)
    if ns > _build.MAX_TERMS:
        raise ValueError(f"the CUDA stencil takes at most {_build.MAX_TERMS} terms, got {ns}")
    g2, d2s = sub if (sub is not None and is_const) else (0, (0,) * ns)
    disp = [d[0] for d in stencil] + [d[1] for d in stencil] + list(d2s)
    return ns, grid[0], grid[1], g2, int(is_const), (ctypes.c_int * len(disp))(*disp)


def require_cuda(name: str, coef: torch.Tensor, v: torch.Tensor, stencil, grid) -> None:
    """Raise on inputs the kernels do not take."""
    if v.device.type != "cuda" or coef.device != v.device:
        raise ValueError(f"{name}: tensors must share one CUDA device, got {coef.device} and {v.device}")
    if v.dtype not in (torch.float32, torch.float64) or coef.dtype != v.dtype:
        raise ValueError(f"{name}: needs float32 or float64 of one dtype, got {coef.dtype} and {v.dtype}")
    if not (coef.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    n = grid[0] * grid[1]
    if v.shape != (n,) or coef.shape[:1] != (len(stencil),) or coef.shape[1:] not in ((), tuple(grid)):
        raise ValueError(f"{name}: shapes coef {tuple(coef.shape)}, vector {tuple(v.shape)} do not fit grid {grid}")


def stencil_matvec_2d_reference(
    coef: torch.Tensor, x: torch.Tensor, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], sub=None,
) -> torch.Tensor:
    """Plain PyTorch K1: shifted windows of the zero-padded grid, terms added
    in stencil order; ``sub = (g2, d2s)`` masks the inner-axis boundary of a
    collapsed 3-D constant stencil."""
    pads = [
        (max(0, -min(d[ax] for d in stencil)), max(0, max(d[ax] for d in stencil)))
        for ax in range(2)
    ]
    xg = x.reshape(grid)
    if sub is not None and coef.ndim == 1:
        i2 = torch.arange(grid[1], device=x.device) % sub[0]
    acc = None
    for s, disp in enumerate(stencil):
        term = coef[s] * _pad_shift(xg, pads, disp, grid)
        if sub is not None and coef.ndim == 1 and sub[1][s] != 0:
            d2 = sub[1][s]
            term = torch.where((i2 + d2 >= 0) & (i2 + d2 < sub[0]), term, torch.zeros((), dtype=term.dtype, device=term.device))
        acc = term if acc is None else acc + term
    return acc.reshape(-1)


def stencil_matvec_2d(
    coef: torch.Tensor, x: torch.Tensor, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], sub=None,
) -> torch.Tensor:
    """y = A x for a 2-D stencil operator; returns the flat vector.

    ``coef`` is ``(ns, g0, g1)`` coefficient grids or ``(ns,)`` constant
    weights."""
    if x.device.type == "cpu":
        return stencil_matvec_2d_reference(coef, x, stencil=stencil, grid=grid, sub=sub)
    require_cuda("stencil_matvec_2d", coef, x, stencil, grid)
    lib = _build.library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.krylov_stencil2d(
            x.element_size(), coef.data_ptr(), x.data_ptr(), y.data_ptr(),
            *geometry(stencil, grid, sub, coef.ndim == 1), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "stencil_matvec_2d")
    stencil_matvec_2d.launches += 1
    return y


stencil_matvec_2d.launches = 0


def stencil_matvec(A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """Dispatch: K1 for 2-D/3-D grids (3-D on the collapsed (g0, g1*g2)
    view), the container's own matvec otherwise."""
    if not isinstance(A, StencilMatrix):
        raise TypeError(f"stencil_matvec takes a StencilMatrix, got {type(A).__name__}")
    if len(A.grid) in (2, 3):
        coef2, stencil2, grid2, sub = A.collapse_to_2d()
        return stencil_matvec_2d(coef2, x, stencil=stencil2, grid=grid2, sub=sub)
    return A.matvec(x)
