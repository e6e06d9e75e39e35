"""K1: structured-grid stencil SpMV, ``y = A x`` on a 2-D grid.

The counterpart of :func:`krylov_tpu.kernels.stencil.stencil_matvec_2d`.
On a CUDA tensor :func:`stencil_matvec_2d` launches the hand-written kernel
in ``csrc/stencil.cu`` (see the note there); on a CPU tensor it runs
:func:`stencil_matvec_2d_reference`, the plain PyTorch version of the same
function.  Both take one vector ``(n,)`` or a block ``(batch, n)``, the
kernel in one launch.

K1 is the SpMV of the eager loops on a stencil operator on the card
(:meth:`~krylov_tpu_torch.sparse.StencilMatrix.matvec` calls
:func:`stencil_matvec`), so a call's host cost is a large share of what an
iteration costs.  What the C entry point needs besides its pointers (the
geometry, collapsed to 2-D for a 3-D grid, and the constant form's
weights) is built once per operator into one C struct (:class:`_K1Params`,
held in ``_PARAMS``; the weights cost a device-to-host copy at an
operator's first call, again after the tensor is changed in place), and
each call checks only device, dtype, contiguity and length, and passes
seven arguments.

The Chebyshev step (:func:`chebyshev_apply`) is K1 with a Chebyshev
preconditioner's vector updates in its epilogue: a degree-d application on
a stencil operator on the card in d - 1 launches of ``cheb_step2d_kernel``
(one of ``cheb_scale_kernel`` at degree 1), from the same parameters.
Their launches count in ``tracing.totals.stencil_matvec_2d`` and
``tracing.totals.chebyshev_apply`` (:func:`krylov_tpu_torch.tracing.count`).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Tuple

import torch

from krylov_tpu_torch import tracing
from krylov_tpu_torch.kernels import _build
from krylov_tpu_torch.sparse.formats import StencilMatrix, _pad_shift

_DTYPES = (torch.float32, torch.float64)


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


def require_cuda(name: str, coef: torch.Tensor, v: torch.Tensor, stencil, grid, batch: bool = False) -> None:
    """Raise on inputs the kernels do not take (``batch``: ``v`` may also
    be a ``(batch, n)`` block)."""
    if v.device.type != "cuda" or coef.device != v.device:
        raise ValueError(f"{name}: tensors must share one CUDA device, got {coef.device} and {v.device}")
    if v.dtype not in _DTYPES or coef.dtype != v.dtype:
        raise ValueError(f"{name}: needs float32 or float64 of one dtype, got {coef.dtype} and {v.dtype}")
    if not (coef.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    n = grid[0] * grid[1]
    vec_ok = v.shape == (n,) or (batch and v.ndim == 2 and v.shape[1] == n)
    if not vec_ok or coef.shape[:1] != (len(stencil),) or coef.shape[1:] not in ((), tuple(grid)):
        raise ValueError(f"{name}: shapes coef {tuple(coef.shape)}, vector {tuple(v.shape)} do not fit grid {grid}")


class _K1Params(ctypes.Structure):
    """``K1Params`` of ``csrc/stencil.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in ("ns", "g0", "g1", "g2", "is_const")] + [
        ("disp", ctypes.c_int * (3 * _build.MAX_TERMS)),
        ("weights", ctypes.c_double * _build.MAX_TERMS),
    ]


# (stencil, grid, sub, coefficient slot) as the caller passes them -> (weak
# reference to coef or None, address of the _K1Params, n, coef.numel(), the
# _K1Params)
_PARAMS: dict = {}


def _as_2d(coef: torch.Tensor, stencil, grid, sub) -> tuple:
    """``(coef, stencil, grid, sub)`` on a 2-D grid: a 3-D one collapsed as
    :meth:`~krylov_tpu_torch.sparse.StencilMatrix.collapse_to_2d` does."""
    if len(grid) == 3:
        return StencilMatrix(coef, stencil, grid).collapse_to_2d()
    return coef, stencil, grid, sub


def _params(coef: torch.Tensor, x: torch.Tensor, stencil, grid, sub) -> tuple:
    """``(address of the _K1Params, n, coef.numel())`` for K1 on ``coef``
    over a 2-D grid, or a 3-D one (collapsed here by :func:`_as_2d`).

    The grid form's struct depends on the geometry alone; the constant
    form's holds the weights too, so it belongs to one coefficient tensor
    and version.  Built (and the inputs' shapes checked) at the first call
    of each."""
    slot = (id(coef), coef._version) if coef.ndim == 1 else None
    key = (stencil, grid, sub, slot)
    entry = _PARAMS.get(key)
    if entry is not None and (slot is None or entry[0]() is coef):
        return entry[1:4]
    coef, stencil, grid, sub = _as_2d(coef, stencil, grid, sub)
    require_cuda("stencil_matvec_2d", coef, x, stencil, grid, batch=True)
    ns, g0, g1, g2, is_const, disp = geometry(stencil, grid, sub, coef.ndim == 1)
    p = _K1Params(ns, g0, g1, g2, is_const)
    p.disp[: 3 * ns] = list(disp)
    if is_const:
        with tracing.host_read():
            p.weights[:ns] = coef.tolist()  # the one device-to-host copy
    if len(_PARAMS) >= 64:
        _PARAMS.clear()
    entry = _PARAMS[key] = (weakref.ref(coef) if slot else None, ctypes.addressof(p), g0 * g1, coef.numel(), p)
    return entry[1:4]


def host_weights(coef: torch.Tensor, x: torch.Tensor, stencil, grid, sub) -> ctypes.Array:
    """The constant form's weights as doubles on the host, from the struct
    K1 keeps for ``coef`` (:func:`_params`: read from the card once per
    coefficient tensor and version), for the C entry points that take them
    as an argument (K4's specialised pass).  The struct stays in ``_PARAMS``
    until a later call of :func:`_params` clears the cache, so pass it on
    before the next one."""
    return _K1Params.from_address(_params(coef, x, stencil, grid, sub)[0]).weights


def stencil_matvec_2d_reference(
    coef: torch.Tensor, x: torch.Tensor, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], sub=None,
) -> torch.Tensor:
    """Plain PyTorch K1: shifted windows of the zero-padded grid, terms added
    in stencil order; ``sub = (g2, d2s)`` masks the inner-axis boundary of a
    collapsed 3-D constant stencil.  ``x`` may carry a leading batch axis."""
    pads = [
        (max(0, -min(d[ax] for d in stencil)), max(0, max(d[ax] for d in stencil)))
        for ax in range(2)
    ]
    xg = x.reshape(x.shape[:-1] + tuple(grid))
    if sub is not None and coef.ndim == 1:
        i2 = torch.arange(grid[1], device=x.device) % sub[0]
    acc = None
    for s, disp in enumerate(stencil):
        term = coef[s] * _pad_shift(xg, pads, disp, grid)
        if sub is not None and coef.ndim == 1 and sub[1][s] != 0:
            d2 = sub[1][s]
            term = torch.where((i2 + d2 >= 0) & (i2 + d2 < sub[0]), term, torch.zeros((), dtype=term.dtype, device=term.device))
        acc = term if acc is None else acc + term
    return acc.reshape(x.shape)


def stencil_matvec_2d(
    coef: torch.Tensor, x: torch.Tensor, *, stencil: Tuple[Tuple[int, int], ...],
    grid: Tuple[int, int], sub=None,
) -> torch.Tensor:
    """y = A x for a 2-D stencil operator; returns ``y`` of ``x``'s shape,
    ``(n,)`` or ``(batch, n)`` (one launch for the block).

    ``coef`` is ``(ns, g0, g1)`` coefficient grids or ``(ns,)`` constant
    weights.  A 3-D operator (``grid`` of three, ``sub`` None) runs on its
    collapsed 2-D view (:func:`_as_2d`)."""
    index = x.get_device()  # -1 off the card
    if index < 0 and x.device.type == "cpu":
        coef, stencil, grid, sub = _as_2d(coef, stencil, grid, sub)
        return stencil_matvec_2d_reference(coef, x, stencil=stencil, grid=grid, sub=sub)
    params, n, numel = _params(coef, x, stencil, grid, sub)
    if not (index >= 0 and coef.get_device() == index and coef.dtype == x.dtype and x.dtype in _DTYPES
            and x.is_contiguous() and coef.is_contiguous() and x.ndim in (1, 2) and x.shape[-1] == n
            and coef.numel() == numel):
        coef2, stencil2, grid2, _ = _as_2d(coef, stencil, grid, sub)
        require_cuda("stencil_matvec_2d", coef2, x, stencil2, grid2, batch=True)
        raise ValueError(f"stencil_matvec_2d: coef {tuple(coef.shape)} does not fit grid {grid}")
    lib = _build.library()
    y = torch.empty_like(x)
    batch = x.shape[0] if x.ndim == 2 else 1
    args = (x.element_size(), coef.data_ptr(), x.data_ptr(), y.data_ptr(), batch, params)
    # torch's current stream of x's device as a raw handle: what
    # torch.cuda.current_stream().cuda_stream gives, without making a
    # Stream object (about 11 of a call's 32 us on the host of an H100)
    if index == torch.cuda.current_device():
        err = lib.krylov_stencil2d(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = lib.krylov_stencil2d(*args, torch._C._cuda_getCurrentRawStream(index))
    _build.check(err, "stencil_matvec_2d")
    tracing.count("stencil_matvec_2d", "launches")
    return y


def chebyshev_rounds(lib, stream, params, coef: torch.Tensor, v: torch.Tensor, z: torch.Tensor, inv: float,
                     steps) -> int:
    """Launch the rounds of a Chebyshev application into ``z`` on
    ``stream`` (the C entry points of ``lib``): with ``steps`` one
    ``cheb_step2d_kernel`` a step, ``d`` read from ``v`` in the first and
    then from two scratch directions in turn (neighbours read the old one),
    ``r`` and ``z`` updated in place; without, one ``cheb_scale_kernel``.
    Returns the launches."""
    size = v.element_size()
    if not steps:
        _build.check(lib.krylov_cheb_scale(size, v.data_ptr(), z.data_ptr(), v.numel(), inv, stream),
                     "chebyshev_apply")
        return 1
    batch = v.shape[0] if v.ndim == 2 else 1
    # r, then one direction for two steps, two for more (the last step
    # writes z alone)
    work = v.new_empty((min(len(steps), 3),) + v.shape) if len(steps) > 1 else None
    r = work[0].data_ptr() if work is not None else None
    d = v.data_ptr()
    for k, (c1, c2) in enumerate(steps):
        last = k == len(steps) - 1
        d_out = None if last else work[1 + k % (len(work) - 1)].data_ptr()
        err = lib.krylov_cheb_step2d(size, coef.data_ptr(), d, z.data_ptr(), r, d_out, batch, params, int(k == 0),
                                     int(last), inv, c1, c2, stream)
        _build.check(err, "chebyshev_apply")
        d = d_out
    return len(steps)


def chebyshev_apply(A: StencilMatrix, v: torch.Tensor, theta: float, steps) -> torch.Tensor:
    """``z = p(A) v`` of a Chebyshev preconditioner: the recurrence of
    :func:`krylov_tpu_torch.precond.chebyshev_loop` from ``theta`` and the
    ``(c1, c2)`` of each step
    (:func:`krylov_tpu_torch.precond.chebyshev_schedule`), on a CUDA
    tensor ``v``, ``(n,)`` or ``(batch, n)``, of a 2-D or 3-D stencil
    operator: one launch a step of the Chebyshev step (one altogether
    without steps), whose SpMV is K1's sum and whose updates round each
    operation as torch does, so ``z`` is the bits of the loop run by torch
    on the card."""
    index = v.get_device()
    if len(A.grid) not in (2, 3):
        raise ValueError(f"chebyshev_apply: takes a 2-D or 3-D grid, got {A.grid}")
    coef = A.coef
    params, n, numel = _params(coef, v, A.stencil, A.grid, None)
    if not (index >= 0 and coef.get_device() == index and coef.dtype == v.dtype and v.dtype in _DTYPES
            and v.is_contiguous() and coef.is_contiguous() and v.ndim in (1, 2) and v.shape[-1] == n
            and coef.numel() == numel):
        raise ValueError(f"chebyshev_apply: takes a contiguous float32 or float64 (n,) or (batch, n) vector on the "
                         f"operator's card, got {tuple(v.shape)} {v.dtype} on {v.device} for grid {A.grid}")
    lib = _build.library()
    z = torch.empty_like(v)
    # torch divides a CUDA tensor by a host number as a product with the
    # float64 reciprocal rounded to the tensor's dtype (the C entry points
    # round it so): in float32 not the reciprocal of float32 theta, which
    # differs at some theta (4.198167673414332 among them)
    inv = 1.0 / theta
    if index == torch.cuda.current_device():
        launches = chebyshev_rounds(lib, torch._C._cuda_getCurrentRawStream(index), params, coef, v, z, inv, steps)
    else:
        with torch.cuda.device(index):
            launches = chebyshev_rounds(lib, torch._C._cuda_getCurrentRawStream(index), params, coef, v, z, inv,
                                        steps)
    tracing.count("chebyshev_apply", "launches", n=launches)
    return z


def stencil_matvec(A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """Dispatch: K1 for 2-D/3-D grids (3-D on the collapsed (g0, g1*g2)
    view), the container's own matvec otherwise."""
    if not isinstance(A, StencilMatrix):
        raise TypeError(f"stencil_matvec takes a StencilMatrix, got {type(A).__name__}")
    if len(A.grid) not in (2, 3):
        return A.matvec(x)
    return stencil_matvec_2d(A.coef, x, stencil=A.stencil, grid=A.grid)
