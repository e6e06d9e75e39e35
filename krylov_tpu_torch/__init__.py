"""krylov_tpu_torch: the PyTorch/CUDA port of :mod:`krylov_tpu`.

CG, MrR, the k-skip family (k-skip CG, k-skip MrR, adaptive k-skip MrR),
the preconditioned and pipelined CG family (with the Jacobi and Chebyshev
preconditioners of :mod:`krylov_tpu_torch.precond`) and the Chebyshev-basis
CA-CG and CA-MrR, on stencil, banded, ELL, HYB and dense operators (scipy, numpy and torch
inputs convert at the front door), with device-side restarts, host-float64
refinement, batched right-hand sides, chunked solves that carry the loops'
state exactly (``chunk_iters=``), checkpoints (:mod:`krylov_tpu_torch.checkpoint`)
and the ``condition.json`` driver (``python -m krylov_tpu_torch``).  2-D/3-D stencil systems run the
whole solve in one hand-written CUDA kernel on a CUDA device
(``kernels/csrc``), or through the kernels' plain PyTorch versions on the
CPU; other methods and operators run eager loops, whose stencil SpMV on
the card is the hand-written K1.  Host input goes to the CUDA device
unless the caller names another (``device=``, :func:`set_default_device`).
The package imports no JAX.
"""

from krylov_tpu_torch import sparse
from krylov_tpu_torch.context import DEFAULT_CONTEXT, Context
from krylov_tpu_torch.api import (
    adaptivekskipmrr,
    cg,
    kskipcg,
    kskipmrr,
    mrr,
    solve,
    solve_batched,
    solve_device,
)
from krylov_tpu_torch.device import default_device, set_default_device

__version__ = "0.1.0"

__all__ = [
    "sparse", "Context", "DEFAULT_CONTEXT", "solve", "solve_device", "solve_batched", "cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr",
    "default_device", "set_default_device",
]
