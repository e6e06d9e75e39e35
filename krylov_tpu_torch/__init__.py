"""krylov_tpu_torch: the PyTorch/CUDA port of :mod:`krylov_tpu`.

CG, MrR and the k-skip family (k-skip CG, k-skip MrR, adaptive k-skip MrR)
on stencil, banded, ELL, HYB and dense operators (scipy, numpy and torch
inputs convert at the front door), with device-side restarts, host-float64
refinement and batched right-hand sides.  2-D/3-D stencil systems run the
whole solve in one hand-written CUDA kernel on a CUDA device
(``kernels/csrc``), or through the kernels' plain PyTorch versions on the
CPU; other operators run eager loops.  The package imports no JAX.
"""

from krylov_tpu_torch import sparse
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

__version__ = "0.1.0"

__all__ = [
    "sparse", "solve", "solve_device", "solve_batched", "cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr",
]
