"""Hand-written CUDA kernels for the stencil solves, each beside its plain
PyTorch version (used for CPU tensors and as the reference on the card).
Sources are in ``csrc/``; :mod:`._build` compiles them at first use.
"""

from krylov_tpu_torch.kernels.fused import (
    TRACE_CAP,
    fused_cg_solve_2d,
    fused_cg_solve_2d_reference,
    fused_mrr_solve_2d,
    fused_mrr_solve_2d_reference,
)
from krylov_tpu_torch.kernels.fused_kskip import (
    fused_kskipcg_solve_2d,
    fused_kskipcg_solve_2d_reference,
    fused_kskipmrr_solve_2d,
    fused_kskipmrr_solve_2d_reference,
)
from krylov_tpu_torch.kernels.stencil import (
    stencil_matvec,
    stencil_matvec_2d,
    stencil_matvec_2d_reference,
)

__all__ = [
    "TRACE_CAP",
    "fused_cg_solve_2d",
    "fused_cg_solve_2d_reference",
    "fused_kskipcg_solve_2d",
    "fused_kskipcg_solve_2d_reference",
    "fused_kskipmrr_solve_2d",
    "fused_kskipmrr_solve_2d_reference",
    "fused_mrr_solve_2d",
    "fused_mrr_solve_2d_reference",
    "stencil_matvec",
    "stencil_matvec_2d",
    "stencil_matvec_2d_reference",
]
