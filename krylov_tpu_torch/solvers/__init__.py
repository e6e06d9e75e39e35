from krylov_tpu_torch.solvers._common import SolveResult
from krylov_tpu_torch.solvers.adaptive_kskip_mrr import adaptivekskipmrr_kernel
from krylov_tpu_torch.solvers.cacg import cacg_kernel, camrr_kernel
from krylov_tpu_torch.solvers.cg import cg_kernel
from krylov_tpu_torch.solvers.kskip_cg import kskipcg_kernel
from krylov_tpu_torch.solvers.kskip_mrr import kskipmrr_kernel
from krylov_tpu_torch.solvers.mrr import mrr_kernel
from krylov_tpu_torch.solvers.pipelined import (
    chronopoulos_gear_kernel,
    gropp_kernel,
    pcg_kernel,
    pipelined_cg_kernel,
)

__all__ = [
    "SolveResult",
    "adaptivekskipmrr_kernel",
    "cacg_kernel",
    "camrr_kernel",
    "cg_kernel",
    "chronopoulos_gear_kernel",
    "gropp_kernel",
    "kskipcg_kernel",
    "kskipmrr_kernel",
    "mrr_kernel",
    "pcg_kernel",
    "pipelined_cg_kernel",
]
