from krylov_tpu_torch.solvers._common import SolveResult
from krylov_tpu_torch.solvers.cg import cg_kernel
from krylov_tpu_torch.solvers.mrr import mrr_kernel

__all__ = ["SolveResult", "cg_kernel", "mrr_kernel"]
