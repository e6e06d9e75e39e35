"""Row-partitioned solves on ``torch.distributed`` (the counterpart of
:mod:`krylov_tpu.dist`): one process a rank, NCCL on cards, gloo on the CPU.

    torch.distributed.init_process_group("nccl", ...)   # the caller's world
    mesh = make_mesh()                                   # 1-D, the rows axis
    x, info = krylov_tpu_torch.solve(A, b, mesh=mesh)    # on every rank
"""

from krylov_tpu_torch.dist.mesh import make_mesh, row_axis
from krylov_tpu_torch.dist.spmv import ShardedOperator, shard_operator
from krylov_tpu_torch.dist.solve import solve_sharded

__all__ = [
    "make_mesh",
    "row_axis",
    "ShardedOperator",
    "shard_operator",
    "solve_sharded",
]
