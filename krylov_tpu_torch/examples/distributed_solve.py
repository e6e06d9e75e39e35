"""Row-partitioned distributed solve over a ``torch.distributed`` world.

    python -m krylov_tpu_torch.examples.distributed_solve [--device cuda|cpu] [--ranks R]
    torchrun --nproc-per-node R -m krylov_tpu_torch.examples.distributed_solve [--device ...]

Under ``torchrun`` it joins the world torchrun started (NCCL on cards,
gloo on the CPU).  Otherwise it starts one of ``--ranks`` processes
(:func:`krylov_tpu_torch.diagnostics.world.run_world`): by default 2 gloo
ranks on the CPU, or one NCCL rank a card on up to 4 cards.  Every rank
holds the whole system and solves its rows; the stencil's SpMV on a card
is K1 on each rank's slab.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

import krylov_tpu_torch
from krylov_tpu_torch.examples import device_args
from krylov_tpu_torch.sparse.fixtures import laplace2d


def solve_on(mesh) -> None:
    """Each rank's part: the whole system, the sharded solve, and on rank
    0 the report."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        print(f"devices: {world} x {mesh.device_type}")
    A = laplace2d(64, 128, dtype=torch.float32)  # grid (128, 64): leading axis sharded
    b = torch.ones(A.shape[0], dtype=torch.float32, device=A.device)
    x, info = krylov_tpu_torch.solve(A, b, method="adaptivekskipmrr", k=4, tol=1e-5, mesh=mesh, verbose=rank == 0)
    if rank == 0:
        true_res = torch.linalg.vector_norm(b - A.matvec(x)) / torch.linalg.vector_norm(b)
        print(f"-> true relative residual: {float(true_res):.3e}, khistory={np.asarray(info['khistory'])}")


def _torchrun(device_type: str) -> None:
    """Join the world of ``torchrun`` (its rank and size in the
    environment) and solve on it."""
    from krylov_tpu_torch.dist import make_mesh

    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo")
    krylov_tpu_torch.set_default_device(device)
    try:
        solve_on(make_mesh(device_type))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv,
                       ranks=(int, None, "ranks to start (default: 2 on the CPU, min(cards, 4) on cards)"))
    device_type = torch.device(args.device).type
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _torchrun(device_type)
        return
    from krylov_tpu_torch.diagnostics.world import run_world

    ranks = args.ranks or (min(torch.cuda.device_count(), 4) if device_type == "cuda" else 2)
    # by its module's name, so the ranks can import it when this file runs as __main__
    from krylov_tpu_torch.examples.distributed_solve import solve_on as rank_fn

    run_world(rank_fn, ranks, device_type)


if __name__ == "__main__":
    main()
