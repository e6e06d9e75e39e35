"""Run a function on every rank of a fresh ``torch.distributed`` world.

One process a rank (``spawn``), a ``file://`` store in a temporary
directory, gloo on the CPU and NCCL on cards, one card a rank (rank r on
card r).  The diagnostics that run multi-rank solves
(:mod:`.dryrun_multichip`, :mod:`.weak_scaling`) start their worlds here.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, device_type: str, store: str, fn, args) -> None:
    import krylov_tpu_torch
    from krylov_tpu_torch.dist import make_mesh

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=world, device_id=device)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    krylov_tpu_torch.set_default_device(device)
    try:
        fn(make_mesh(device_type), *args)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, device_type: str, args: tuple = (), timeout: float = 600.0) -> None:
    """``fn(mesh, *args)`` on each of ``world`` ranks; ``fn`` must be a
    module-level function (it is pickled by name).  Raises when a rank
    raises (torch then stops the others) or ``timeout`` seconds pass (every
    rank is then killed)."""
    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"{world} NCCL ranks need {world} cards, this machine has {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp()
    ctx = mp.start_processes(_rank, args=(world, device_type, os.path.join(tmp, "store"), fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the world of {world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
