"""Run a function on every rank of a fresh ``torch.distributed`` world: one
process a rank (``spawn``), a ``file://`` store in a temporary directory
under ``TMPDIR``, NCCL with one card a rank (rank r on card r), gloo on the
CPU.  The benchmark's own copy, so that its yardstick does not move with
the program's diagnostics."""

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
        fn(make_mesh(device_type), rank, device, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, device_type: str, args: tuple = (), timeout: float = 300.0) -> None:
    """``fn(mesh, rank, device, *args)`` on each of ``world`` ranks; ``fn``
    must be a module-level function (it is pickled by name).  Raises when a
    rank raises (torch then stops the others) or ``timeout`` seconds pass;
    every rank process has ended when it returns or raises."""
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
