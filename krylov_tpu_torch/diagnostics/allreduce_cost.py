"""What one all-reduce of the row-partitioned path costs the host, in a
``torch.distributed`` world of one on one device.

    python -m krylov_tpu_torch.diagnostics.allreduce_cost [--device cuda|cpu] [--calls 2000]

The distributed ``Context`` makes one all-reduce a reduction (a 0-d or
small tensor): CG two an iteration.  In a world of one (NCCL on a card,
gloo on the CPU; a ``file://`` store in a temporary directory) this times,
on the host clock between device synchronisations and over ``--calls``
calls each: ``dist.all_reduce`` of a 0-d float64 tensor, the same through
``krylov_tpu_torch.context.all_reduce``, and a one-launch torch op as a
yardstick; then the CUDA time of the all-reduces (events), a CPU profile of
200 calls (the ten most expensive entries), and ms an iteration of a CG
solve of ``laplace2d(--nx, constant=True)`` sharded against eager (paired:
eager, sharded, sharded, eager), and a profile (CPU and, on a card, CUDA)
of 200 CG iterations at tol 0 each way: the host entries with the most
self time an iteration, and the device's busy time an iteration.  With ``--env-variants`` it first reruns
itself under each of ENV_VARIANTS, each a fresh process, so a setting read
when the process group starts takes effect.  One JSON line a run, after the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

# settings of torch.distributed that a collective call reads; each run
# names the one it sets
ENV_VARIANTS = (
    {},
    {"TORCH_FR_BUFFER_SIZE": "0", "TORCH_NCCL_TRACE_BUFFER_SIZE": "0"},
    {"TORCH_NCCL_ENABLE_MONITORING": "0", "TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"},
    {"TORCH_NCCL_AVOID_RECORD_STREAMS": "1"},
)


def _host_us(fn, calls: int, sync) -> float:
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def _profile_cg(A, b, sync, cuda: bool, **kw) -> dict:
    """200 CG iterations at tol 0 under torch.profiler: the twelve host
    entries with the most self CPU time and, on a card, the kernels' total
    time, each in µs an iteration."""
    import krylov_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    iters = 200
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    krylov_tpu_torch.solve(A, b, method="cg", tol=0.0, maxiter=iters, **kw)
    sync()
    with profile(activities=activities) as prof:
        krylov_tpu_torch.solve(A, b, method="cg", tol=0.0, maxiter=iters, **kw)
        sync()
    events = prof.key_averages()
    rows = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    out = {"host_self_us_an_iteration": {e.key: round(e.self_cpu_time_total / iters, 3) for e in rows}}
    if cuda:
        out["device_busy_us_an_iteration"] = round(sum(e.self_device_time_total for e in events) / iters, 3)
    return out


def measure(device_type: str, calls: int, nx: int) -> dict:
    import krylov_tpu_torch
    from krylov_tpu_torch.context import all_reduce
    from krylov_tpu_torch.dist import make_mesh
    from krylov_tpu_torch.sparse import fixtures

    cuda = device_type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    krylov_tpu_torch.set_default_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        kw = {"device_id": dev} if cuda else {}
        if cuda:
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, **kw)
        try:
            mesh = make_mesh(device_type)
            group = mesh.get_group()
            t = torch.ones((), dtype=torch.float64, device=dev)
            out = {
                "torch": torch.__version__,
                "dist.all_reduce_us": _host_us(lambda: dist.all_reduce(t, group=group), calls, sync),
                "context.all_reduce_us": _host_us(lambda: all_reduce(t, group), calls, sync),
                "one_launch_us": _host_us(lambda: t.add_(0.0), calls, sync),
            }
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                sync()
                start.record()
                for _ in range(calls):
                    dist.all_reduce(t, group=group)
                end.record()
                end.synchronize()
                out["all_reduce_cuda_event_us"] = start.elapsed_time(end) / calls * 1e3
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for _ in range(200):
                    dist.all_reduce(t, group=group)
                sync()
            rows = sorted(prof.key_averages(), key=lambda e: e.cpu_time_total, reverse=True)[:10]
            out["cpu_profile_us_a_call"] = {e.key: round(e.cpu_time_total / 200, 3) for e in rows}

            A = fixtures.laplace2d(nx, constant=True)
            b = np.random.default_rng(0).standard_normal(A.shape[0])
            solve = dict(method="cg", tol=1e-5, maxiter=3000)
            krylov_tpu_torch.solve(A, b, mesh=mesh, **solve)  # warm-up: the K1 build, the first calls
            ms = {"eager": [], "sharded": []}
            for route in ("eager", "sharded", "sharded", "eager"):
                _, info = krylov_tpu_torch.solve(A, b, **solve, **({"mesh": mesh} if route == "sharded"
                                                                   else {"fused": False}))
                ms[route].append(info["time"] * 1e3 / info["iterations"])
            out["cg_ms_an_iteration"] = ms
            out["cg_iterations"] = info["iterations"]
            out["cg_profile_eager"] = _profile_cg(A, b, sync, cuda, fused=False)
            out["cg_profile_sharded"] = _profile_cg(A, b, sync, cuda, mesh=mesh)
        finally:
            dist.destroy_process_group()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--nx", type=int, default=500)
    ap.add_argument("--env-variants", action="store_true")
    args = ap.parse_args()
    if args.env_variants:
        if args.device == "cuda":
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        for env in ENV_VARIANTS:
            cmd = [sys.executable, "-m", "krylov_tpu_torch.diagnostics.allreduce_cost", "--device", args.device,
                   "--calls", str(args.calls), "--nx", str(args.nx)]
            proc = subprocess.run(cmd, env={**os.environ, **env}, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"the run with {env} failed:\n{proc.stderr[-4000:]}")
            record = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"env": env, **record}), flush=True)
        return
    print(json.dumps(measure(args.device, args.calls, args.nx)), flush=True)


if __name__ == "__main__":
    main()
