"""One run of one cell: set-up, a warm-up request, with ``--trace 1`` a
short profiled stretch, the measured window, the check against the plain
reference, and the contract's result line.

Everything that belongs to one cell is found by name: the workload entry
of ``BENCHMARK.json`` names its configuration (``configs[].file``) and its
traffic mix (``perfbench/traffic/<traffic>.json``); its check is
``perfbench/checks/<workload>.json``; each metric is read by
``perfbench/metrics/<metric>.py``.  The program under test is
``krylov_tpu_torch``; nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from perfbench import check, rhs, trace as tracing
from perfbench.reference import stencil

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "krylov_tpu")
HOST_SECONDS = 330.0  # a run exits within 360 s; the world's ranks get what is left of this


class NoResult(Exception):
    """The run must exit without a result line (no card, a forbidden
    module)."""


def forbidden_modules(names) -> list:
    """The top-level names among ``names`` (module names, compared whole up
    to the first dot) that the harness's process may not hold."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    checks: dict
    spec: dict
    root: str

    def metric_entries(self, traced: bool) -> list:
        """The metrics this cell reports: its end-to-end metrics, or with
        ``traced`` its per-layer ones (those listing it, or listing no
        cells and moving an end-to-end metric it reports)."""
        e2e = [m for m in self.spec["end_to_end"] if self.workload in m.get("workloads", [self.workload])]
        if not traced:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if self.workload in m.get("workloads", [self.workload] if m["moves"] in mine else [])]


def load_cell(workload: str, root=ROOT) -> Cell:
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])
    data = root / "perfbench"
    return Cell(
        workload=workload, config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((data / "traffic" / f"{entry['traffic']}.json").read_text()),
        checks=json.loads((data / "checks" / f"{workload}.json").read_text()), spec=spec, root=str(root),
    )


def metric_module(root, name: str):
    """The reader ``perfbench/metrics/<name>.py`` (names may hold dots)."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_counters(counters: dict) -> dict:
    """The program's counters, ``{name: "module:attr.path"}``, read now."""
    out = {}
    for name, where in counters.items():
        mod, attr = where.split(":")
        value = importlib.import_module(mod)
        for part in attr.split("."):
            value = getattr(value, part)
        out[name] = value
    return out


class Client:
    """The closed-loop client of one process: the system made through the
    program's fixture on ``device``, the entry point with the traffic's
    arguments, and the right-hand sides drawn on the device from the seed."""

    def __init__(self, cell: Cell, device: torch.device, seed: int, *, test: bool = False, dtype=None, mesh=None):
        import krylov_tpu_torch
        from krylov_tpu_torch.sparse import fixtures

        cfg, tr = cell.config, cell.traffic
        args = dict(cfg["test_args"] if test else cfg["system"]["args"])
        self.dtype = getattr(torch, dtype or cfg["dtype"])
        self.A = getattr(fixtures, cfg["system"]["fixture"])(**args, dtype=self.dtype, device=device)
        self.grid = stencil.grid_of(cfg["system"]["fixture"], args)
        self.n = math.prod(self.grid)
        kw = dict(tr["kwargs"], tol=cfg["tol"], maxiter=cfg["maxiter"])
        pre = tr.get("precond")
        if pre:
            from krylov_tpu_torch.precond import chebyshev

            lmin, lmax = stencil.spectral_bounds(self.grid)
            kw["M"] = chebyshev(self.A, pre["degree"], lmin, lmax)
        if tr.get("mesh"):
            kw["mesh"] = mesh
        self.kwargs = kw
        self.device = device
        self.rhs = rhs.Generator(self.n, seed, device)
        self.solve = krylov_tpu_torch.solve_device

    def request(self, b: torch.Tensor):
        """One request: the call, then the host read of its iteration count
        that ends it.  Returns ``(result, iterations, seconds)``."""
        from torch.profiler import record_function

        b = b if self.dtype == torch.float64 else b.to(self.dtype)
        with record_function(tracing.REQUEST):
            t0 = time.perf_counter()
            res = self.solve(self.A, b, **self.kwargs)
            with record_function(tracing.HOST_READ):
                iterations = int(res.iterations)
            seconds = time.perf_counter() - t0
        return res, iterations, seconds


class Sample:
    """The requests kept for the check: a uniform sample of ``k`` drawn
    from the seed (reservoir sampling, so every request of the window is
    equally likely whatever their number), and the request with the most
    iterations."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([seed % 2**64, 1])
        self.slots, self.longest = [], None

    def offer(self, i: int, b, x, iterations: int) -> None:
        item = (i, b, x, iterations)
        if len(self.slots) < self.k:
            self.slots.append(item)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.slots[j] = item
        if self.longest is None or iterations > self.longest[3]:
            self.longest = item

    def items(self) -> list:
        kept = {item[0]: item for item in self.slots}
        if self.longest is not None:
            kept.setdefault(self.longest[0], self.longest)
        return [kept[i] for i in sorted(kept)]


def run_requests(client: Client, stop, keep=None, draw=None):
    """Requests one after another until ``stop(count, elapsed)``; returns
    ``(elapsed, latencies, iterations, converged flags)``.  ``keep(i, b, x,
    iterations)`` sees each request's answer; ``draw()`` gives each ``b``
    (by default the client's generator: one kernel, queued ahead of the
    request, no wait)."""
    draw = client.rhs if draw is None else draw
    lat, its, conv = [], [], []
    t0 = time.perf_counter()
    while True:
        b = draw()
        res, iterations, seconds = client.request(b)
        lat.append(seconds)
        its.append(iterations)
        conv.append(res.converged)
        if keep is not None:
            keep(len(its) - 1, b, res.x, iterations)
        if stop(len(its), time.perf_counter() - t0):
            return time.perf_counter() - t0, lat, its, conv


def _counter_specs(cell: Cell, traced: bool) -> dict:
    specs = {}
    for m in cell.metric_entries(traced):
        specs.update(getattr(metric_module(cell.root, m["name"]), "COUNTERS", {}))
    return specs


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def gather_whole(x: torch.Tensor, n: int, world: int) -> torch.Tensor:
    """The whole ``x`` from every rank's rows (one all-gather; off a mesh
    ``x`` itself)."""
    if world == 1:
        return x
    import torch.distributed as dist

    whole = x.new_empty(n)
    dist.all_gather_into_tensor(whole, x.contiguous())
    return whole


def run_client(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device, *, test: bool,
               mesh=None, rank: int = 0, world: int = 1, fault=None) -> dict:
    """One process's part of a run (the only one off a mesh).  Returns its
    report: on rank 0 everything the result line needs.  ``fault()``, when
    given, breaks the program in this process first (the tests' seam)."""
    import torch.distributed as dist

    if fault is not None:
        fault()
    on_card = device.type == "cuda"
    client = Client(cell, device, seed, test=test, mesh=mesh)
    client.request(client.rhs())  # warm-up: the cell's own shapes, one request
    if on_card:
        # the memory the check will keep (b whole, x a rank's rows, in
        # float64), held once by the caching allocator so that keeping it
        # calls no cudaMalloc inside the stretch or the window
        kept = cell.checks["sample"] + 1 + (cell.traffic["trace_requests"] if traced else 0)
        torch.empty(kept * (client.n + client.n // world) * 8, dtype=torch.uint8, device=device)
        torch.cuda.synchronize(device)
    if world > 1:
        dist.barrier()
    setup_end = time.time()
    specs = _counter_specs(cell, traced)

    stretch = None
    if traced:
        kept = []
        # the stretch's b drawn before it: every kernel in it is the program's
        bs = iter([client.rhs() for _ in range(cell.traffic["trace_requests"])])
        before = read_counters(specs)
        out, tr = tracing.profiled(
            lambda: run_requests(client, lambda i, _: i >= cell.traffic["trace_requests"],
                                 lambda i, b, x, it: kept.append((i, b, x, it)), bs.__next__), device)
        stretch = {"trace": tr, "requests": len(out[2]), "counters": _delta(read_counters(specs), before),
                   "kept": kept}

    def stop(count, elapsed):
        done = elapsed >= seconds
        if world == 1:
            return done
        flag = torch.tensor([int(done)], device=device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    sample = Sample(cell.checks["sample"], seed)
    before = read_counters(specs)
    window_s, lat, its, conv = run_requests(client, stop, sample.offer)
    counters = _delta(read_counters(specs), before)
    failed = int((~torch.stack(conv).reshape(-1)).sum())
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules(sys.modules)
    grid, n = client.grid, client.n
    del client, conv  # the program's state; the sampled answers stay
    if on_card:
        torch.cuda.empty_cache()

    to_check = sample.items() + (stretch["kept"] if stretch else [])
    rows = []
    for _, b, x, it in to_check:
        x = gather_whole(x, n, world)
        if rank == 0:
            rows.append(check.numbers(cell.config, cell.traffic, grid, b, x, it))
    report = {"rank": rank, "memory_peak_bytes": peak, "forbidden": found,
              "busy_s": stretch["trace"].busy_s if stretch and stretch["trace"] else None}
    if rank == 0:
        n_sample = len(to_check) - (len(stretch["kept"]) if stretch else 0)
        report.update(
            setup_end=setup_end, window_s=window_s, latencies_s=lat, iterations=its, failed=failed,
            counters=counters, checked=rows, grid=list(grid), n=n,
            stretch=None if stretch is None else {
                "trace": stretch["trace"], "requests": stretch["requests"], "counters": stretch["counters"],
                "ref_iterations": [r["ref_iterations"] for r in rows[n_sample:]],
            },
        )
    if world > 1:
        dist.barrier()
    return report


def _rank_job(mesh, rank, device, cell_fields, seed, seconds, traced, test, fault, out_dir):
    import pickle

    cell = Cell(**cell_fields)
    report = run_client(cell, seed, seconds, traced, device, test=test, mesh=mesh, rank=rank,
                        world=cell.config["ranks"], fault=fault)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)


def _device_facts(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu"}
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        facts["power_limit"] = smi.stdout.strip().splitlines()[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        facts["power_limit"] = "not read"
    return facts


def pin_to_one_core() -> None:
    """Run this process, and every thread it starts from now on, on the last
    core it may use: a one-card cell's runs then spread less between
    processes on a shared host (p2d-mrr-1rhs on an H100 host: 1.35% between
    quartiles of ``solve_ms`` pinned, 2.10% not)."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def run(workload: str, seed: int, seconds: float, traced: bool, *, device_type: str = "cuda", test: bool = False,
        root=ROOT, t_setup0_wall: float | None = None, fault=None) -> dict:
    """One run of ``workload``; returns the result line's object (with the
    check's numbers last).  ``device_type="cpu"`` with ``test=True`` runs
    the configuration's ``test_args`` through the program's plain versions
    on the CPU; ``fault`` (a module-level function) breaks the program in
    every process of the run, for the tests that see ``correct`` false."""
    import pickle

    t_setup0_wall = time.time() if t_setup0_wall is None else t_setup0_wall
    cell = load_cell(workload, root)
    ranks = cell.config["ranks"]
    if device_type == "cuda":
        if ranks == 1:  # before CUDA starts its threads, so that they inherit the core
            pin_to_one_core()
        if not torch.cuda.is_available() or torch.cuda.device_count() < ranks:
            raise NoResult(f"{workload} needs {ranks} CUDA device(s); torch sees "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if ranks == 1:
        reports = [run_client(cell, seed, seconds, traced, device, test=test, fault=fault)]
    else:
        from perfbench import world

        if device_type == "cuda":  # build the kernels once, before the ranks load them
            from krylov_tpu_torch.kernels import _build

            _build.library()
        with tempfile.TemporaryDirectory() as out_dir:
            left = HOST_SECONDS - (time.time() - t_setup0_wall)
            world.run_world(_rank_job, ranks, device_type,
                            args=(dataclasses.asdict(cell), seed, seconds, traced, test, fault, out_dir),
                            timeout=left)
            reports = []
            for r in range(ranks):
                with open(Path(out_dir) / f"rank{r}.pkl", "rb") as f:
                    reports.append(pickle.load(f))
    found = sorted({m for rep in reports for m in rep["forbidden"]} | set(forbidden_modules(sys.modules)))
    if found:
        raise NoResult(f"forbidden modules loaded once the window closed: {', '.join(found)}")
    return _result(cell, reports, traced, device, t_setup0_wall)


def _result(cell: Cell, reports: list, traced: bool, device: torch.device, t_setup0_wall: float) -> dict:
    r0 = reports[0]
    stretch = r0["stretch"]
    ok, checks = check.judge(r0["checked"], cell.checks["limits"], cell.config["tol"])
    run = types.SimpleNamespace(
        setup_s=r0["setup_end"] - t_setup0_wall,
        window_s=r0["window_s"], latencies_s=r0["latencies_s"], iterations=r0["iterations"],
        requests=len(r0["iterations"]), rhs_per_request=1, counters=r0["counters"],
        trace=stretch["trace"] if stretch else None,
        stretch_requests=stretch["requests"] if stretch else 0,
        stretch_counters=stretch["counters"] if stretch else {},
        stretch_ref_iterations=stretch["ref_iterations"] if stretch else [],
        config=cell.config, traffic=cell.traffic, grid=tuple(r0["grid"]), n=r0["n"],
        ranks=cell.config["ranks"],
    )
    metrics = {}
    for m in cell.metric_entries(traced):
        value = metric_module(cell.root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = _device_facts(device)
    dev["count"] = len(reports) if device.type == "cuda" else 0
    dev["memory_peak_bytes"] = max(rep["memory_peak_bytes"] for rep in reports)
    line = {"correct": ok and r0["failed"] == 0, "attempted": run.requests, "failed": r0["failed"],
            "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        busy = [rep["busy_s"] for rep in reports if rep["busy_s"] is not None]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    line["checks"] = dict(checks, failed_requests={"value": r0["failed"], "limit": 0})
    return line
