"""Time per solve of the fused kernels K2/K3/K5/K6 against the size and the
route of their cooperative grid, and the latency of one grid sync, on one
CUDA card.

    python -m krylov_tpu_torch.diagnostics.grid_sweep [--blocks 66,132,264,396,528,0]
                                                     [--resident 66,100,132,0]
                                                     [--k 1,2,4,8] [--nx 500]

The system is the 2-D 5-point Laplacian (constant-weight stencil) with
``nx * nx`` points in float64, ``b`` from ``default_rng(1)``, tol 1e-5 and
maxiter 3000.  K2/K3, then K5/K6 at each k of ``--k`` (an empty list skips
them), run on the streaming route at each ``--blocks`` cap and on the
resident route at each ``--resident`` cap (``kernels.fused.ROUTE`` and
``MAX_BLOCKS``; 0: the plan's grid).  A cap above what fits changes
nothing.  Each time is the median of 3 solves between CUDA events.  Last,
a cooperative grid that only syncs gives the time of one grid sync:
(time of 2000 syncs - time of 200) / 1800, median of 3, at each grid,
block size and kind of sync of ``SYNC_GRIDS`` (the scratch's zeroing launch
is in both times and cancels); and one that only runs a piece of the
resident K5/K6's outer iteration gives its time the same way, at each
case of ``KSKIP_PIECES`` on the ``--nx`` grid.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from krylov_tpu_torch.kernels import _build, fused, fused_kskip
from krylov_tpu_torch.sparse import fixtures

# (blocks, threads, mode) of the sync probe: cooperative groups'
# grid.sync() (mode 0) on the resident grid at 512 and 256 threads and on
# the streaming grid; the resident kernels' grid_allsum (mode 1) on the
# resident grid and half of it
SYNC_GRIDS = ((132, 512, 0), (132, 256, 0), (528, 256, 0), (132, 512, 1), (66, 512, 1))
SYNC_MODES = ("grid.sync()", "grid_allsum")
# (mode, bands, count) of the K5/K6 probe: the neighbour exchange (mode 0)
# of one vector (a step's p or r) and of two (a stream stage's pair), and
# the bundle sum (mode 1) of 6 k + 6 entries at k = 4 and 8, at the
# resident grid and half of it
KSKIP_PIECES = ((0, 132, 1), (0, 132, 2), (0, 66, 2), (1, 132, 30), (1, 132, 54), (1, 66, 30))
KSKIP_MODES = ("neighbour exchange of {} vector(s)", "bundle sum of {} entries")


def median_ms(fn):
    """Median of 3 calls of ``fn`` between CUDA events, in ms, and what the
    last call returned."""
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def probe_us(launch) -> float:
    """Microseconds of one repetition of a probe kernel: ``launch(reps)``
    launches it with ``reps`` repetitions (and zeroes its scratch)."""
    launch(10)  # warm-up
    return (median_ms(lambda: launch(2000))[0] - median_ms(lambda: launch(200))[0]) / 1800 * 1e3


def sync_us(blocks: int, threads: int, mode: int) -> float:
    """Microseconds of one grid sync of ``blocks`` blocks of ``threads``
    (``mode``: an index of ``SYNC_MODES``)."""
    lib = _build.library()

    def launch(reps):
        partials = torch.zeros(2 * (6 * blocks + 6), dtype=torch.int64, device="cuda")  # 16-byte words
        _build.check(lib.krylov_sync_probe(blocks, threads, reps, mode, partials.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream), "krylov_sync_probe")

    return probe_us(launch)


def kskip_piece_us(mode: int, blocks: int, count: int, nx: int) -> float:
    """Microseconds of one piece of the resident K5/K6's outer iteration
    on ``blocks`` bands of the nx x nx grid (``mode``: an index of
    ``KSKIP_MODES``; ``count`` vectors or bundle entries)."""
    lib = _build.library()

    def launch(reps):
        xbuf = torch.zeros(2 * blocks * 8 * nx, dtype=torch.int64, device="cuda")  # 16-byte words
        partials = torch.zeros(2 * 2 * count * (blocks + 1), dtype=torch.int64, device="cuda")
        _build.check(lib.krylov_kskip_probe(mode, blocks, nx, nx, 1, count, reps, xbuf.data_ptr(),
                                            partials.data_ptr(), torch.cuda.current_stream().cuda_stream),
                     "krylov_kskip_probe")

    return probe_us(launch)


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default="66,132,264,396,528,0")
    ap.add_argument("--resident", default="66,100,132,0")
    ap.add_argument("--k", default="1,2,4,8")
    ap.add_argument("--nx", type=int, default=500)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    n = args.nx * args.nx
    A = fixtures.laplace2d(args.nx, constant=True, device="cuda")
    coef2, st2, g2, sub = A.collapse_to_2d()
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).cuda()
    b_norm = torch.linalg.vector_norm(b)
    kw = dict(stencil=st2, grid=g2, maxiter=3000, sub=sub)
    fused2 = (("mrr", fused.fused_mrr_solve_2d), ("cg", fused.fused_cg_solve_2d))
    for route, caps in (("streaming", _ints(args.blocks)), ("resident", _ints(args.resident))):
        fused.ROUTE = route
        for cap in caps:
            fused.MAX_BLOCKS = cap
            for m, fn in fused2:
                p = fused.device_plan(m, g2, st2, torch.float64)
                blocks = p.blocks if route == "resident" else fused.workspace(m, torch.float64, n, p.blocks)[0]
                t, (_, _, iters, _) = median_ms(lambda: fn(coef2, b, 1e-5, b_norm, **kw))
                shape = f"{p.rows} rows a band, {p.ppt} points a thread" if route == "resident" else "256 threads"
                print(f"K{'2' if m == 'mrr' else '3'} {m} {route} blocks {blocks} ({shape}): {t:.3f} ms, "
                      f"{int(iters)} iters, {t / int(iters) * 1e3:.3f} us/iter", flush=True)
    kskip = (("kskipcg", fused_kskip.fused_kskipcg_solve_2d), ("kskipmrr", fused_kskip.fused_kskipmrr_solve_2d))

    def kskip_line(m, fn, k, where):
        t, out = median_ms(lambda: fn(coef2, b, 1e-5, b_norm, k, k_max=k, **kw))
        iters, outer = (out[3], out[5]) if m == "kskipcg" else (out[4], out[6])
        print(f"{'K6' if m == 'kskipcg' else 'K5'} {m} k={k} {where}: {t:.3f} ms, "
              f"{int(iters)} iters, {int(outer)} outer, {t / int(outer) * 1e3:.3f} us/outer", flush=True)

    for route, caps in (("streaming", _ints(args.blocks)), ("resident", _ints(args.resident))):
        fused.ROUTE = route
        for cap in caps if args.k else ():
            fused.MAX_BLOCKS = cap
            for k in _ints(args.k):
                for m, fn in kskip:
                    p = fused_kskip.device_plan(m, g2, st2, torch.float64, k)
                    shape = f" ({p.rows} rows a band, {p.ppt} points a thread)" if route == "resident" else ""
                    kskip_line(m, fn, k, f"{route} blocks {p.blocks}{shape}")
    fused.ROUTE, fused.MAX_BLOCKS = None, 0
    for blocks, threads, mode in SYNC_GRIDS:
        print(f"grid sync ({SYNC_MODES[mode]}), {blocks} blocks of {threads} threads: "
              f"{sync_us(blocks, threads, mode):.3f} us (cooperative kernel that only syncs)", flush=True)
    for mode, blocks, count in KSKIP_PIECES:
        print(f"K5/K6 {KSKIP_MODES[mode].format(count)}, {blocks} bands of the {args.nx} x {args.nx} grid: "
              f"{kskip_piece_us(mode, blocks, count, args.nx):.3f} us (cooperative kernel that only does that)",
              flush=True)


if __name__ == "__main__":
    main()
