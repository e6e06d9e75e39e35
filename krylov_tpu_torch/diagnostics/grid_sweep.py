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
case of ``KSKIP_PIECES`` on the ``--nx`` grid.  Last, K4 alone: the
resident stencil pass on the resident plan of the ``--nx`` grid
(:func:`krylov_tpu_torch.kernels.fused.stencil_pass_probe`), a
``__syncthreads`` after each pass, timed the same way in float64 and
float32, the masked pass (NS = 0) beside the specialised one, in its
predicated form and its split form (2 points at a time, as K6 takes it in
float32), on the same mirror, with the bands' clock cycles a pass
(slowest and median band), the SM clock that ``nvidia-smi`` reads while the probe runs, and the bound at
that clock: the shared-memory bytes of the largest band's loads (NS a
point) at 128 bytes a clock.  ``--blocks "" --resident "" --k ""`` skips
the solves.

    python -m krylov_tpu_torch.diagnostics.grid_sweep --stream 216,100 [--k 8]

times, instead, the pieces of the streaming K5's outer iteration on
``laplace3d(nx, constant=True)`` for each nx, in float64 and float32, at
each k of ``--k`` (:func:`krylov_tpu_torch.kernels.fused_kskip.sweep_probe`
on the streaming grid): the k + 1 stream stages with the bundle
reduction, the k + 1 steps with the A r pass, the 2k + 3 grid syncs alone,
the bundle reduction alone and one stencil pass, each with the masked pass
(NS = 0, the grid-stride form) and the pass of the stencil (NS = 7); a
piece's time is (time of 12 repetitions - time of 2) / 10, median of 3
(syncs and bundle: 2000 and 200), beside the bytes its sweeps move (every
vector read or written once a sweep, neighbours as cache hits), their rate
and its share of 3.35 TB/s, and the SM clock that ``nvidia-smi`` reads
after it.

    python -m krylov_tpu_torch.diagnostics.grid_sweep --k23 laplace2d:1500,laplace3d:216 [--per-sm 1,2,3,4]

times, instead, the streaming K2/K3 (``kernels.fused.ROUTE =
"streaming"``) on each constant-weight system named (``laplace2d:1500``, N
= 2.25M, the 5-point pass; ``laplace3d:216``, BASELINE row 5, N = 10.08M,
the 7-point pass), in float64 and float32: each method in the form and on
the walk its instance is built in (``kernels.fused.STREAM_SHIPPED``) at
each number of blocks an SM of ``--per-sm``
(``kernels.fused.STREAM_BLOCKS_PER_SM``; the kernels' occupancy caps it),
300 iterations with tol 0 (``b`` from ``default_rng(1)``), median of 3
between CUDA events, beside the bytes model of the form
(:func:`krylov_tpu_torch.kernels.fused.stream_words`), its rate and its
share of 3.35 TB/s; then each pass of the probe alone at the plan's grid
(:func:`krylov_tpu_torch.kernels.fused.stream_probe`: (time of 12 passes -
time of 2) / 10, median of 3, each with its grid sum) beside its words a
point (``kernels.fused.PASS_WORDS``), with the SM clock that ``nvidia-smi``
reads after it.
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


SMEM_BYTES_PER_CLOCK = 128  # shared-memory bandwidth of an H100 SM


def k4_line(A, dtype, nx: int) -> None:
    """Prints K4's µs a pass on A's resident plan, masked (NS = 0) and
    specialised, with the band clocks, the SM clock under load and the
    bound."""
    coef2, st2, g2, sub = A.collapse_to_2d()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(g2[0] * g2[1])).to("cuda", dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bands, rows, ppt, _ = fused.resident_bands(g2, st2, sms, fused.MAX_BLOCKS)
    kw = dict(stencil=st2, grid=g2, sub=sub)
    ns5 = fused.pass_terms(st2, coef2.ndim == 1)
    for ns, split in ((0, False), (ns5, False), (ns5, True)):
        def launch(reps):
            fused.stencil_pass_probe(coef2, x, ns_pass=ns, split=split, reps=reps, **kw)

        us = probe_us(launch)
        _, _, cycles = fused.stencil_pass_probe(coef2, x, ns_pass=ns, split=split, reps=200_000, **kw)  # ~0.5 s
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True, check=True).stdout.split()[0])
        per_pass = cycles.double() / 200_000
        terms = len(st2)
        bound_clocks = rows * g2[1] * terms * dtype.itemsize / SMEM_BYTES_PER_CLOCK
        form = "masked" if ns == 0 else "split" if split else "predicated"
        print(f"K4 resident pass NS={ns} ({form}) {str(dtype).removeprefix('torch.')}, {bands} bands of <= {rows} "
              f"rows of the "
              f"{nx} grid, {ppt} points a thread: {us:.3f} us a pass (probe, a __syncthreads after each pass); "
              f"band clocks a pass max {float(per_pass.max()):.1f}, median {float(per_pass.median()):.1f} "
              f"(band {int(per_pass.argmax())} slowest); SM clock {mhz:.0f} MHz under the probe; bound "
              f"{bound_clocks:.0f} clocks = {bound_clocks / mhz:.3f} us (shared-memory bytes of the largest band, "
              f"{terms} loads a point at {SMEM_BYTES_PER_CLOCK} B a clock)", flush=True)


# words a point each streaming probe mode moves at k (fused_kskip.sweep_probe):
# k stages of 3 reads and 2 writes and a last of 3 reads; k + 1 steps of 4
# reads and 4 writes, step 0 also reading A r and writing pre_x, and the
# A r pass (1 read, 1 write); the pass alone 1 read and 1 write
STREAM_WORDS = {"stream": lambda k: 5 * k + 3, "steps": lambda k: 8 * (k + 1) + 2 + 2, "pass": lambda k: 2}
PEAK_BYTES = 3.35e12  # HBM3 of an H100 SXM (NVIDIA's data sheet)


def stream_lines(nx: int, ks) -> None:
    """Prints the streaming K5's pieces on laplace3d(nx, constant=True)."""
    for dtype in (torch.float64, torch.float32):
        A = fixtures.laplace3d(nx, dtype=dtype, constant=True, device="cuda")
        coef2, st2, g2, sub = A.collapse_to_2d()
        n = g2[0] * g2[1]
        v = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to("cuda", dtype)
        kw = dict(stencil=st2, grid=g2, sub=sub)
        for k in ks:
            for ns in (0, fused.pass_terms(st2, True)):
                blocks = min(fused_kskip.workspace(m, dtype, n, k, ns)[0] for m in ("probe", "kskipmrr"))
                for mode in fused_kskip.SWEEP_MODES:
                    few, many = (200, 2000) if mode in ("syncs", "bundle") else (2, 12)

                    def launch(reps):
                        fused_kskip.sweep_probe(coef2, v, mode, k, ns_pass=ns, reps=reps, **kw)

                    launch(1)  # warm-up
                    us = (median_ms(lambda: launch(many))[0] - median_ms(lambda: launch(few))[0]) / (many - few) * 1e3
                    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                         capture_output=True, text=True, check=True).stdout.strip()
                    line = (f"K5 streaming {mode} laplace3d({nx}) N={n} {str(dtype).removeprefix('torch.')} k={k} "
                            f"NS={ns}, {blocks} blocks of 256: {us:.3f} us")
                    if mode in STREAM_WORDS:
                        nbytes = STREAM_WORDS[mode](k) * n * dtype.itemsize
                        line += (f"; {nbytes / 1e6:.1f} MB, {nbytes / (us * 1e-6) / 1e9:.1f} GB/s, "
                                 f"{nbytes / PEAK_BYTES / (us * 1e-6):.3f} of 3.35 TB/s")
                    print(line + f"; SM clock {mhz} MHz after it", flush=True)
        del A, v
        torch.cuda.empty_cache()


K23_ITERS = 300  # iterations of a timed streaming K2/K3 solve (tol 0)


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.strip()


def k23_lines(spec: str, per_sm) -> None:
    """Prints the streaming K2/K3's solves at each grid size and their
    passes on each ``system:nx`` of ``spec``."""
    saved = (fused.ROUTE, fused.STREAM_BLOCKS_PER_SM)
    fused.ROUTE = "streaming"
    try:
        for item in spec.split(","):
            system, nx = item.split(":")
            for dtype in (torch.float64, torch.float32):
                name = str(dtype).removeprefix("torch.")
                A = getattr(fixtures, system)(int(nx), dtype=dtype, constant=True, device="cuda")
                coef2, st2, g2, sub = A.collapse_to_2d()
                n = g2[0] * g2[1]
                ns = fused.pass_terms(st2, True)
                b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to("cuda", dtype)
                b_norm = torch.linalg.vector_norm(b)
                kw = dict(stencil=st2, grid=g2, maxiter=K23_ITERS, sub=sub)
                where = f"{system}({nx}) N={n} {name} NS={ns}"
                for m in ("cg", "mrr"):
                    fn = getattr(fused, f"fused_{m}_solve_2d")
                    form, walk = fused.stream_shape(m, ns, dtype)
                    for k in per_sm:
                        fused.STREAM_BLOCKS_PER_SM = k
                        blocks = fused.workspace(m, dtype, n, fused.device_plan(m, g2, st2, dtype).blocks, ns)[0]
                        fn(coef2, b, 0.0, b_norm, **kw)  # warm-up
                        t, out = median_ms(lambda: fn(coef2, b, 0.0, b_norm, **kw))
                        nbytes = fused.stream_words(m, form) * n * dtype.itemsize * int(out[2])
                        print(f"K{'3' if m == 'cg' else '2'} streaming {m} {form} {walk} {where}, {k} blocks an SM "
                              f"({blocks} of 256): {t:.3f} ms for {int(out[2])} iterations, "
                              f"{t / int(out[2]) * 1e3:.2f} us an iteration; model "
                              f"{fused.stream_words(m, form)} words a point, {nbytes / (t * 1e-3) / 1e9:.1f} GB/s, "
                              f"{nbytes / PEAK_BYTES / (t * 1e-3):.3f} of 3.35 TB/s; SM clock {sm_clock()} MHz "
                              f"after it", flush=True)
                    fused.STREAM_BLOCKS_PER_SM = saved[1]
                    for pass_name in fused.PROBE_PASSES[m]:
                        def launch(reps):
                            fused.stream_probe(coef2, b, m, pass_name, ns_pass=ns, reps=reps, stencil=st2, grid=g2,
                                               sub=sub)

                        launch(1)  # warm-up
                        us = (median_ms(lambda: launch(12))[0] - median_ms(lambda: launch(2))[0]) / 10 * 1e3
                        nbytes = fused.PASS_WORDS[m, pass_name] * n * dtype.itemsize
                        print(f"K{'3' if m == 'cg' else '2'} streaming pass {m} {pass_name} {where} on {walk} "
                              f"alone: {us:.3f} us; "
                              f"{fused.PASS_WORDS[m, pass_name]} words a point, {nbytes / 1e6:.1f} MB, "
                              f"{nbytes / (us * 1e-6) / 1e9:.1f} GB/s, {nbytes / PEAK_BYTES / (us * 1e-6):.3f} of "
                              f"3.35 TB/s; SM clock {sm_clock()} MHz after it", flush=True)
                del A, b
                torch.cuda.empty_cache()
    finally:
        fused.ROUTE, fused.STREAM_BLOCKS_PER_SM = saved


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default="66,132,264,396,528,0")
    ap.add_argument("--resident", default="66,100,132,0")
    ap.add_argument("--k", default="1,2,4,8")
    ap.add_argument("--nx", type=int, default=500)
    ap.add_argument("--stream", default="", help="laplace3d sizes whose streaming K5 pieces to time instead")
    ap.add_argument("--k23", default="", help="system:nx list whose streaming K2/K3 forms and passes to time instead")
    ap.add_argument("--per-sm", default="2,4", help="blocks an SM of the --k23 sweep")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.k23:
        k23_lines(args.k23, _ints(args.per_sm))
        return
    if args.stream:
        for nx in _ints(args.stream):
            stream_lines(nx, _ints(args.k))
        return
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
                blocks = (p.blocks if route == "resident" else
                          fused.workspace(m, torch.float64, n, p.blocks, fused.pass_terms(st2, coef2.ndim == 1))[0])
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
    for dtype in (torch.float64, torch.float32):
        k4_line(fixtures.laplace2d(args.nx, dtype=dtype, constant=True, device="cuda"), dtype, args.nx)


if __name__ == "__main__":
    main()
