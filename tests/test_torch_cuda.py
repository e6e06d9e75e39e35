"""krylov_tpu_torch CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine that has none:
``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the
``--noconftest`` skips tests/conftest.py, which sets JAX up).

Tolerances: the SpMV differs from the plain version only by fused
multiply-adds, rtol 1e-12 (f64) / 1e-5 (f32) against the largest entry.
The fused solves (either route of K2/K3) sum inner products in another
order (per-block partials): equal iteration counts, traces rtol 1e-9 (atol
1e-14), x rtol 1e-8 (atol 1e-12), in float64; float32 as ROUTE_TOLS
states.  The fused k-skip solves (either route of K5/K6) add the k-step
scalar recurrences, which amplify that rounding: equal iteration, outer,
nosl, ktrace and final_k values, traces rtol 1e-5, x rtol 1e-6 (atol
1e-9), the tolerances of tests/test_kernels.py for the same kernels, in
float64; float32 as F32_TOLS states.
"""

import numpy as np
import pytest
import torch

import krylov_tpu_torch
from krylov_tpu_torch import precond as pc
from krylov_tpu_torch import tracing
from krylov_tpu_torch.context import Context
from krylov_tpu_torch.kernels import fused, fused_kskip, stencil
from krylov_tpu_torch.sparse import StencilMatrix, convert, fixtures, to_device

OPERATORS = {
    "2d": lambda **kw: fixtures.laplace2d(24, **kw),
    "2d-const": lambda **kw: fixtures.laplace2d(24, constant=True, **kw),
    "3d-const": lambda **kw: fixtures.laplace3d(10, constant=True, **kw),
}
# float32 K5/K6 by k: whole solves at k <= 2 against the float32 plain
# version; at k = 4 the first outer iteration against the float64 plain
# version on the same values, as the float32 k = 4 recurrences keep no
# reproducible trajectory past it.  Limits about 10x above the streaming
# kernels' largest readings on an H100 in chip_smoke.py (trace relative, x
# relative to max |x|); both routes pass them here.
F32_TOLS = {1: (6.9e-4, 1.5e-5), 2: (4.3e-2, 1.4e-4), 4: (0.23, 0.23)}
KERNEL = {"cg": fused.fused_cg_solve_2d, "mrr": fused.fused_mrr_solve_2d}
PLAIN = {"cg": fused.fused_cg_solve_2d_reference, "mrr": fused.fused_mrr_solve_2d_reference}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its plain version")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw, reads", [
    # the b = 0 test and the launch's tol (a host number's copy to the card
    # synchronises the stream)
    (dict(method="mrr"), 2),
    # and restarts= tol and its decision; the defect's launch takes a device tol
    (dict(method="mrr", restarts=1), 4),
    (dict(method="adaptivekskipmrr", k=4), 2),
])
def test_front_door_host_reads_on_the_card(cuda, kw, reads):
    """The host reads (krylov_tpu_torch.tracing) of a fused solve on the card."""
    A = fixtures.laplace2d(24, constant=True, dtype=torch.float64, device=cuda)
    b = _rhs(A.shape[0], 3, cuda, torch.float64)
    krylov_tpu_torch.solve_device(A, b, tol=1e-8, **kw)  # K1's weights are read once an operator
    before = (tracing.totals.host_read.calls, tracing.totals.launch.calls)
    res = krylov_tpu_torch.solve_device(A, b, tol=1e-8, **kw)
    assert bool(res.converged)
    assert tracing.totals.host_read.calls - before[0] == reads
    assert tracing.totals.launch.calls - before[1] >= 1


def _rhs(n, seed, device, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(device, dtype)


def _launched(fn):
    """The launch counts of the fused wrapper ``fn``: ``tracing.totals.<its name>``."""
    return getattr(tracing.totals, fn.__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_stencil_kernel_matches_plain(cuda, name, dtype, rtol):
    A = OPERATORS[name](dtype=dtype, device=cuda)
    x = _rhs(A.shape[0], 5, cuda, dtype)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    before = tracing.totals.stencil_matvec_2d.launches
    y = stencil.stencil_matvec_2d(coef2, x, stencil=stencil2, grid=grid2, sub=sub)
    assert tracing.totals.stencil_matvec_2d.launches == before + 1
    y_ref = stencil.stencil_matvec_2d_reference(coef2, x, stencil=stencil2, grid=grid2, sub=sub)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=rtol * float(y_ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPERATORS))
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_kernel_matches_plain(cuda, method, name):
    A = OPERATORS[name](device=cuda)
    b = _rhs(A.shape[0], 6, cuda)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    kw = dict(stencil=stencil2, grid=grid2, maxiter=A.shape[0], sub=sub)
    b_norm = torch.linalg.vector_norm(b)
    before = _launched(KERNEL[method]).launches
    x, t, i, c = KERNEL[method](coef2, b, 1e-8, b_norm, **kw)
    assert _launched(KERNEL[method]).launches == before + 1
    xr, tr, ir, cr = PLAIN[method](coef2, b, 1e-8, b_norm, **kw)
    assert int(i) == int(ir) and bool(c) and bool(cr)
    m = int(i) + 1
    torch.testing.assert_close(t[:m], tr[:m], rtol=1e-9, atol=1e-14)
    torch.testing.assert_close(x, xr, rtol=1e-8, atol=1e-12)


# n-vectors of work of each streaming form (csrc/fused.cu), and of the pass
# probe
STREAM_WORK = {("cg", "three-pass"): 3, ("cg", "stored"): 4, ("mrr", "stored"): 4}
PROBE_WORK = 5
STREAM_INSTANCES = sorted(fused.STREAM_SHIPPED, key=str)


@pytest.mark.cuda
@pytest.mark.parametrize("method, ns_pass, dtype", STREAM_INSTANCES)
def test_fused_workspace_sizes(cuda, method, ns_pass, dtype):
    """The C library sizes the streaming route's scratch: n-vectors of work
    by the instance's form (the pass probe's 5), 8 partial-sum slots a
    block, and the plan's blocks, no more than n points need or than are
    co-resident: four an SM for the instances on points and tiles-4 and
    the masked pass's (built with no minimum, at 48 registers or fewer),
    two at least for those on tiles; the resident route's scratch is the plan's
    edge-row exchange and 6 sum words a band plus 6."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    stencil2 = fixtures.laplace2d(4, constant=True, device=cuda).stencil
    form, walk = fused.STREAM_SHIPPED[method, ns_pass, dtype]
    for n, grid in ((64 * 64, (64, 64)), (1500 * 1500, (1500, 1500))):
        p = fused.plan(method, grid, stencil2, dtype, sms, route="streaming")
        assert p.blocks == min(-(-n // 256), fused.STREAM_BLOCKS_PER_SM * sms)
        for probe, vectors in ((False, STREAM_WORK[method, form]), (True, PROBE_WORK)):
            blocks, work, partials = fused.workspace(method, dtype, n, p.blocks, ns_pass, probe)
            if walk != "tiles":
                assert blocks == p.blocks
            else:
                assert min(2 * sms, p.blocks) <= blocks <= p.blocks
            assert work == vectors * n and partials == 8 * blocks
            assert fused.workspace(method, dtype, n, p.blocks, ns_pass, probe) == (blocks, work, partials)
    r = fused.device_plan(method, (64, 64), fixtures.laplace2d(4, device=cuda).stencil, torch.float64)
    assert r.route == "resident" and fused.resident_buffers(r, (64, 64)) == (r.blocks * 2 * 64, 6 * r.blocks + 6)


# the streaming K2/K3 against the plain versions: rows that start on 16
# bytes in both dtypes (the 16-byte loads of the tiled walks), rows that do
# not (the scalar chunk path), rows of several tiles, for the passes
# specialised on 5 and 7 terms, and the grid-coefficient form (the masked
# pass, NS 0)
STREAM_CASES = {
    "ns5 aligned rows": (5, lambda **kw: fixtures.laplace2d(40, 64, constant=True, **kw)),
    "ns5 ragged rows": (5, lambda **kw: fixtures.laplace2d(33, 45, constant=True, **kw)),
    "ns5 wide rows": (5, lambda **kw: fixtures.laplace2d(10, 1100, constant=True, **kw)),
    "ns7 aligned rows": (7, lambda **kw: fixtures.laplace3d(12, constant=True, **kw)),
    "ns7 ragged rows": (7, lambda **kw: fixtures.laplace3d(9, 7, 11, constant=True, **kw)),
    "ns0 grid coefficients": (0, lambda **kw: fixtures.laplace2d(40, 64, **kw)),
}
# the first pass of each form: the probe's pass, and the rows of the work
# vectors it writes
FIRST_PASS = {"three-pass": ("stencil", (3,)), "stored": ("form-store", (2, 3))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(STREAM_CASES))
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_streaming_forms_match_plain(cuda, method, name, dtype, monkeypatch):
    """The streaming K2/K3 (ROUTE = "streaming"), each instance in its form
    on its walk (fused.STREAM_SHIPPED), on the same inputs against the
    plain version: equal counts and convergence, traces and x within
    ROUTE_TOLS; the launch counts under its pass."""
    ns, make = STREAM_CASES[name]
    A = make(dtype=dtype, device=cuda)
    b = _rhs(A.shape[0], 6, cuda, dtype)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    assert fused.pass_terms(stencil2, coef2.ndim == 1) == ns
    tol = 1e-8 if dtype == torch.float64 else 1e-5
    kw = dict(stencil=stencil2, grid=grid2, maxiter=A.shape[0], sub=sub)
    b_norm = torch.linalg.vector_norm(b)
    monkeypatch.setattr(fused, "ROUTE", "streaming")
    fn = KERNEL[method]
    before = getattr(_launched(fn), f"streaming_ns{ns}")
    x, t, i, c = fn(coef2, b, tol, b_norm, **kw)
    assert getattr(_launched(fn), f"streaming_ns{ns}") == before + 1
    xr, tr, ir, cr = PLAIN[method](coef2, b, tol, b_norm, **kw)
    assert int(i) == int(ir) and bool(c) and bool(cr)
    m = int(i) + 1
    trace_rtol, x_rtol, x_atol = ROUTE_TOLS[dtype]
    torch.testing.assert_close(t[:m], tr[:m], rtol=trace_rtol, atol=0)
    torch.testing.assert_close(x, xr, rtol=x_rtol, atol=x_atol)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr"])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", ["ns5 aligned rows", "ns5 ragged rows", "ns7 aligned rows", "ns7 ragged rows"])
def test_stream_probe_pass_equals_masked_pass(cuda, name, dtype, rtol, method):
    """The first pass of each instance's form alone (fused.stream_probe) on
    its walk: CG's v = A p or p = r + beta q formed at every point it reads
    and A p, MrR's A r; the specialised pass bitwise the masked one on the
    same weights, and both against the plain stencil."""
    ns, make = STREAM_CASES[name]
    A = make(dtype=dtype, device=cuda)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    v = _rhs(A.shape[0], 8, cuda, dtype)
    kw = dict(stencil=stencil2, grid=grid2, sub=sub)
    form = fused.stream_shape(method, ns, dtype)[0]
    pass_name, rows = FIRST_PASS[form] if method == "cg" else ("sums-y", (3,))
    out = {n: fused.stream_probe(coef2, v, method, pass_name, ns_pass=n, **kw) for n in (ns, 0)}
    assert all(torch.equal(out[ns][r], out[0][r]) for r in rows)
    p = torch.addcmul(v, torch.full_like(v, 0.5), v) if pass_name == "form-store" else v
    if pass_name == "form-store":
        torch.testing.assert_close(out[ns][2], p, rtol=0, atol=rtol * float(p.abs().max()))
    y = stencil.stencil_matvec_2d_reference(coef2, p, **kw)
    torch.testing.assert_close(out[ns][3], y, rtol=0, atol=rtol * float(y.abs().max()))


# resident K2/K3 against the plain versions: a grid whose rows do not divide
# evenly among 132 bands, the collapsed 3-D constant form with its sub mask,
# the grid-coefficient form, and a grid of 5 rows (5 bands)
RESIDENT_CASES = {
    "uneven rows": lambda **kw: fixtures.laplace2d(40, 133, constant=True, **kw),
    "3d-const sub": lambda **kw: fixtures.laplace3d(16, constant=True, **kw),
    "grid coefficients": lambda **kw: fixtures.laplace2d(48, 37, **kw),
    "few bands": lambda **kw: fixtures.laplace2d(30, 5, constant=True, **kw),
}
# (trace rtol, x rtol, x atol): float64 as the other fused tests; float32
# as chip_smoke.py's TOLS
ROUTE_TOLS = {torch.float64: (1e-9, 1e-8, 1e-12), torch.float32: (1e-4, 1e-4, 1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("route", ["resident", "streaming"])
@pytest.mark.parametrize("name", sorted(RESIDENT_CASES))
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_routes_match_plain(cuda, method, name, route, dtype, monkeypatch):
    """Each route of K2/K3 on the same inputs against the plain version:
    equal counts and convergence, traces and x within ROUTE_TOLS; the
    route's own launch counter moves."""
    A = RESIDENT_CASES[name](dtype=dtype, device=cuda)
    b = _rhs(A.shape[0], 6, cuda, dtype)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    tol = 1e-8 if dtype == torch.float64 else 1e-5
    kw = dict(stencil=stencil2, grid=grid2, maxiter=A.shape[0], sub=sub)
    b_norm = torch.linalg.vector_norm(b)
    monkeypatch.setattr(fused, "ROUTE", route)
    assert fused.device_plan(method, grid2, stencil2, dtype).route == route
    fn = KERNEL[method]
    before, before_route = _launched(fn).launches, getattr(_launched(fn), route)
    x, t, i, c = fn(coef2, b, tol, b_norm, **kw)
    assert _launched(fn).launches == before + 1 and getattr(_launched(fn), route) == before_route + 1
    xr, tr, ir, cr = PLAIN[method](coef2, b, tol, b_norm, **kw)
    assert int(i) == int(ir) and bool(c) and bool(cr)
    m = int(i) + 1
    trace_rtol, x_rtol, x_atol = ROUTE_TOLS[dtype]
    torch.testing.assert_close(t[:m], tr[:m], rtol=trace_rtol, atol=0)
    torch.testing.assert_close(x, xr, rtol=x_rtol, atol=x_atol)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_fused_kernel_maxiter_divergence(cuda, method):
    A = fixtures.laplace2d(16, device=cuda)
    b = _rhs(A.shape[0], 1, cuda)
    kw = dict(stencil=A.stencil, grid=A.grid, maxiter=5)
    x, t, i, c = KERNEL[method](A.coef, b, 1e-14, torch.linalg.vector_norm(b), **kw)
    xr, tr, ir, cr = PLAIN[method](A.coef, b, 1e-14, torch.linalg.vector_norm(b), **kw)
    assert not bool(c) and int(i) == int(ir) == 5
    torch.testing.assert_close(t, tr, rtol=1e-9, atol=1e-14)
    torch.testing.assert_close(x, xr, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_solve_on_cuda_matches_cpu(cuda, method):
    """The same system through solve() on the card (kernels) and on the CPU
    (plain versions), with a warm start."""
    b = np.random.default_rng(7).standard_normal(32 * 32)
    x0 = 0.1 * np.random.default_rng(8).standard_normal(32 * 32)
    x_c, info_c = krylov_tpu_torch.solve(fixtures.laplace2d(32, constant=True, device="cpu"), b, method=method, x0=x0,
                                         tol=1e-8)
    x_g, info_g = krylov_tpu_torch.solve(
        fixtures.laplace2d(32, constant=True, device=cuda), b, method=method, x0=x0, tol=1e-8
    )
    assert x_g.device.type == "cuda"
    assert info_g["iterations"] == info_c["iterations"] and info_g["converged"]
    np.testing.assert_allclose(info_g["residual"], info_c["residual"], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
def test_kernel_runs_on_torch_current_stream(cuda):
    """The kernel is ordered after work queued on a side stream: it takes
    torch's current stream, not the default one."""
    A = fixtures.laplace2d(64, constant=True, device=cuda)
    x = _rhs(A.shape[0], 9, cuda)
    y_ref = stencil.stencil_matvec_2d(A.coef, x, stencil=A.stencil, grid=A.grid)
    side = torch.cuda.Stream()
    xs = torch.zeros_like(x)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)  # keep the side stream busy
        xs.copy_(x)
        ys = stencil.stencil_matvec_2d(A.coef, xs, stencil=A.stencil, grid=A.grid)
    torch.cuda.synchronize()
    torch.testing.assert_close(ys, y_ref, rtol=0, atol=0)


def _advection(device, g=(16, 16), eps=0.5):
    """Non-normal advection-like stencil on which adaptive k-skip MrR rolls
    back (tests/test_kernels.py:198-212), grid-coefficient form."""
    iy = np.arange(g[0])[:, None]
    ix = np.arange(g[1])[None, :]
    coef = np.stack([
        -(1 + eps) * np.broadcast_to(iy > 0, g).astype(float),
        -(1 + eps) * np.broadcast_to(ix > 0, g).astype(float),
        np.full(g, 4.5),
        -(1 - eps) * np.broadcast_to(ix < g[1] - 1, g).astype(float),
        -(1 - eps) * np.broadcast_to(iy < g[0] - 1, g).astype(float),
    ])
    return StencilMatrix(torch.from_numpy(coef).to(device), ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), g)


def _kskip_pair(A, b, method, k, adaptive, tol, maxiter, route=None):
    """The K5/K6 kernel (on ``route``, forced through fused.ROUTE, when
    given: its plan must take it and its counter must move) and its plain
    version on the same inputs, both in K5's output layout (x, trace, nosl,
    ktrace, iters, conv, index, final_k)."""
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    kw = dict(stencil=stencil2, grid=grid2, maxiter=maxiter, k_max=max(k, 1), sub=sub)
    b_norm = torch.linalg.vector_norm(b)
    fn = fused_kskip.fused_kskipcg_solve_2d if method == "kskipcg" else fused_kskip.fused_kskipmrr_solve_2d
    previous, fused.ROUTE = fused.ROUTE, route
    try:
        p = fused_kskip.device_plan(method, grid2, stencil2, b.dtype, kw["k_max"])
        assert route is None or p.route == route
        before, before_route = _launched(fn).launches, getattr(_launched(fn), p.route)
        if method == "kskipcg":
            x, t, n, i, c, idx = fn(coef2, b, tol, b_norm, k, **kw)
            got = (x, t, n, None, i, c, idx, None)
        else:
            got = fn(coef2, b, tol, b_norm, k, adaptive=adaptive, **kw)
    finally:
        fused.ROUTE = previous
    assert _launched(fn).launches == before + 1 and getattr(_launched(fn), p.route) == before_route + 1
    if method == "kskipcg":
        xr, tr, nr, ir, cr, idr = fused_kskip.fused_kskipcg_solve_2d_reference(coef2, b, tol, b_norm, k, **kw)
        return got, (xr, tr, nr, None, ir, cr, idr, None)
    return got, fused_kskip.fused_kskipmrr_solve_2d_reference(coef2, b, tol, b_norm, k, adaptive=adaptive, **kw)


def _check_kskip(got, want, trace_rtol=1e-5, x_rtol=1e-6, x_atol=1e-9):
    (x, t, n, kt, i, c, idx, f), (xr, tr, nr, ktr, ir, cr, idr, fr) = got, want
    assert (int(i), bool(c), int(idx)) == (int(ir), bool(cr), int(idr))
    m = int(idx) + 1
    torch.testing.assert_close(n[:m], nr[:m], rtol=0, atol=0)
    if kt is not None:
        torch.testing.assert_close(kt, ktr, rtol=0, atol=0)
        assert int(f) == int(fr)
    torch.testing.assert_close(t[:m], tr[:m], rtol=trace_rtol, atol=0)
    torch.testing.assert_close(x, xr, rtol=x_rtol, atol=x_atol)
    return int(f) if f is not None else None, bool(c)


KSKIP_ROUTES = ["resident", "streaming"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", KSKIP_ROUTES)
@pytest.mark.parametrize("name", sorted(OPERATORS))
@pytest.mark.parametrize(
    "method, k, adaptive",
    [("kskipcg", 0, False), ("kskipcg", 4, False), ("kskipmrr", 2, False), ("kskipmrr", 4, True)],
)
def test_fused_kskip_kernel_matches_plain(cuda, method, k, adaptive, name, route):
    A = OPERATORS[name](device=cuda)
    b = _rhs(A.shape[0], 6, cuda)
    _, conv = _check_kskip(*_kskip_pair(A, b, method, k, adaptive, 1e-8, A.shape[0], route))
    assert conv


@pytest.mark.cuda
@pytest.mark.parametrize("route", KSKIP_ROUTES)
@pytest.mark.parametrize("name", sorted(OPERATORS))
@pytest.mark.parametrize(
    "method, k",
    [("kskipcg", 1), ("kskipcg", 4), ("kskipmrr", 2), ("kskipmrr", 4), ("adaptivekskipmrr", 4)],
)
def test_fused_kskip_kernel_matches_plain_f32(cuda, method, k, name, route):
    """The float32 builds of K5/K6 at tol 1e-5."""
    A = OPERATORS[name](dtype=torch.float32, device=cuda)
    b = _rhs(A.shape[0], 6, cuda, torch.float32)
    if k < 4:
        maxiter, A_ref, b_ref = A.shape[0], A, b
    else:
        maxiter = (k + 1) + (method != "kskipcg")
        A_ref, b_ref = StencilMatrix(A.coef.double(), A.stencil, A.grid), b.double()
    adaptive, m = method.startswith("adaptive"), method.removeprefix("adaptive")
    got, _ = _kskip_pair(A, b, m, k, adaptive, 1e-5, maxiter, route)
    _, want = _kskip_pair(A_ref, b_ref, m, k, adaptive, 1e-5, maxiter, route)
    (x, t, n, kt, i, c, idx, f), (xr, tr, nr, ktr, ir, cr, idr, fr) = got, want
    assert (int(i), bool(c), int(idx)) == (int(ir), bool(cr), int(idr)) and bool(c) == (k < 4)
    m_ = int(idx) + 1
    assert torch.equal(n[:m_], nr[:m_]) and (kt is None or (torch.equal(kt, ktr) and int(f) == int(fr)))
    trace_rtol, x_rel = F32_TOLS[k]
    torch.testing.assert_close(t[:m_].double(), tr[:m_].double(), rtol=trace_rtol, atol=0)
    assert float((x.double() - xr.double()).abs().max() / xr.double().abs().max()) <= x_rel


@pytest.mark.cuda
@pytest.mark.parametrize("route", KSKIP_ROUTES)
def test_fused_kskip_rollback_matches_plain(cuda, route):
    """The adaptive kernel rolls back on the advection stencil (k drops
    below 6) exactly where its plain version does."""
    A = _advection(cuda)
    b = _rhs(A.shape[0], 3, cuda)
    final_k, conv = _check_kskip(*_kskip_pair(A, b, "kskipmrr", 6, True, 1e-8, 2000, route))
    assert final_k < 6 and conv


@pytest.mark.cuda
@pytest.mark.parametrize("route", KSKIP_ROUTES)
@pytest.mark.parametrize("method, adaptive", [("kskipcg", False), ("kskipmrr", True)])
def test_fused_kskip_kernel_maxiter_divergence(cuda, method, adaptive, route):
    A = fixtures.laplace2d(16, device=cuda)
    b = _rhs(A.shape[0], 1, cuda)
    _, conv = _check_kskip(*_kskip_pair(A, b, method, 2, adaptive, 1e-14, 9, route))
    assert not conv


# K5/K6's streaming pass by system: (operator, the pass it takes).  The
# specialised passes (NS 5, 7) on a small 2-D grid, a row whose length (31)
# is not a multiple of the points of a 16-byte load, rows of 600 that end
# in part of a tile, a collapsed 3-D grid and one whose inner axis (11) is
# odd; the masked pass (NS 0) on the grid-coefficient form.
STREAM_PASS_SYSTEMS = {
    "2d-const": (lambda **kw: fixtures.laplace2d(24, constant=True, **kw), 5),
    "2d-const-row31": (lambda **kw: fixtures.laplace2d(31, 17, constant=True, **kw), 5),
    "2d-const-row600": (lambda **kw: fixtures.laplace2d(600, 13, constant=True, **kw), 5),
    "3d-const": (lambda **kw: fixtures.laplace3d(10, constant=True, **kw), 7),
    "3d-const-inner11": (lambda **kw: fixtures.laplace3d(11, 9, 7, constant=True, **kw), 7),
    "2d": (lambda **kw: fixtures.laplace2d(24, **kw), 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(STREAM_PASS_SYSTEMS))
def test_streaming_pass_matches_masked(cuda, name, dtype):
    """The streaming pass K5/K6 take for the system (fused_kskip.sweep_probe,
    "pass") is bitwise the masked pass (NS = 0) on the same vector, and the
    masked pass is the plain stencil within K1's tolerance."""
    make, ns = STREAM_PASS_SYSTEMS[name]
    A = make(dtype=dtype, device=cuda)
    coef2, st2, g2, sub = A.collapse_to_2d()
    assert fused.pass_terms(st2, coef2.ndim == 1) == ns
    x = _rhs(A.shape[0], 9, cuda, dtype)
    kw = dict(stencil=st2, grid=g2, sub=sub)
    y = fused_kskip.sweep_probe(coef2, x, "pass", 1, **kw)[1]
    y0 = fused_kskip.sweep_probe(coef2, x, "pass", 1, ns_pass=0, **kw)[1]
    assert torch.equal(y, y0)
    ref = stencil.stencil_matvec_2d_reference(coef2, x, **kw)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((y0 - ref).abs().max() / ref.abs().max()) <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr"])
def test_streaming_launches_count_their_pass(cuda, method, monkeypatch):
    """A streaming K5/K6 launch counts under the pass it took: NS 7 for the
    collapsed 3-D constant stencil, 0 for the grid form."""
    monkeypatch.setattr(fused, "ROUTE", "streaming")
    fn = getattr(fused_kskip, f"fused_{method}_solve_2d")
    for A, ns in ((fixtures.laplace3d(10, constant=True, device=cuda), 7), (fixtures.laplace2d(24, device=cuda), 0)):
        before = getattr(_launched(fn), f"streaming_ns{ns}")
        krylov_tpu_torch.solve(A, _rhs(A.shape[0], 6, cuda), method=method, k=2, tol=1e-8)
        assert getattr(_launched(fn), f"streaming_ns{ns}") == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("method, vectors", [("kskipcg", 8), ("kskipmrr", 10)])
def test_fused_kskip_workspace_sizes(cuda, method, vectors):
    """The C library sizes the K5/K6 scratch from the method and k_max:
    n-vectors of work by method, 6 k_max + 6 bundle partials and 3 grid-sum
    slots a block plus 6 k_max + 6 totals, and the dynamic shared memory of
    the bundle and the 2 (k_max + 1) step coefficients."""
    n = 64 * 64
    for k_max in (1, 8):
        blocks, work, partials, smem = fused_kskip.workspace(method, torch.float64, n, k_max)
        m = 6 * k_max + 6
        assert 1 <= blocks <= n // 256 and work == vectors * n
        assert partials == (m + 3) * blocks + m and smem == (m + 2 * (k_max + 1)) * 8
    assert fused_kskip.workspace(method, torch.float32, n, 8)[3] == (54 + 18) * 4


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr"])
def test_kskip_streaming_plan_is_the_launched_grid(cuda, method, monkeypatch):
    """A streaming K5/K6 plan carries the grid workspace() sizes, the one
    its launch takes, and fused.MAX_BLOCKS caps it; the solve on the capped
    grid matches the plain version."""
    A = fixtures.laplace2d(64, constant=True, device=cuda)
    monkeypatch.setattr(fused, "ROUTE", "streaming")
    p = fused_kskip.device_plan(method, A.grid, A.stencil, torch.float64, 2)
    ns_pass = fused.pass_terms(A.stencil, True)
    assert ns_pass == 5
    assert p.route == "streaming" and p.blocks == fused_kskip.workspace(method, torch.float64, A.shape[0], 2,
                                                                        ns_pass)[0] > 3
    monkeypatch.setattr(fused, "MAX_BLOCKS", 3)
    assert fused_kskip.device_plan(method, A.grid, A.stencil, torch.float64, 2).blocks == 3
    _, conv = _check_kskip(*_kskip_pair(A, _rhs(A.shape[0], 6, cuda), method, 2, False, 1e-8, A.shape[0], "streaming"))
    assert conv


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "kskipcg"])
def test_max_blocks_caps_the_grid(cuda, method, monkeypatch):
    """fused.MAX_BLOCKS caps the cooperative grid of K2/K3 and of K5/K6 (on
    the route the plan takes, here the resident one: fewer, taller bands)
    and sizes the scratch by the capped grid; the solve is the same up to
    the order of the sums."""
    A = fixtures.laplace2d(64, constant=True, device=cuda)
    b = _rhs(A.shape[0], 6, cuda)
    n, b_norm = A.shape[0], torch.linalg.vector_norm(b)
    kw = dict(stencil=A.stencil, grid=A.grid, maxiter=n)

    def run():
        if method == "cg":
            x, _, iters, _ = fused.fused_cg_solve_2d(A.coef, b, 1e-8, b_norm, **kw)
            p = fused.device_plan("cg", A.grid, A.stencil, torch.float64)
            assert p.route == "resident"
            return (p.blocks, *fused.resident_buffers(p, A.grid)), x, iters
        x, _, _, iters, _, _ = fused_kskip.fused_kskipcg_solve_2d(A.coef, b, 1e-8, b_norm, 2, k_max=2, **kw)
        p = fused_kskip.device_plan("kskipcg", A.grid, A.stencil, torch.float64, 2)
        assert p.route == "resident"
        return (p.blocks, *fused_kskip.resident_buffers(p, A.grid, 2)), x, iters

    full, x_full, iters_full = run()
    monkeypatch.setattr(fused, "MAX_BLOCKS", 3)
    capped, x, iters = run()
    assert full[0] > 3 and capped[0] == 3
    assert capped[2] == (6 * 3 + 6 if method == "cg" else 6 * 3 + 6 + 2 * 18 * (3 + 1))
    assert int(iters) == int(iters_full)
    torch.testing.assert_close(x, x_full, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr", "adaptivekskipmrr"])
def test_kskip_solve_on_cuda_matches_cpu(cuda, method):
    """The same system through solve() on the card (kernels) and on the CPU
    (plain versions), with a warm start."""
    b = np.random.default_rng(7).standard_normal(32 * 32)
    x0 = 0.1 * np.random.default_rng(8).standard_normal(32 * 32)
    kw = dict(method=method, k=3, x0=x0, tol=1e-8)
    x_c, info_c = krylov_tpu_torch.solve(fixtures.laplace2d(32, constant=True, device="cpu"), b, **kw)
    x_g, info_g = krylov_tpu_torch.solve(fixtures.laplace2d(32, constant=True, device=cuda), b, **kw)
    assert x_g.device.type == "cuda" and info_g["converged"]
    assert info_g["iterations"] == info_c["iterations"]
    np.testing.assert_array_equal(info_g["nosl"], info_c["nosl"])
    np.testing.assert_allclose(info_g["residual"], info_c["residual"], rtol=1e-5)
    np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-6, atol=1e-9)
    r = fused_kskip.device_plan(method.removeprefix("adaptive"), (32, 32), fixtures.laplace2d(4, device=cuda).stencil,
                                torch.float64, 3)
    assert r.route == "resident" and fused_kskip.resident_buffers(r, (32, 32), 3) == (
        r.blocks * 8 * 32, 6 * r.blocks + 6 + 2 * 24 * (r.blocks + 1))


IRREGULAR = {
    "ell": lambda dtype: fixtures.random_spd_ell(3000, seed=2, dtype=dtype, device="cpu"),
    "hyb": lambda dtype: convert.to_hyb(fixtures.powerlaw_spd(4000, seed=11, max_deg=400), dtype=dtype, device="cpu"),
    "dense": lambda dtype: convert.to_dense(fixtures.powerlaw_spd(300, seed=3), dtype=dtype, device="cpu"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(IRREGULAR))
def test_batched_irregular_matvec_on_cuda_matches_cpu(cuda, name, dtype, rtol):
    """The (batch, n) matvec of ELL/HYB/dense on the card against the CPU
    result and against the card's own solo matvecs (max error against the
    largest entry), and two card runs bitwise equal: the HYB tail's
    scatter-add sorts its rows, so its sums keep one order."""
    A = IRREGULAR[name](dtype)
    X = torch.from_numpy(np.random.default_rng(5).standard_normal((4, A.shape[0]))).to(dtype)
    Y_cpu = A.matvec(X)
    A_g = to_device(A, cuda)
    Y = A_g.matvec(X.to(cuda))
    assert Y.shape == X.shape and Y.device.type == "cuda"
    scale = float(Y_cpu.abs().max())
    torch.testing.assert_close(Y.cpu(), Y_cpu, rtol=0, atol=rtol * scale)
    for j in range(4):
        torch.testing.assert_close(Y[j], A_g.matvec(X[j].to(cuda)), rtol=0, atol=rtol * scale)
    assert torch.equal(A_g.matvec(X.to(cuda)), Y)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr"])
def test_solve_batched_fused_members_equal_solo_on_cuda(cuda, method):
    """Each member of a fused batch is the solo fused solve of its b: the
    same kernel launch on the same values, on the resident route."""
    A = fixtures.laplace2d(32, constant=True, device=cuda)
    B = torch.from_numpy(np.random.default_rng(9).standard_normal((3, A.shape[0]))).to(cuda)
    fn = {**KERNEL, "kskipcg": fused_kskip.fused_kskipcg_solve_2d, "kskipmrr": fused_kskip.fused_kskipmrr_solve_2d,
          "adaptivekskipmrr": fused_kskip.fused_kskipmrr_solve_2d}[method]
    before = _launched(fn).resident
    res = krylov_tpu_torch.solve_batched(A, B, method=method, k=2, tol=1e-8)
    assert _launched(fn).resident == before + 3
    for j in range(3):
        solo = krylov_tpu_torch.solve_device(A, B[j], method=method, k=2, tol=1e-8)
        assert int(res.iterations[j]) == int(solo.iterations) and bool(res.converged[j])
        assert torch.equal(res.x[j], solo.x)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_batched_eager_on_cuda_matches_cpu(cuda, method):
    """The batched eager loop on a HYB operator on the card against the
    same loop on the CPU (float64: equal counts, x rtol 1e-10)."""
    A = convert.to_hyb(fixtures.powerlaw_spd(3000, seed=4, diag_scale_decades=0.5), device="cpu")
    B = np.random.default_rng(10).standard_normal((3, A.shape[0]))
    res_c = krylov_tpu_torch.solve_batched(A, B, method=method, tol=1e-10)
    res_g = krylov_tpu_torch.solve_batched(to_device(A, cuda), torch.from_numpy(B).to(cuda), method=method, tol=1e-10)
    assert torch.equal(res_g.iterations.cpu(), res_c.iterations) and bool(res_g.converged.all())
    torch.testing.assert_close(res_g.x.cpu(), res_c.x, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_restarts_and_refine_on_cuda(cuda):
    """float32 on the card: restarts= corrects through K2 (the defects
    through K1) and refine= returns a float64 x on the card, both ending
    below tol by the host float64 residual."""
    A = fixtures.laplace2d(64, dtype=torch.float32, constant=True, device=cuda)
    b = np.random.default_rng(11).standard_normal(A.shape[0]).astype(np.float32)
    k1, k2 = tracing.totals.stencil_matvec_2d.launches, tracing.totals.fused_mrr_solve_2d.launches
    res = krylov_tpu_torch.solve_device(A, b, method="mrr", tol=1e-6, restarts=2)
    assert tracing.totals.stencil_matvec_2d.launches > k1 and tracing.totals.fused_mrr_solve_2d.launches > k2 + 1
    x, info = krylov_tpu_torch.solve(A, b, method="mrr", tol=1e-7, refine=3)
    assert x.dtype == torch.float64 and x.device.type == "cuda"
    A64 = convert.host_matvec64
    for xx, tol in ((res.x, 1e-6), (x, 1e-7)):
        true = np.linalg.norm(b - A64(A, xx)) / np.linalg.norm(b)
        assert true < tol
    assert bool(res.converged) and info["converged"] and info["true_residual"] < 1e-7


# K1 as the eager loops' SpMV: the redesigned kernel (one interior test a
# point, the constant form's weights as arguments, a grid sized to the SMs)
# against its plain version on grids that meet the boundary in every way:
# uneven rows, the collapsed 3-D constant form with its sub mask, the
# grid-coefficient form (2-D and 3-D), few rows, and one row
K1_CASES = {
    "uneven": lambda **kw: fixtures.laplace2d(37, 29, constant=True, **kw),
    "3d-const sub": lambda **kw: fixtures.laplace3d(9, 7, 6, constant=True, **kw),
    "3d grid coefficients": lambda **kw: fixtures.laplace3d(7, 6, 5, **kw),
    "grid coefficients": lambda **kw: fixtures.laplace2d(33, 19, **kw),
    "few rows": lambda **kw: fixtures.laplace2d(50, 3, constant=True, **kw),
    "one row": lambda **kw: fixtures.laplace2d(11, 1, constant=True, **kw),
}
K1_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}  # phase 3 of chip_smoke.py


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_k1_matches_plain(cuda, name, dtype):
    """K1 against its plain version (max error against the largest entry),
    one vector and a (8, n) block in one launch, member by member."""
    A = K1_CASES[name](dtype=dtype, device=cuda)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    kw = dict(stencil=stencil2, grid=grid2, sub=sub)
    X = torch.from_numpy(np.random.default_rng(31).standard_normal((8, A.shape[0]))).to(cuda, dtype)
    before = tracing.totals.stencil_matvec_2d.launches
    Y = stencil.stencil_matvec_2d(coef2, X, **kw)
    y = stencil.stencil_matvec_2d(coef2, X[3], **kw)
    assert tracing.totals.stencil_matvec_2d.launches == before + 2 and Y.shape == X.shape
    for j in range(8):
        ref = stencil.stencil_matvec_2d_reference(coef2, X[j], **kw)
        torch.testing.assert_close(Y[j], ref, rtol=0, atol=K1_RTOL[dtype] * float(ref.abs().max()))
    assert torch.equal(Y[3], y)


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(cuda):
    """A CUDA tensor launches K1 or raises: no fall back on the plain chain."""
    A = fixtures.laplace2d(8, constant=True, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        stencil.stencil_matvec_2d(A.coef, torch.zeros(64, dtype=torch.float32, device=cuda), stencil=A.stencil,
                                  grid=A.grid)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.stencil_matvec_2d(A.coef, torch.zeros(64, 2, dtype=torch.float64, device=cuda)[:, 0],
                                  stencil=A.stencil, grid=A.grid)
    with pytest.raises(ValueError, match="CUDA device"):
        fixtures.laplace2d(8, constant=True, device="cpu").matvec(torch.zeros(64, device=cuda))


@pytest.mark.cuda
def test_k1_weights_follow_in_place_changes(cuda):
    """The constant form's weights are read once per tensor and version:
    scaling the weights in place changes the product."""
    A = fixtures.laplace2d(16, constant=True, device=cuda)
    x = _rhs(A.shape[0], 3, cuda)
    y = A.matvec(x)
    A.coef.mul_(2.0)
    torch.testing.assert_close(A.matvec(x), 2 * y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["2d", "3d-const"])
def test_stencil_matvec_on_cuda_launches_k1(cuda, name):
    """StencilMatrix.matvec on a CUDA tensor is one K1 launch, for a vector
    and for a (batch, n) block, equal to the plain chain on the CPU; a 1-D
    grid keeps the chain."""
    A = OPERATORS[name](device=cuda)
    X = torch.from_numpy(np.random.default_rng(32).standard_normal((3, A.shape[0])))
    before = tracing.totals.stencil_matvec_2d.launches
    y, Y = A.matvec(X[0].to(cuda)), A.matvec(X.to(cuda))
    assert tracing.totals.stencil_matvec_2d.launches == before + 2
    A_cpu = to_device(A, "cpu")
    for got, x in ((y, X[0]), (Y, X)):
        ref = A_cpu.matvec(x)
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-12 * float(ref.abs().max()))
    line = StencilMatrix(torch.tensor([-1.0, 2.0, -1.0], device=cuda), ((-1,), (0,), (1,)), (40,))
    before = tracing.totals.stencil_matvec_2d.launches
    line.matvec(torch.ones(40, dtype=torch.float64, device=cuda))
    assert tracing.totals.stencil_matvec_2d.launches == before


NEW_METHODS = [(m, p) for m in ("pcg", "chronopoulos_gear", "gropp", "pipelined_cg")
               for p in ("none", "jacobi", "chebyshev")] + [("cacg", "none"), ("camrr", "none")]


@pytest.mark.cuda
@pytest.mark.parametrize("method, precond", NEW_METHODS)
def test_new_methods_on_cuda_match_cpu(cuda, method, precond):
    """The preconditioned, pipelined and CA solves through solve() on the
    card (K1 for every SpMV) against the same solves on the CPU, float64:
    equal counts, residual histories rtol 1e-6 (the CA recurrences amplify
    rounding), x rtol 1e-6."""
    from krylov_tpu_torch import precond as pc

    kw = dict(method=method, tol=1e-8, maxiter=2000)
    if method in ("cacg", "camrr"):
        kw.update(k=4)
    out = {}
    for dev in ("cpu", cuda):
        A = fixtures.laplace2d(32, constant=True, device=dev)
        if precond == "jacobi":
            kw["M"] = pc.jacobi(A)
        elif precond == "chebyshev":
            kw["M"] = pc.chebyshev(A, degree=4, lmin=0.05, lmax=8.0)
        before = tracing.totals.stencil_matvec_2d.launches
        out[dev] = krylov_tpu_torch.solve(A, np.random.default_rng(33).standard_normal(A.shape[0]), **kw)
        if dev != "cpu":
            assert tracing.totals.stencil_matvec_2d.launches - before >= out[dev][1]["iterations"]
    (x_c, info_c), (x_g, info_g) = out["cpu"], out[cuda]
    assert info_g["converged"] and info_g["iterations"] == info_c["iterations"]
    np.testing.assert_array_equal(info_g["nosl"], info_c["nosl"])
    np.testing.assert_allclose(info_g["residual"], info_c["residual"], rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_float32_ca_solves_ignore_allow_tf32(cuda, method):
    """The Gram, the s-step products and the recovery combinations of a
    float32 CA solve, and the projections of lanczos_bounds, give the same
    bits with TF32 matrix products allowed as without."""
    from krylov_tpu_torch import precond as pc
    from krylov_tpu_torch.context import Context

    A = fixtures.laplace2d(48, dtype=torch.float32, constant=True, device=cuda)
    b = np.random.default_rng(34).standard_normal(A.shape[0]).astype(np.float32)
    V = torch.from_numpy(np.random.default_rng(35).standard_normal((9, A.shape[0]))).to(cuda, torch.float32)
    runs = []
    previous = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            x, info = krylov_tpu_torch.solve(A, b, method=method, k=8, tol=1e-5, maxiter=600)
            runs.append((x, info["iterations"], pc.lanczos_bounds(A), Context().gram(V)))
            assert torch.backends.cuda.matmul.allow_tf32 == flag  # the Gram restores the flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    (x0, i0, b0, g0), (x1, i1, b1, g1) = runs
    assert i0 == i1 and b0 == b1 and torch.equal(x0, x1) and torch.equal(g0, g1)


@pytest.mark.cuda
@pytest.mark.parametrize("method, k", [("kskipcg", 4), ("kskipmrr", 4), ("adaptivekskipmrr", 8)])
def test_batched_kskip_members_equal_solos_on_cuda(cuda, method, k):
    """The eager k-skip loops on a (4, n) block on the card: one K1 launch a
    batched SpMV, and each member's inner products are its solo solve's, so
    each member takes its solo count, nosl and khistory, x rtol 1e-12."""
    A = fixtures.laplace2d(40, constant=True, device=cuda)
    B = torch.from_numpy(np.random.default_rng(34).standard_normal((4, A.shape[0]))).to(cuda)
    kw = dict(method=method, k=k, tol=1e-8, maxiter=2000, fused=False)
    before = tracing.totals.stencil_matvec_2d.launches
    res = krylov_tpu_torch.solve_batched(A, B, **kw)
    batched = tracing.totals.stencil_matvec_2d.launches - before
    solo_launches = []
    for j in range(4):
        before = tracing.totals.stencil_matvec_2d.launches
        solo = krylov_tpu_torch.solve_device(A, B[j], **kw)
        solo_launches.append(tracing.totals.stencil_matvec_2d.launches - before)
        m = int(solo.index) + 1
        assert (int(res.iterations[j]), int(res.index[j])) == (int(solo.iterations), int(solo.index))
        assert torch.equal(res.nosl_trace[j, :m], solo.nosl_trace[:m]) and bool(solo.converged)
        if solo.k_trace is not None:
            assert torch.equal(res.k_trace[j, :m], solo.k_trace[:m])
        torch.testing.assert_close(res.x[j], solo.x, rtol=1e-12, atol=0)
    assert batched == max(solo_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("method, k, precond", [("pcg", 0, "chebyshev"), ("pipelined_cg", 0, "jacobi"),
                                                ("cacg", 4, None), ("camrr", 4, None)])
def test_batched_pipelined_and_ca_members_equal_solos_on_cuda(cuda, method, k, precond):
    """The pipelined family and the CA loops on a (4, n) block on the card:
    the launches of the longest solo solve, for the whole block, of K1 (one
    a batched SpMV) and of the Chebyshev step (degree - 1 an application:
    pcg applies it once for each K1 launch, so twice as many at degree 3),
    and each member bitwise its solo solve (count, nosl, residual trace,
    x)."""
    from krylov_tpu_torch import precond as pc

    A = fixtures.laplace2d(40, constant=True, device=cuda)
    B = torch.from_numpy(np.random.default_rng(36).standard_normal((4, A.shape[0]))).to(cuda)
    kw = dict(method=method, k=k, tol=1e-8, maxiter=2000)
    if precond:
        kw["M"] = pc.chebyshev(A, degree=3) if precond == "chebyshev" else pc.jacobi(A)
    if method in ("cacg", "camrr"):
        kw["spectral_bounds"] = pc.lanczos_bounds(A)

    def launches():
        return np.array([tracing.totals.stencil_matvec_2d.launches, tracing.totals.chebyshev_apply.launches])

    before = launches()
    res = krylov_tpu_torch.solve_batched(A, B, **kw)
    batched = launches() - before
    solo_launches = []
    for j in range(4):
        before = launches()
        solo = krylov_tpu_torch.solve_device(A, B[j], **kw)
        solo_launches.append(launches() - before)
        m = int(solo.index) + 1
        assert (int(res.iterations[j]), int(res.index[j])) == (int(solo.iterations), int(solo.index))
        assert bool(solo.converged) and bool(res.converged[j])
        assert torch.equal(res.nosl_trace[j, :m], solo.nosl_trace[:m])
        assert torch.equal(res.residual_trace[j, :m], solo.residual_trace[:m])
        assert torch.equal(res.x[j], solo.x)
    longest = max(solo_launches, key=lambda c: c[0])
    assert batched.tolist() == longest.tolist()
    assert batched[1] == (2 * batched[0] if precond == "chebyshev" else 0)


@pytest.mark.cuda
def test_trace_solve_names_the_hand_kernels(cuda, tmp_path):
    """diagnostics.profiling.trace_solve on the card: the trace's kernel
    events name the resident K2 kernel of a cold fused MrR solve, and K1
    beside it for a warm start (x0 shifted through K1)."""
    import glob
    import json

    from krylov_tpu_torch.diagnostics import profiling

    A = fixtures.laplace2d(64, constant=True, device=cuda)
    b = _rhs(A.shape[0], 37, cuda)
    names = []
    for run, x0 in (("cold", None), ("warm", 0.5 * b)):
        d = tmp_path / run
        x, info = profiling.trace_solve(A, b, str(d), method="mrr", tol=1e-8, x0=x0)
        assert info["converged"] and x.device.type == "cuda"
        (path,) = glob.glob(str(d / "*.pt.trace.json"))
        with open(path) as f:
            names.append({e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"})
    assert any("mrr_resident_kernel" in n for n in names[0])
    assert any("mrr_resident_kernel" in n for n in names[1]) and any("stencil2d_kernel" in n for n in names[1])


@pytest.mark.cuda
@pytest.mark.parametrize("method, k", [("cg", 0), ("mrr", 0), ("kskipmrr", 4), ("adaptivekskipmrr", 8),
                                       ("camrr", 4)])
def test_chunked_on_cuda_equals_unbroken(cuda, method, k):
    """solve(chunk_iters=) on the card against the unbroken eager solve:
    equal counts, nosl and khistory, histories rtol 1e-12."""
    A = fixtures.laplace2d(48, constant=True, device=cuda)
    b = np.random.default_rng(35).standard_normal(A.shape[0])
    kw = dict(method=method, k=k, tol=1e-8, maxiter=3000)
    x, info = krylov_tpu_torch.solve(A, b, chunk_iters=40, **kw)
    xu, whole = krylov_tpu_torch.solve(A, b, fused=False, **kw)
    assert info["converged"] and info["chunks"] >= 3 and info["iterations"] == whole["iterations"]
    np.testing.assert_array_equal(info["nosl"], whole["nosl"])
    np.testing.assert_array_equal(info.get("khistory"), whole.get("khistory"))
    np.testing.assert_allclose(info["residual"], whole["residual"], rtol=1e-12, atol=0)
    torch.testing.assert_close(x, xu, rtol=1e-12, atol=0)


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """An NCCL world of one on the card (a file:// store under tmp_path)
    and its rows mesh; the world is destroyed after the test."""
    import torch.distributed as dist

    from krylov_tpu_torch.dist import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["grid", "constant"])
@pytest.mark.parametrize("method, k, precond", [("cg", 0, None), ("mrr", 0, None), ("kskipmrr", 2, None),
                                                ("adaptivekskipmrr", 2, None), ("pcg", 0, "jacobi"),
                                                ("cacg", 4, None)])
def test_sharded_solve_in_nccl_world_of_one_equals_eager(nccl_mesh, monkeypatch, method, k, precond, form):
    """solve(mesh=) in an NCCL world of one against the eager solve on the
    same card: the slab is the whole grid and the sum of one rank is its
    input, so count, traces and x are equal bitwise.  A sharded pcg body
    runs torch's passes (its inner products sum over the group), so the
    eager pcg it is held against runs them too (``pcg_route`` declined)."""
    from krylov_tpu_torch import precond as pc
    from krylov_tpu_torch.solvers import pipelined

    monkeypatch.setattr(pipelined, "pcg_route", lambda *args: False)

    A = fixtures.laplace2d(32, constant=form == "constant", device="cuda")
    b = np.random.default_rng(14).standard_normal(A.shape[0])
    kw = dict(method=method, k=k, tol=1e-9, maxiter=2000)
    if precond:
        kw["M"] = pc.jacobi(A)
    if method == "cacg":
        kw["spectral_bounds"] = pc.lanczos_bounds(A)
    x_e, i_e = krylov_tpu_torch.solve(A, b, fused=False, **kw)
    x_s, i_s = krylov_tpu_torch.solve(A, b, mesh=nccl_mesh, **kw)
    assert i_s["converged"] and i_s["iterations"] == i_e["iterations"]
    for key in ("nosl", "residual", "khistory"):
        if key in i_e:
            np.testing.assert_array_equal(i_s[key], i_e[key])
    assert x_s.device.type == "cuda" and torch.equal(x_s, x_e)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_sharded_stencil_matvec_launches_k1(cuda, nccl_mesh, name):
    """The sharded stencil SpMV of a world of one is one K1 launch on the
    slab (the whole grid), equal to the operator's own K1 product."""
    from krylov_tpu_torch.context import Context
    from krylov_tpu_torch.dist import shard_operator

    A = OPERATORS[name](device="cuda")
    op = shard_operator(A, nccl_mesh)
    ctx = Context(axis="rows", group=nccl_mesh.get_group())
    x = _rhs(A.shape[0], 16, cuda)
    before = tracing.totals.stencil_matvec_2d.launches
    y = op.matvec(x, ctx)
    assert tracing.totals.stencil_matvec_2d.launches == before + 1 and op.strategy == "halo"
    assert y.device.type == "cuda" and torch.equal(y, stencil.stencil_matvec(A, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_sharded_stencil_boundary_planes_on_card(cuda, name, dtype):
    """The 2-rank split of the sharded stencil SpMV without a world: each
    rank's bulk (K1 on its slab) and boundary planes (K1 on the extended
    slabs, from the true halo planes) against the whole grid's K1, bitwise
    (each point sums its terms in stencil order in both)."""
    from krylov_tpu_torch.dist.spmv import ShardedOperator, local_block, partition, stencil_boundary, stencil_bulk

    A = OPERATORS[name](dtype=dtype, device=cuda)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal((2, A.shape[0]))).to(cuda, dtype)
    want = stencil.stencil_matvec(A, x)
    P = 2
    kind, arrays, offsets, strategy, grid = partition(A, P)
    n = A.shape[0] // P
    before = tracing.totals.stencil_matvec_2d.launches
    for rank in range(P):
        op = ShardedOperator(kind=kind, arrays=local_block(kind, arrays, P, rank), offsets=offsets, shape=A.shape,
                             n_devices=P, strategy=strategy, rank=rank, grid=grid)
        plane, s0 = op.aux["plane"], rank * n
        x_l = x[:, s0: s0 + n].contiguous()
        top = x[:, s0 - plane: s0].contiguous() if rank > 0 else None
        bottom = x[:, s0 + n: s0 + n + plane].contiguous() if rank < P - 1 else None
        assert torch.equal(stencil_boundary(op, x_l, stencil_bulk(op, x_l), top, bottom), want[:, s0: s0 + n])
    assert tracing.totals.stencil_matvec_2d.launches == before + P + 2 * (P - 1)


# K4, the resident stencil pass: systems whose resident plans cover the
# specialisations and the band shapes (the main-path plan, 132 bands of 3
# or 4 rows at 4 points a thread; the collapsed 3-D grids at 1 and 8 points
# a thread; an uneven split whose bands differ in rows)
K4_CASES = {
    "laplace2d(500)": lambda **kw: fixtures.laplace2d(500, constant=True, **kw),
    "laplace3d(16)": lambda **kw: fixtures.laplace3d(16, constant=True, **kw),
    "laplace3d(64)": lambda **kw: fixtures.laplace3d(64, constant=True, **kw),
    "laplace2d(503, 493)": lambda **kw: fixtures.laplace2d(503, 493, constant=True, **kw),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(K4_CASES))
def test_k4_specialised_pass_equals_masked_pass(cuda, name, dtype, rtol):
    """The pass specialised on the term count (5 for the 2-D stencil, 7 for
    the collapsed 3-D one), in its predicated and its split form, gives the
    bits of the masked pass (NS = 0) on the same mirror, over several
    passes; all hold the plain stencil to K1's tolerance."""
    A = K4_CASES[name](dtype=dtype, device=cuda)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    ns = fused.pass_terms(stencil2, True)
    assert ns == (7 if name.startswith("laplace3d") else 5)
    x = _rhs(A.shape[0], 18, cuda, dtype)
    kw = dict(stencil=stencil2, grid=grid2, sub=sub, reps=3)
    y0, sums0, _ = fused.stencil_pass_probe(coef2, x, ns_pass=0, **kw)
    for split in (False, True):
        y, sums, cycles = fused.stencil_pass_probe(coef2, x, ns_pass=ns, split=split, **kw)
        assert torch.equal(y, y0) and torch.equal(sums, sums0)
        assert bool((cycles > 0).all())
    y_ref = stencil.stencil_matvec_2d_reference(coef2, x, stencil=stencil2, grid=grid2, sub=sub)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=rtol * float(y_ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name, ns", [("2d", 0), ("2d-const", 5), ("3d-const", 7)])
@pytest.mark.parametrize("method", ["cg", "mrr", "kskipcg", "kskipmrr"])
def test_resident_launches_count_k4_specialisation(cuda, method, name, ns):
    """Each resident launch counts under the specialisation its launcher
    picked from the geometry, and the solve keeps the masked pass's
    bits."""
    A = OPERATORS[name](device=cuda)
    b = _rhs(A.shape[0], 19, cuda)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    kw = dict(stencil=stencil2, grid=grid2, maxiter=A.shape[0], sub=sub)
    if method.startswith("kskip"):
        fn = getattr(fused_kskip, f"fused_{method}_solve_2d")
        args = (coef2, b, 1e-8, torch.linalg.vector_norm(b), 2)
        kw["k_max"] = 2
    else:
        fn = KERNEL[method]
        args = (coef2, b, 1e-8, torch.linalg.vector_norm(b))
    before = dict(vars(_launched(fn)))
    fn(*args, **kw)
    after = {name_: v - before[name_] for name_, v in vars(_launched(fn)).items()}
    assert after == {**dict.fromkeys(before, 0), "launches": 1, "resident": 1, f"resident_ns{ns}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "mrr", "kskipmrr", "chronopoulos_gear"])
def test_degenerate_systems_on_cuda(cuda, method):
    """b = 0 launches no fused kernel and returns zeros on the card; an
    exact warm start returns x0 bitwise."""
    A = fixtures.laplace2d(24, constant=True, device=cuda)
    x0 = _rhs(A.shape[0], 20, cuda)
    k = 4 if method == "kskipmrr" else 0
    fns = (fused.fused_cg_solve_2d, fused.fused_mrr_solve_2d, fused_kskip.fused_kskipmrr_solve_2d)
    before = [_launched(fn).launches for fn in fns]
    x, info = krylov_tpu_torch.solve(A, torch.zeros_like(x0), method=method, x0=x0, k=k)
    assert [_launched(fn).launches for fn in fns] == before
    assert x.is_cuda and bool((x == 0).all()) and info["converged"] and info["iterations"] == 0
    x, info = krylov_tpu_torch.solve(A, A.matvec(x0), method=method, x0=x0, k=k)
    assert torch.equal(x, x0) and info["converged"] and info["iterations"] <= 1


# The eager loops on their block runner (solvers._common.run_bodies): on
# the card a key's first block warms up, and the full blocks after it
# replay one captured CUDA graph where two are left, or one and the key has
# come back.  The graph route launches the eager route's
# kernels in the eager route's order, so the two are held equal bit for bit
# (the float bits compared as integers, so that a NaN equals itself); the
# eager route is the runner with its rule declined.
GRAPH_LOOPS = {
    "cg": (krylov_tpu_torch.solvers.cg_kernel, lambda A: {}),
    "mrr": (krylov_tpu_torch.solvers.mrr_kernel, lambda A: {}),
    "kskipcg k=1": (krylov_tpu_torch.solvers.kskipcg_kernel, lambda A: {"k": 1}),
    "kskipmrr k=1": (krylov_tpu_torch.solvers.kskipmrr_kernel, lambda A: {"k": 1}),
    "pcg": (krylov_tpu_torch.solvers.pcg_kernel, lambda A: {}),
    "pcg jacobi": (krylov_tpu_torch.solvers.pcg_kernel, lambda A: {"M": pc.jacobi(A)}),
    "pcg chebyshev(6)": (krylov_tpu_torch.solvers.pcg_kernel, lambda A: {"M": pc.chebyshev(A, 6)}),
    "chronopoulos_gear jacobi": (krylov_tpu_torch.solvers.chronopoulos_gear_kernel,
                                 lambda A: {"M": pc.jacobi(A)}),
    "gropp jacobi": (krylov_tpu_torch.solvers.gropp_kernel, lambda A: {"M": pc.jacobi(A)}),
}
GRAPH_CARRIES = ("cg", "mrr", "kskipcg k=1", "kskipmrr k=1")


def _graph_counts() -> tuple:
    """(bodies, host reads, K1 launches, captures, replays, bodies in
    replays, the Chebyshev step's launches)."""
    g = tracing.totals.eager_graph
    return (tracing.totals.eager_bodies.calls, tracing.totals.host_read.calls, tracing.totals.stencil_matvec_2d.launches,
            g.captures, g.replays, g.bodies, tracing.totals.chebyshev_apply.launches)


def _since(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_graph_counts(), before))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()]) if t.is_floating_point() else t


def _same_bits(a, b):
    last = int(a.index.max())
    pairs = [(a.x, b.x), (a.iterations, b.iterations), (a.index, b.index), (a.converged, b.converged),
             (a.residual_trace[..., : last + 1], b.residual_trace[..., : last + 1])]
    pairs += list(zip(a.carry, b.carry)) if a.carry is not None else []
    for u, v in pairs:
        assert torch.equal(_bits(u), _bits(v))


@pytest.fixture
def graph_blocks(cuda, monkeypatch):
    """An empty cache of captured blocks for the test (freed after it)."""
    import collections

    from krylov_tpu_torch.solvers import _common

    blocks = collections.OrderedDict()
    monkeypatch.setattr(_common, "_BLOCKS", blocks)
    return blocks


def _graph_batch(A, seed, batch):
    """``batch`` standard normal right-hand sides; with a batch, member 1
    an eigenvector of the Laplacian, which converges inside the first block
    and freezes while the others run."""
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    if batch is None:
        return torch.from_numpy(rng.standard_normal(n)).to(A.coef.device, A.dtype)
    B = rng.standard_normal((batch, n))
    g = int(round(n**0.5))
    s = np.sin(np.pi * np.arange(1, g + 1) / (g + 1))
    B[1] = np.outer(s, s).reshape(-1)
    return torch.from_numpy(B).to(A.coef.device, A.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("tol, maxiter", [("tight", 400), (0.0, 154)], ids=["converging", "tail"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(GRAPH_LOOPS))
def test_graph_route_equals_eager_route(graph_blocks, monkeypatch, name, dtype, tol, maxiter, batch):
    """Each of the seven loops, solo and as a batch of 4, f64 and f32, on
    ``laplace2d(24)``: three requests on one key with different ``b`` (the
    first warms up and captures, or the second where the first leaves one
    block after its warm-up; the last replays from its start) against the
    eager route, bit for bit, with equal bodies, host reads and K1
    launches (and the Chebyshev step's); one capture in all.  ``tol = 0``
    runs all 154 steps (77
    outer iterations at k = 1): full blocks, then an eager tail.  The first
    result is untouched by the later requests."""
    from krylov_tpu_torch.solvers import _common

    A = fixtures.laplace2d(24, constant=True, dtype=dtype, device="cuda")
    fn, extra = GRAPH_LOOPS[name]
    kw = dict(extra(A), tol={torch.float64: 1e-12, torch.float32: 1e-6}[dtype] if tol == "tight" else tol,
              maxiter=maxiter)
    if name in GRAPH_CARRIES:
        kw["emit_carry"] = True
    bs = [_graph_batch(A, seed, batch) for seed in (41, 42, 46)]
    A.matvec(bs[0])  # K1's weights are read once an operator, before the counts
    before = _graph_counts()
    graph = [fn(A, b, torch.zeros_like(b), **kw) for b in bs]
    on_graph = _since(before)
    first_x = graph[0].x.clone()
    with monkeypatch.context() as m:
        m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
        before = _graph_counts()
        eager = [fn(A, b, torch.zeros_like(b), **kw) for b in bs]
        on_eager = _since(before)
    for g, e in zip(graph, eager):
        _same_bits(g, e)
    assert torch.equal(graph[0].x, first_x) and len({g.x.data_ptr() for g in graph}) == 3
    assert on_graph[:3] + on_graph[6:] == on_eager[:3] + on_eager[6:] and on_eager[3:6] == (0, 0, 0)
    if on_graph[3]:
        assert on_graph[3] == 1 and on_graph[4] >= 2 and on_graph[5] == 32 * on_graph[4]
    else:  # converged at the warm-up's read in each request: nothing to replay
        assert tol == "tight" and on_eager[0] <= len(bs) * 32


@pytest.mark.cuda
def test_graph_route_engages_on_the_pcg_cell_system(graph_blocks):
    """The benchmark's host-bound system at a tenth of its grid (pcg,
    Chebyshev(6), f64): after the first request every full block replays;
    a later request's bodies all run in replays but its tail.  K1 launches
    once a body (``A p``) and for the start's residual; each of those
    bodies and the start applies M in 5 launches of the Chebyshev step."""
    A = fixtures.laplace2d(158, constant=True, device="cuda")
    M = pc.chebyshev(A, 6)
    for seed in (1, 2):
        b = _rhs(A.shape[0], seed, "cuda")
        before = _graph_counts()
        res = krylov_tpu_torch.solve_device(A, b, method="pcg", M=M, tol=1e-5, maxiter=3000)
        got = _since(before)
    assert bool(res.converged) and got[3] == 0 and got[5] == 32 * got[4] >= got[0] - 31
    assert got[2] == got[0] + 1 and got[6] == 5 * got[2]


@pytest.mark.cuda
def test_graph_route_new_operator_is_captured_anew(graph_blocks, monkeypatch):
    """A new operator object of the same shape and coefficients doubled in
    place, each a new key: neither replays another's graph, and each result
    equals the eager route's on its own operator."""
    from krylov_tpu_torch.solvers import _common

    b = _graph_batch(fixtures.laplace2d(24, constant=True, device="cuda"), 43, None)
    A1 = fixtures.laplace2d(24, constant=True, device="cuda")
    kw = dict(tol=0.0, maxiter=96)
    krylov_tpu_torch.solvers.cg_kernel(A1, b, torch.zeros_like(b), **kw)
    A2 = fixtures.laplace2d(24, constant=True, device="cuda")
    A2.coef.mul_(2.0)
    A1.coef.mul_(2.0)
    for A in (A2, A1):
        before = _graph_counts()
        got = krylov_tpu_torch.solvers.cg_kernel(A, b, torch.zeros_like(b), **kw)
        assert _since(before)[3] == 1
        with monkeypatch.context() as m:
            m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
            want = krylov_tpu_torch.solvers.cg_kernel(A, b, torch.zeros_like(b), **kw)
        _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method, k", [("cg", 0), ("mrr", 0), ("kskipmrr", 1)])
def test_graph_route_chunked_solve_equals_eager(graph_blocks, monkeypatch, method, k):
    """solve(chunk_iters=) on the card: each chunk of 150 steps replays the
    key's graph from the carry, bit for bit the eager route's chunks."""
    from krylov_tpu_torch.solvers import _common

    A = fixtures.laplace2d(48, constant=True, device="cuda")
    b = np.random.default_rng(44).standard_normal(A.shape[0])
    kw = dict(method=method, k=k, tol=1e-12, maxiter=3000, chunk_iters=150)
    x, info = krylov_tpu_torch.solve(A, b, **kw)
    with monkeypatch.context() as m:
        m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
        x_e, info_e = krylov_tpu_torch.solve(A, b, **kw)
    assert info["converged"] and info["chunks"] == info_e["chunks"] >= 2
    assert info["iterations"] == info_e["iterations"]
    np.testing.assert_array_equal(info["residual"], info_e["residual"])
    assert torch.equal(x, x_e) and len(graph_blocks) == 1


@pytest.mark.cuda
def test_graph_route_on_a_hyb_operator(graph_blocks, monkeypatch):
    """A non-stencil operator (HYB: gathers and a sorted scatter-add) takes
    the graph route too, bit for bit the eager route."""
    from krylov_tpu_torch.solvers import _common

    A = to_device(convert.to_hyb(fixtures.powerlaw_spd(3000, seed=4, diag_scale_decades=0.5), device="cpu"),
                  torch.device("cuda"))
    b = torch.from_numpy(np.random.default_rng(45).standard_normal(A.shape[0])).to("cuda")
    got = [krylov_tpu_torch.solvers.cg_kernel(A, b * s, torch.zeros_like(b), tol=0.0, maxiter=96) for s in (1, 2)]
    with monkeypatch.context() as m:
        m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
        want = [krylov_tpu_torch.solvers.cg_kernel(A, b * s, torch.zeros_like(b), tol=0.0, maxiter=96)
                for s in (1, 2)]
    for g, e in zip(got, want):
        _same_bits(g, e)
    assert len(graph_blocks) == 1


@pytest.mark.cuda
def test_graph_replays_show_in_the_profilers_trace(graph_blocks):
    """Under torch.profiler a replayed block's kernels are kernel records:
    K1's records equal the move of its launch counter in a request that
    captures (its warm-up launches, its capture records and launches
    nothing, its replays launch) and in one that replays every block."""
    from torch.profiler import ProfilerActivity, profile

    A = fixtures.laplace2d(64, constant=True, device="cuda")
    kw = dict(method="pcg", tol=0.0, maxiter=96)
    A.matvec(_rhs(A.shape[0], 1, "cuda"))  # K1's weights are read once an operator
    for seed, want in ((1, (1, 2)), (2, (0, 3))):
        b = _rhs(A.shape[0], seed, "cuda")
        torch.cuda.synchronize()
        before, recorded = _graph_counts(), tracing.recorded.stencil_matvec_2d.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            krylov_tpu_torch.solve_device(A, b, **kw)
            torch.cuda.synchronize()
        got = _since(before)
        assert got[3:5] == want
        assert tracing.recorded.stencil_matvec_2d.launches - recorded == 32 * want[0]
        k1 = sum(e.count for e in prof.key_averages() if "stencil2d_kernel" in e.key)
        assert k1 == got[2] == 96 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["pcg", "adaptivekskipmrr"])
@pytest.mark.parametrize("streams", ["two streams", "one stream"])
def test_graph_route_threads_on_one_key(graph_blocks, monkeypatch, streams, loop):
    """Two threads solve on one operator at once, each on a stream of its
    own or both on one: every result is bit for bit the eager route's for
    its ``b``, so no request reads static state that another overwrites
    (pcg's blocks of bodies; the adaptive loop's steps, whose request
    carries its state from one replayed step to the next).  Each stream
    has its own keys; on one stream a request whose block the other thread
    holds runs eagerly."""
    import threading

    from krylov_tpu_torch.solvers import _common

    A = fixtures.laplace2d(48, constant=True, device="cuda")
    if loop == "pcg":
        run, route, same = krylov_tpu_torch.solvers.pcg_kernel, "graph_route", _same_bits
        kw, eager = dict(M=pc.chebyshev(A, 6), tol=0.0, maxiter=160), lambda ctx, state, steps: False
    else:
        run, route, same = krylov_tpu_torch.solvers.adaptivekskipmrr_kernel, "step_route", _same_adaptive_bits
        kw, eager = dict(k=4, tol=1e-10, maxiter=400), lambda state: False
    bs = [_graph_batch(A, seed, None) for seed in range(50, 58)]
    with monkeypatch.context() as m:
        m.setattr(_common, route, eager)
        want = [run(A, b, torch.zeros_like(b), **kw) for b in bs]
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    if streams == "one stream":
        side[1] = side[0]
    torch.cuda.synchronize()
    got, errors, start = {}, [], threading.Barrier(2)

    def client(t):
        try:
            with torch.cuda.stream(side[t]):
                start.wait()
                for j in range(t, len(bs), 2):
                    got[j] = run(A, bs[j], torch.zeros_like(bs[j]), **kw)
                torch.cuda.current_stream().synchronize()
        except BaseException as e:  # noqa: BLE001 - handed to the test's thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for j, w in enumerate(want):
        same(got[j], w)
    streams_used = {key[2] for key in graph_blocks}
    assert len(streams_used) == (2 if streams == "two streams" else 1)
    if loop == "pcg":  # one body, so one key a stream
        assert len(graph_blocks) == len(streams_used)


@pytest.mark.cuda
def test_graph_route_declines_a_user_operator(graph_blocks, monkeypatch):
    """A user's preconditioner, duck-typed, whose ``matvec`` reads the card
    on the host (a capture would refuse it) and whose scale may change
    between requests: the loop takes no key and runs eagerly, bit for bit
    the eager route."""
    from krylov_tpu_torch.solvers import _common

    class Scaled:
        shape = None

        def __init__(self):
            self.scale = 0.25

        def matvec(self, v):
            return v * (self.scale / max(float(v.abs().max()), 1.0))

    A = fixtures.laplace2d(24, constant=True, device="cuda")
    M = Scaled()
    b = _graph_batch(A, 47, None)
    before, got = _graph_counts(), []
    for scale in (0.25, 0.5):
        M.scale = scale
        got.append(krylov_tpu_torch.solvers.pcg_kernel(A, b, torch.zeros_like(b), M=M, tol=0.0, maxiter=96))
    assert _since(before)[3:6] == (0, 0, 0) and len(graph_blocks) == 0
    with monkeypatch.context() as m:
        m.setattr(_common, "graph_route", lambda ctx, state, steps: False)
        for scale, g in zip((0.25, 0.5), got):
            M.scale = scale
            _same_bits(g, krylov_tpu_torch.solvers.pcg_kernel(A, b, torch.zeros_like(b), M=M, tol=0.0, maxiter=96))


# The Chebyshev step (kernels.stencil.chebyshev_apply): a degree-d
# Chebyshev application on a stencil operator in d - 1 launches (one at
# degree 1), held bit for bit against the loop it replaces, which runs
# where precond.fused_route declines.
CHEB_SYSTEMS = {
    "2d": lambda dt: fixtures.laplace2d(24, 19, dtype=dt, device="cuda"),
    "2d-const": lambda dt: fixtures.laplace2d(24, 19, constant=True, dtype=dt, device="cuda"),
    "3d-const": lambda dt: fixtures.laplace3d(10, 9, 8, constant=True, dtype=dt, device="cuda"),
}


def _cheb_counts() -> tuple:
    """(applications, fused ones, recorded ones, recorded fused ones, the
    Chebyshev step's launches, its recorded launches, K1 launches)."""
    a, r = tracing.totals, tracing.recorded
    return (a.cheb_apply.calls, a.cheb_apply.fused, r.cheb_apply.calls, r.cheb_apply.fused,
            a.chebyshev_apply.launches, r.chebyshev_apply.launches, a.stencil_matvec_2d.launches)


def _cheb_since(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_cheb_counts(), before))


# Spectral intervals of the Chebyshev tests: centres with an inexact
# reciprocal; at the second (main-path Lanczos bounds in float32) the
# float32 reciprocal of float32 theta is not the float64 one rounded, which
# torch's division by a host number multiplies by
CHEB_INTERVALS = {"theta3.975": (0.05, 7.9), "theta4.198": (0.04192084707327978, 8.354414499755384)}


@pytest.mark.cuda
@pytest.mark.parametrize("interval", sorted(CHEB_INTERVALS))
@pytest.mark.parametrize("run", ["eager", "graph"])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(CHEB_SYSTEMS))
def test_chebyshev_step_equals_the_loop(cuda, monkeypatch, name, dtype, degree, batch, run, interval):
    """A Chebyshev application on the card through the Chebyshev step
    equals the loop's, bit for bit and signs of zeros included (``v`` has
    negative zeros), for a vector and a (3, n) block, launched eagerly or
    captured into a CUDA graph and replayed on two inputs, on each of
    CHEB_INTERVALS; ``v`` is left as it was.  Eagerly an application
    counts as fused and launches max(d - 1, 1) kernels and no K1;
    captured, the same counts land in the recorded counters."""
    from krylov_tpu_torch.context import Context

    A = CHEB_SYSTEMS[name](dtype)
    M = pc.ChebyshevPreconditioner(A, *CHEB_INTERVALS[interval], degree)
    rng = np.random.default_rng(12)
    vs = []
    for _ in range(2):
        v = torch.from_numpy(rng.standard_normal((batch or 1, A.shape[0]))).to(cuda, dtype)
        v[:, :4] = -0.0
        vs.append(v if batch else v[0].clone())
    kept = [v.clone() for v in vs]
    with monkeypatch.context() as m:
        m.setattr(pc, "fused_route", lambda A, v, ctx: False)
        want = [M.matvec(v, Context()) for v in vs]
    A.matvec(vs[0])  # K1's weights are read once an operator
    steps = max(degree - 1, 1)
    before = _cheb_counts()
    if run == "eager":
        got = [M.matvec(v, Context()) for v in vs]
        assert _cheb_since(before) == (2, 2, 0, 0, 2 * steps, 0, 0)
    else:
        static = vs[0].clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            M.matvec(static, Context())  # torch's warm-up before a capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = M.matvec(static, Context())
        assert _cheb_since(before) == (1, 1, 1, 1, steps, steps, 0)
        got = []
        for v in vs:
            static.copy_(v)
            graph.replay()
            got.append(out.clone())
    torch.cuda.synchronize()
    for g, w, v, k in zip(got, want, vs, kept):
        assert torch.equal(_bits(g), _bits(w)) and torch.equal(_bits(v), _bits(k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["pcg", "chronopoulos_gear", "gropp"])
def test_chebyshev_solves_equal_the_unfused_route(cuda, graph_blocks, monkeypatch, method, dtype):
    """pcg, Chronopoulos–Gear and Gropp with ``chebyshev(A, 6)`` through
    solve_device on the card, two requests on one operator (the first
    captures, the second replays), against the same requests with the
    fused route declined: the same x, counts and residual traces, bit for
    bit; every application fused, those in replays counted too."""
    A = fixtures.laplace2d(160, constant=True, dtype=dtype, device=cuda)  # 60-110 iterations
    M = pc.chebyshev(A, 6)
    kw = dict(method=method, M=M, tol={torch.float64: 1e-10, torch.float32: 1e-5}[dtype], maxiter=2000)
    bs = [_rhs(A.shape[0], seed, cuda, dtype) for seed in (61, 62)]
    before, graphs = _cheb_counts(), _graph_counts()
    got = [krylov_tpu_torch.solve_device(A, b, **kw) for b in bs]
    moved, replays = _cheb_since(before), _since(graphs)[4]
    graph_blocks.clear()  # the unfused route captures its own graph
    with monkeypatch.context() as m:
        m.setattr(pc, "fused_route", lambda A, v, ctx: False)
        before = _cheb_counts()
        want = [krylov_tpu_torch.solve_device(A, b, **kw) for b in bs]
        unfused = _cheb_since(before)
    for g, w in zip(got, want):
        assert bool(g.converged)
        _same_bits(g, w)
    assert replays >= 2 and moved[0] == moved[1] == unfused[0] > 0 and unfused[1] == 0
    assert moved[4] == 5 * moved[0] and unfused[4] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dia", "ell", "cpu"])
def test_chebyshev_step_declines_other_operators(cuda, form):
    """A DIA or ELL operator on the card, or a stencil and vector on the
    CPU: the application runs the loop, counted as a call and not fused,
    with no launch of the Chebyshev step."""
    from krylov_tpu_torch.context import Context

    if form == "dia":
        A = fixtures.laplace2d(24, device=cuda).to_dia()
    elif form == "ell":
        A = convert.to_ell(fixtures.powerlaw_spd(600, seed=2), device=cuda)
    else:
        A = fixtures.laplace2d(24, device="cpu")
    M = pc.ChebyshevPreconditioner(A, 0.1, 8.0, 3)
    v = torch.from_numpy(np.random.default_rng(13).standard_normal(A.shape[0])).to(A.device, A.dtype)
    assert not pc.fused_route(A, v, Context())
    before = _cheb_counts()
    M.matvec(v, Context())
    assert _cheb_since(before)[:6] == (1, 0, 0, 0, 0, 0)


@pytest.mark.cuda
def test_chebyshev_step_records_match_its_counter(graph_blocks):
    """Under torch.profiler, pcg with Chebyshev(6) in a request that
    captures and one that replays every block: the Chebyshev step's kernel
    records equal the move of its launch counter (5 an application), and
    K1's records its counter's (1 a body and the start's)."""
    from torch.profiler import ProfilerActivity, profile

    A = fixtures.laplace2d(64, constant=True, device="cuda")
    M = pc.chebyshev(A, 6)
    kw = dict(method="pcg", M=M, tol=0.0, maxiter=96)
    A.matvec(_rhs(A.shape[0], 1, "cuda"))  # K1's weights are read once an operator
    for seed, want in ((1, (1, 2)), (2, (0, 3))):
        b = _rhs(A.shape[0], seed, "cuda")
        torch.cuda.synchronize()
        before = _graph_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            krylov_tpu_torch.solve_device(A, b, **kw)
            torch.cuda.synchronize()
        got = _since(before)
        assert got[3:5] == want
        records = {name: sum(e.count for e in prof.key_averages() if name in e.key)
                   for name in ("stencil2d_kernel", "cheb_step2d_kernel")}
        assert records == {"stencil2d_kernel": got[2], "cheb_step2d_kernel": got[6]}
        assert got[2] == 96 + 1 and got[6] == 5 * got[2]


# pcg's body on the four kernels of kernels.pcg (csrc/pcg.cu), where
# solvers.pipelined.pcg_route takes the solve, against the same body on
# torch's passes (the route declined).  The updates round as torch's do, so
# for given scalars they are bitwise; the inner products sum in the
# kernels' fixed order, so whole solves are held as the fused K2/K3 are
# (ROUTE_TOLS), with counts within one.
PCG_MS = {"none": lambda A: None, "jacobi": pc.jacobi, "chebyshev(6)": lambda A: pc.chebyshev(A, 6)}
PCG_KERNELS = ("pcg_alpha_kernel", "pcg_xr_kernel", "pcg_ru_kernel", "pcg_p_kernel")


def _pcg_counts() -> tuple:
    g = tracing.totals.pcg_body
    return g.calls, g.fused


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("precond", sorted(PCG_MS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_body_kernels_match_the_torch_body(graph_blocks, monkeypatch, dtype, precond, batch):
    """pcg on ``laplace2d(48)`` (with a batch, member 1 converges in the
    first block and freezes) on the kernels against torch's passes: counts
    within one, traces and x within ROUTE_TOLS, every body counted as
    fused on the kernels and none on torch's passes."""
    from krylov_tpu_torch.solvers import pipelined

    A = fixtures.laplace2d(48, constant=True, dtype=dtype, device="cuda")
    M = PCG_MS[precond](A)
    b = _graph_batch(A, 71, batch)
    kw = dict(M=M, tol=1e-10 if dtype == torch.float64 else 1e-5, maxiter=800)
    assert pipelined.pcg_route(Context(), b, torch.zeros_like(b), kw["tol"])
    before = _pcg_counts()
    got = pipelined.pcg_kernel(A, b, torch.zeros_like(b), **kw)
    calls, on_kernels = (a - c for a, c in zip(_pcg_counts(), before))
    graph_blocks.clear()
    with monkeypatch.context() as m:
        m.setattr(pipelined, "pcg_route", lambda *args: False)
        before = _pcg_counts()
        want = pipelined.pcg_kernel(A, b, torch.zeros_like(b), **kw)
        torch_calls, torch_fused = (a - c for a, c in zip(_pcg_counts(), before))
    assert calls == on_kernels > 0 and torch_calls > 0 and torch_fused == 0
    assert bool(got.converged.all()) and bool(want.converged.all())
    assert int((got.iterations - want.iterations).abs().max()) <= 1
    trace_rtol, x_rtol, x_atol = ROUTE_TOLS[dtype]
    rows = batch or 1
    for j in range(rows):
        m = min(int(r.index.reshape(-1)[j]) for r in (got, want)) + 1
        g, w = (r.residual_trace.reshape(rows, -1)[j, :m] for r in (got, want))
        torch.testing.assert_close(g, w, rtol=trace_rtol, atol=1e-14)
    torch.testing.assert_close(got.x, want.x, rtol=x_rtol, atol=x_atol)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_kernels_update_as_torch_does(cuda, dtype, batch):
    """The four kernels on given scalars, n = 300,001 (more points than
    the grid has threads): step_xr's x and r and step_p's p are torch's
    scale-plus-add bit for bit where a member has not converged and the
    old bits where it has (member 1 of a batch); the kept rr and ru are
    the old bits, the others and beta the inner products within rounding
    (beta 0 where the member has converged, which no step reads);
    step_alpha writes torch's ``sqrt(rr) / |b|`` at ``i`` alone, its
    ``conv`` and ``i + !conv``, and ``alpha`` is 0 where ``<s, p>`` is
    (member 2's ``s`` is 0)."""
    from krylov_tpu_torch.kernels import pcg
    from krylov_tpu_torch.solvers._common import bcast, safe_div, scale

    n, rows = 300_001, batch or 1
    rng = np.random.default_rng(72)

    def vec():
        v = torch.from_numpy(rng.standard_normal((rows, n))).to(cuda, dtype)
        return v if batch else v[0]

    def scalars(*values):
        t = torch.tensor(values[:rows], dtype=dtype, device=cuda)
        return t if batch else t[0]

    x, p, r, s, u, bvec = (vec() for _ in range(6))
    if batch:
        s[2] = 0.0
    conv = torch.tensor([False, True, False][:rows], device=cuda)
    conv = conv if batch else conv[0]
    alpha, beta = scalars(0.37, -1.25, 0.61), scalars(-0.73, 0.5, 2.3)
    rr, ru = scalars(3.5, 0.25, 7.0), scalars(1.5, -2.0, 0.75)
    work = pcg.scratch(x)

    def kept(new, old):
        return torch.where(bcast(conv, new), old, new)

    ctx = Context()
    x_n, r_n, rr_n = pcg.step_xr(ctx, x, p, r, s, alpha, conv, rr, work)
    assert torch.equal(_bits(x_n), _bits(kept(x + scale(alpha, p), x)))
    assert torch.equal(_bits(r_n), _bits(kept(r - scale(alpha, s), r)))
    ru_n, beta_n = pcg.step_ru(ctx, r_n, u, ru, conv, work)
    p_n = pcg.step_p(u, p, beta, conv, work)
    assert torch.equal(_bits(p_n), _bits(kept(u + scale(beta, p), p)))
    rel = 1e-12 if dtype == torch.float64 else 1e-5

    def near(got, want, size):
        """``got`` within ``rel`` of ``size`` (a sum of magnitudes) of ``want``."""
        assert bool(((got.double() - want).abs() <= rel * size).all()), (got, want)

    def dot(a, c):
        return (a.double() * c.double()).sum(-1), (a.double() * c.double()).abs().sum(-1)

    (rr_w, rr_size), (ru_w, ru_size) = dot(r_n, r_n), dot(r_n, u)
    near(rr_n, torch.where(conv, rr.double(), rr_w), rr_size)
    near(ru_n, torch.where(conv, ru.double(), ru_w), ru_size)
    live = ~conv  # beta is read where a member has not converged; the kernel writes 0 where it has
    near(beta_n[live], (ru_w / ru.double())[live], (ru_size / ru.double().abs())[live])
    assert bool((beta_n[conv] == 0).all())
    for got, old in ((rr_n, rr), (ru_n, ru)):
        assert torch.equal(_bits(got[conv]), _bits(old[conv]))

    trace = torch.full((rows, 9), -1.0, dtype=dtype, device=cuda)
    trace = trace if batch else trace[0]
    i = torch.tensor([3, 5, 0][:rows], device=cuda)
    i = i if batch else i[0]
    b_norm = torch.linalg.vector_norm(bvec, dim=-1)
    tol = 1.1 * float((torch.sqrt(rr) / b_norm).reshape(-1)[0])  # member 0 converges
    conv_n, alpha_n, i_n = pcg.step_alpha(ctx, s, p, rr, b_norm, ru, tol, trace, i, work)
    res = torch.sqrt(rr) / b_norm
    want_trace = torch.full_like(trace, -1.0)
    want_trace.scatter_(-1, i.unsqueeze(-1), res.unsqueeze(-1))
    assert torch.equal(_bits(trace), _bits(want_trace))
    assert torch.equal(conv_n, res < tol) and torch.equal(i_n, i + (~(res < tol)).long())
    sp, sp_size = dot(s, p)
    near(alpha_n, safe_div(ru.double(), sp), torch.where(sp != 0, ru.double().abs() * sp_size / sp**2, 0.0))
    if batch:
        assert float(alpha_n[2]) == 0.0
    assert bool((work.view(-1)[-rows:] == 0).all())  # the tickets are back at 0


@pytest.mark.cuda
@pytest.mark.parametrize("precond", sorted(PCG_MS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_body_batch_members_equal_their_solo_solves(graph_blocks, dtype, precond):
    """pcg on the kernels on a (3, n) block (member 1 converges in the
    first block): each member's count, residual trace and x are its solo
    solve's bit for bit."""
    from krylov_tpu_torch.solvers import pcg_kernel

    A = fixtures.laplace2d(40, constant=True, dtype=dtype, device="cuda")
    M = PCG_MS[precond](A)
    B = _graph_batch(A, 73, 3)
    kw = dict(M=M, tol=1e-10 if dtype == torch.float64 else 1e-5, maxiter=600)
    res = pcg_kernel(A, B, torch.zeros_like(B), **kw)
    for j in range(3):
        solo = pcg_kernel(A, B[j].clone(), torch.zeros_like(B[j]), **kw)
        m = int(solo.index) + 1
        assert int(res.iterations[j]) == int(solo.iterations) and bool(solo.converged)
        assert torch.equal(_bits(res.residual_trace[j, :m]), _bits(solo.residual_trace[:m]))
        assert torch.equal(_bits(res.x[j]), _bits(solo.x))


@pytest.mark.cuda
def test_pcg_body_takes_a_tol_on_the_card(cuda, monkeypatch):
    """``restarts=1``: the defect's inner solve gets its tol as a 0-d
    tensor on the card, which the kernels read there; the solve converges
    as the torch body's does, counts within two."""
    from krylov_tpu_torch.solvers import pipelined

    A = fixtures.laplace2d(48, constant=True, device=cuda)
    b = _rhs(A.shape[0], 74, cuda)
    kw = dict(method="pcg", M=pc.jacobi(A), tol=1e-9, maxiter=800, restarts=1)
    before = _pcg_counts()
    x, info = krylov_tpu_torch.solve(A, b, **kw)
    calls, on_kernels = (a - c for a, c in zip(_pcg_counts(), before))
    with monkeypatch.context() as m:
        m.setattr(pipelined, "pcg_route", lambda *args: False)
        x_t, info_t = krylov_tpu_torch.solve(A, b, **kw)
    assert info["converged"] and info_t["converged"] and calls == on_kernels > 0
    assert abs(info["iterations"] - info_t["iterations"]) <= 2
    torch.testing.assert_close(x, x_t, rtol=1e-7, atol=1e-10)


@pytest.mark.cuda
def test_pcg_body_records_match_its_counter(graph_blocks):
    """Under torch.profiler, pcg with Chebyshev(6) in a request that
    captures and one that replays every block: the four kernels' records
    equal 4 x the move of ``pcg_body.fused`` (96 bodies each)."""
    from torch.profiler import ProfilerActivity, profile

    A = fixtures.laplace2d(64, constant=True, device="cuda")
    M = pc.chebyshev(A, 6)
    kw = dict(method="pcg", M=M, tol=0.0, maxiter=96)
    A.matvec(_rhs(A.shape[0], 1, "cuda"))  # K1's weights are read once an operator
    for seed, want in ((1, (1, 2)), (2, (0, 3))):
        b = _rhs(A.shape[0], seed, "cuda")
        torch.cuda.synchronize()
        before, counts = _graph_counts(), _pcg_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            krylov_tpu_torch.solve_device(A, b, **kw)
            torch.cuda.synchronize()
        assert _since(before)[3:5] == want
        calls, on_kernels = (a - c for a, c in zip(_pcg_counts(), counts))
        records = sum(e.count for e in prof.key_averages() if any(k in e.key for k in PCG_KERNELS))
        assert calls == on_kernels == 96 and records == 4 * on_kernels


def _same_adaptive_bits(a, b):
    _same_bits(a, b)
    for u, v in ((a.nosl_trace, b.nosl_trace), (a.k_trace, b.k_trace), (a.final_k, b.final_k)):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("system", ["laplace", "advection"])
def test_adaptive_step_graphs_equal_the_eager_loop(graph_blocks, monkeypatch, system, dtype, batch):
    """The adaptive loop's steps as CUDA graphs (a key's first step warms
    up, its second is captured, the rest replay; on the advection stencil
    the guard rolls back and the half-steps run eagerly between replays,
    and a batch's members step at different k) against every step launched
    eagerly: three requests on one operator, bit for bit, with the same
    bodies and host reads, and every step after a key's first replayed.
    The first result is untouched by the later requests."""
    from krylov_tpu_torch import solvers
    from krylov_tpu_torch.solvers import _common

    A = (_advection("cuda") if system == "advection" else fixtures.laplace2d(24, constant=True, device="cuda"))
    A = StencilMatrix(A.coef.to(dtype), A.stencil, A.grid)
    k = 6 if system == "advection" else 4
    tol = {torch.float64: 1e-10, torch.float32: 1e-5}[dtype]
    bs = [_graph_batch(A, seed, batch) for seed in (41, 42, 46)]
    A.matvec(bs[0])  # K1's weights are read once an operator, before the counts
    kw = dict(k=k, tol=tol, maxiter=400)
    before = _graph_counts()
    graph = [solvers.adaptivekskipmrr_kernel(A, b, torch.zeros_like(b), **kw) for b in bs]
    on_graph = _since(before)
    first_x = graph[0].x.clone()
    with monkeypatch.context() as m:
        m.setattr(_common, "step_route", lambda state: False)
        before = _graph_counts()
        eager = [solvers.adaptivekskipmrr_kernel(A, b, torch.zeros_like(b), **kw) for b in bs]
        on_eager = _since(before)
    for g, e in zip(graph, eager):
        _same_adaptive_bits(g, e)
    assert torch.equal(graph[0].x, first_x)
    assert on_graph[:3] == on_eager[:3] and on_eager[3:6] == (0, 0, 0)
    captures, replays, bodies = on_graph[3:6]
    assert captures >= 1 and replays == bodies and on_graph[0] - replays >= len(graph_blocks)
    if system == "advection":
        assert all(bool((e.final_k < k).all()) for e in eager)


@pytest.mark.cuda
@pytest.mark.parametrize("restarts", [0, 1])
@pytest.mark.parametrize("form", ["grid", "constant"])
def test_mesh_adaptive_step_graphs_equal_the_eager_loop(nccl_mesh, graph_blocks, monkeypatch, form, restarts):
    """solve_device(mesh=) of adaptive k-skip MrR in an NCCL world of one,
    its steps replayed as CUDA graphs with their all-reduces captured,
    against the eager single-device loop on the same card (every step
    launched from Python): two requests on one operator (the second replays
    from its first step), counts, traces, k and x bit for bit, with
    ``restarts=1`` too (its first solve stops at maxiter 80, short of tol,
    so the defect solve runs; the true residuals, all-reduced on the mesh,
    within 1e-13).  The mesh's all-reduces are those of its eager route:
    each replay adds what its capture recorded."""
    from krylov_tpu_torch.context import all_reduce
    from krylov_tpu_torch.solvers import _common

    A = fixtures.laplace2d(32, constant=form == "constant", device="cuda")
    bs = [_rhs(A.shape[0], seed, "cuda") for seed in (14, 15)]
    kw = dict(method="adaptivekskipmrr", k=4, tol=1e-9, maxiter=80 if restarts else 2000, restarts=restarts)
    reduces = {}
    with monkeypatch.context() as m:
        m.setattr(_common, "step_route", lambda state: False)
        eager = [krylov_tpu_torch.solve_device(A, b, fused=False, **kw) for b in bs]
        before = all_reduce.calls
        for b in bs:
            krylov_tpu_torch.solve_device(A, b, mesh=nccl_mesh, **kw)
        reduces["eager"] = all_reduce.calls - before
    before, calls = _graph_counts(), all_reduce.calls
    mesh = [krylov_tpu_torch.solve_device(A, b, mesh=nccl_mesh, **kw) for b in bs]
    on_mesh, reduces["graph"] = _since(before), all_reduce.calls - calls
    for s, e in zip(mesh, eager):
        _same_adaptive_bits(s, e)
        if restarts:
            assert int(s.iterations) > 80 and bool(s.converged)
            torch.testing.assert_close(s.true_residual, e.true_residual, rtol=1e-13, atol=0)
    assert on_mesh[4] >= 1 and on_mesh[4] == on_mesh[5]
    assert reduces["graph"] == reduces["eager"] > 0
