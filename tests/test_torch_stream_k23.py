"""K2/K3's streaming route on the CPU: BASELINE row 5's system solved with
``method="cg"`` and ``"mrr"`` (tol 1e-4, maxiter 4000, a constant-weight
3-D Laplacian) at a small size against the JAX package, the route plans
that send row 5 and the large 2-D systems to the streaming kernels, the
words model of their forms, and the index range of their buffers at row 5.

The JAX package runs on the CPU with x64 (tests/conftest.py).  The port
takes the plain version of its fused K3/K2 on the CPU.  float64: equal
iterations; residual histories to rtol 1e-9 and x to rtol 1e-8 (the two
packages sum the inner products in other orders, rounding apart by about
1e-13 over the few dozen iterations of this system).
"""

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.sparse.fixtures import laplace3d
from krylov_tpu_torch.kernels import fused
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


ROW5_K23 = dict(tol=1e-4, maxiter=4000)
H100_SMS = 132
# words a point an iteration of each form, counted by hand from
# csrc/fused.cu: every vector a pass reads or writes once
HAND_WORDS = {
    ("cg", "three-pass"): 2 + 6 + 3,  # v = A p | x, p, r, v -> x, r | r, p -> p
    ("cg", "stored"): 4 + 6,  # r, p_prev -> p, v | p, x, r, v -> x, r
    ("mrr", "stored"): 3 + 3 + 9,  # r, y -> Ar | Ar, r, y | Ar, r, y, z, x -> y, z, r, x
}


def _twin():
    A = laplace3d(16, 18, 20, constant=True)
    return A, np.random.default_rng(0).standard_normal(A.shape[0])


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_row5_twin_solve_device_matches_jax(method):
    """solve_device: the fused route's plain K3/K2 against the JAX
    package's solve of the same system."""
    A, b = _twin()
    want = krylov_tpu.solve_device(A, b, method=method, **ROW5_K23)
    got = krylov_tpu_torch.solve_device(from_jax_operator(A), b, method=method, **ROW5_K23)
    idx = int(want.index)
    assert int(got.iterations) == int(want.iterations) and int(got.index) == idx
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_allclose(got.residual_trace[: idx + 1].numpy(), np.asarray(want.residual_trace)[: idx + 1],
                               rtol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_row5_twin_solve_matches_jax(method):
    """solve: the same count, history and x in the info dict, and the true
    residual below tol."""
    A, b = _twin()
    xr, ir = krylov_tpu.solve(A, b, method=method, **ROW5_K23)
    x, info = krylov_tpu_torch.solve(from_jax_operator(A), b, method=method, **ROW5_K23)
    assert info["iterations"] == ir["iterations"] and info["converged"] and ir["converged"]
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=1e-9)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-14)
    A64 = fixtures.laplace3d(16, 18, 20, dtype=torch.float64, constant=True)
    assert float(np.linalg.norm(b - A64.matvec(x).numpy()) / np.linalg.norm(b)) < ROW5_K23["tol"]


def _collapsed(system: str, n: int):
    _, stencil, grid, _ = getattr(fixtures, system)(n, constant=True).collapse_to_2d()
    return grid, stencil


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["cg", "mrr"])
@pytest.mark.parametrize("system, n", [("laplace2d", 1024), ("laplace2d", 1500), ("laplace3d", 216)])
def test_large_systems_stream(system, n, method, dtype):
    """laplace2d(1024) and (1500) and row 5's laplace3d(216) stream, on
    ``STREAM_BLOCKS_PER_SM`` blocks of 256 threads an SM, with the pass
    specialised on their term count."""
    grid, stencil = _collapsed(system, n)
    p = fused.plan(method, grid, stencil, dtype, H100_SMS)
    assert p == fused.Plan("streaming", fused.STREAM_BLOCKS_PER_SM * H100_SMS, 256, 0, 0, 1, 0)
    assert fused.pass_terms(stencil, True) == (5 if system == "laplace2d" else 7)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_laplace2d_500_stays_resident(method, dtype):
    grid, stencil = _collapsed("laplace2d", 500)
    assert fused.plan(method, grid, stencil, dtype, H100_SMS).route == "resident"


@pytest.mark.parametrize("method, form", sorted(HAND_WORDS))
def test_words_model_equals_hand_count(method, form):
    """stream_words of every form equals the hand count, and each form's
    passes are the pass probe's."""
    assert fused.stream_words(method, form) == HAND_WORDS[method, form]
    assert set(fused.FORM_PASSES[method, form]) <= set(fused.PROBE_PASSES[method])
    assert form in fused.STREAM_FORMS[method]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ns", [0, 5, 7])
@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_shipped_shape_is_built(method, ns, dtype):
    """Each instance ships one form of its method on one walk, and
    stream_shape gives it; the masked pass takes the three-pass CG and
    the stored MrR on one point a thread, NS 5 one point a thread, NS 7
    the tiles."""
    form, walk = fused.STREAM_SHIPPED[method, ns, dtype]
    assert fused.stream_shape(method, ns, dtype) == (form, walk)
    assert form in fused.STREAM_FORMS[method] and walk in fused.STREAM_WALKS
    assert fused.stream_words(method, form) == HAND_WORDS[method, form]
    if ns == 0:
        assert (form, walk) == ({"cg": "three-pass", "mrr": "stored"}[method], "points")
    assert (walk == "points") == (ns != 7)


def test_shipped_table_covers_every_instance():
    """STREAM_SHIPPED names each (method, pass, dtype) once, and nothing
    else."""
    keys = {(m, ns, dt) for m in ("cg", "mrr") for ns in (0, *fused.PASS_TERMS)
            for dt in (torch.float64, torch.float32)}
    assert set(fused.STREAM_SHIPPED) == keys


def test_probe_passes_have_words():
    """Every pass of the probe has its words a point, and the passes of the
    forms cover the probe's."""
    for method, names in fused.PROBE_PASSES.items():
        assert len(names) == len(set(names)) == (4 if method == "cg" else 3)
        assert all((method, name) in fused.PASS_WORDS for name in names)
        used = {name for (m, _), passes in fused.FORM_PASSES.items() if m == method for name in passes}
        assert used == set(names)


def test_row5_index_range():
    """At N = 10,077,696 every index of the streaming K2/K3's buffers fits:
    each work vector's offset (at most 5 n, the pass probe's) as a size_t,
    each flat index plus any stencil offset, and each tile index, as an
    int; the 8 partial-sum slots of any grid the card can hold as an
    int."""
    grid, stencil = _collapsed("laplace3d", 216)
    n = grid[0] * grid[1]
    assert grid == (216, 216 * 216) and n == 10_077_696
    int_max = 2**31 - 1
    reach = max(abs(d0 * grid[1] + d1) for d0, d1 in stencil)
    assert n + reach <= int_max
    assert 5 * n <= 2**64 - 1 and n <= int_max  # offsets as size_t; an index within a vector an int
    for itemsize in (4, 8):
        tile = fused.STREAM_THREADS * 16 // itemsize
        assert grid[0] * -(-grid[1] // tile) <= int_max
        assert grid[1] % (16 // itemsize) == 0  # rows start on 16 bytes: the 16-byte loads
    most_blocks = 32 * H100_SMS  # 2048 threads an SM over 64-thread blocks, far above a 256-thread grid
    assert 8 * most_blocks <= int_max
