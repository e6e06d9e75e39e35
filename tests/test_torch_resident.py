"""The launch plan of the fused K2/K3 kernels (resident or streaming route)
and the device default of the entry points, on the CPU.

The resident kernels themselves run only on a CUDA card
(tests/test_torch_cuda.py holds them against their plain versions); here
the plan that :func:`krylov_tpu_torch.kernels.fused.plan` makes from the
grid, the stencil, the dtype and the SM count is checked against the rules
the kernels rely on, and the default device of the entry points is checked
without touching CUDA.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import krylov_tpu_torch
from krylov_tpu_torch import device as port_device
from krylov_tpu_torch.kernels import fused
from krylov_tpu_torch.sparse import fixtures

H100_SMS = 132
STENCIL_2D = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
# a 13-point stencil that reaches two rows up and down
STENCIL_2ROW = ((-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1), (0, 0), (0, 1), (0, 2),
                (1, -1), (1, 0), (1, 1), (2, 0))


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


def _collapsed(A):
    _, stencil2, grid2, _ = A.collapse_to_2d()
    return stencil2, grid2


PLAN_CASES = {
    "laplace2d(500)": (STENCIL_2D, (500, 500)),
    "laplace2d(64)": (STENCIL_2D, (64, 64)),
    "uneven 133x40": (STENCIL_2D, (133, 40)),
    "uneven 1000x97": (STENCIL_2D, (1000, 97)),
    "laplace3d(16) collapsed": _collapsed(fixtures.laplace3d(4, constant=True, device="cpu")),
    "2-row stencil 300x200": (STENCIL_2ROW, (300, 200)),
    "2-row stencil 9x30": (STENCIL_2ROW, (9, 30)),
    "1 x 4000": (STENCIL_2D, (1, 4000)),
    "tiny 3x3": (STENCIL_2D, (3, 3)),
    "tiny 1x1": (((0, 0),), (1, 1)),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["cg", "mrr"])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_resident_bands_own_every_row_once(name, method, dtype, sms):
    """Every row of the collapsed grid lies in exactly one band, the bands
    are contiguous and in order, each holds at least h rows (so a halo
    comes from the two neighbours alone) and fits its threads, and there
    are no more bands than SMs.  Where they cannot fit, the plan streams
    and a forced resident route raises."""
    stencil, grid = PLAN_CASES[name]
    p = fused.plan(method, grid, stencil, dtype, sms)
    if p.route == "streaming":  # too few SMs for these bands: the plan says so
        with pytest.raises(ValueError, match="does not fit"):
            fused.plan(method, grid, stencil, dtype, sms, route="resident")
        return
    g0, g1 = grid
    bands = fused.band_rows(g0, p.blocks)
    assert p.route == "resident" and 1 <= p.blocks <= min(sms, fused.RESIDENT_MAX_BLOCKS)
    owner = np.concatenate([np.full(rows, b) for b, (_, rows) in enumerate(bands)])
    np.testing.assert_array_equal(owner, np.repeat(np.arange(p.blocks), [r for _, r in bands]))
    assert owner.size == g0 and [first for first, _ in bands] == [0, *np.cumsum([r for _, r in bands])[:-1]]
    assert all(rows >= p.halo for _, rows in bands) or p.blocks == 1
    assert max(rows for _, rows in bands) == p.rows and p.rows * g1 <= p.ppt * p.threads


@pytest.mark.parametrize(
    "stencil, want",
    [
        (STENCIL_2D, 1),
        (_collapsed(fixtures.laplace3d(5, 6, 7, constant=True, device="cpu"))[0], 1),
        (STENCIL_2ROW, 2),
        (((0, -1), (0, 0), (0, 1)), 0),
    ],
    ids=["laplace2d", "laplace3d collapsed", "2-row stencil", "one row"],
)
def test_halo_depth_is_the_largest_row_displacement(stencil, want):
    p = fused.plan("mrr", (40, 30), stencil, torch.float64, H100_SMS, route="resident")
    assert p.halo == want == max(abs(d0) for d0, _ in stencil)
    assert p.blocks <= (40 // want if want else 40)


@pytest.mark.parametrize("method", ["cg", "mrr"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_main_path_system_takes_the_resident_route(method, dtype):
    """N = 250k (the 500 x 500 Laplacian) fits the resident route on an
    H100: 132 bands of at most 4 rows, 4 points a thread of 512."""
    p = fused.plan(method, (500, 500), STENCIL_2D, dtype, H100_SMS)
    assert p == fused.Plan("resident", 132, 512, 4, 4, 1, p.smem)
    # the mirror (4 + 2 rows) and x; MrR also y's halo (2 rows) and z
    rows = 4 + 2 + 4 + (2 + 4 if method == "mrr" else 0)
    assert p.smem == rows * 500 * dtype.itemsize <= fused.RESIDENT_SMEM


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_large_system_takes_the_streaming_route(method):
    """laplace2d(1500) in float64 (N = 2.25M) does not fit: 132 bands of 12
    rows are 18,000 points, more than 8 a thread; it streams, 4 blocks of
    256 threads an SM."""
    p = fused.plan(method, (1500, 1500), STENCIL_2D, torch.float64, H100_SMS)
    assert p == fused.Plan("streaming", 4 * H100_SMS, 256, 0, 0, 1, 0)
    with pytest.raises(ValueError, match="does not fit"):
        fused.plan(method, (1500, 1500), STENCIL_2D, torch.float64, H100_SMS, route="resident")


@pytest.mark.parametrize("grid", [(1, 4000), (1, 1), (3, 3), (2, 5000)])
def test_degenerate_grids_are_planned(grid):
    """A single row, a single point and grids too small for many bands are
    planned without error: one band when the rows allow no more, and the
    streaming route where a row is wider than 8 points a thread."""
    for method in ("cg", "mrr"):
        p = fused.plan(method, grid, STENCIL_2D, torch.float64, H100_SMS)
        assert 1 <= p.blocks <= max(1, grid[0]) or p.route == "streaming"
        if p.route == "resident":
            assert p.rows * grid[1] <= p.ppt * p.threads
        else:
            assert p.blocks == max(1, -(-grid[0] * grid[1] // 256))


def test_max_blocks_caps_both_routes():
    resident = fused.plan("cg", (500, 500), STENCIL_2D, torch.float64, H100_SMS, max_blocks=100)
    streaming = fused.plan("cg", (500, 500), STENCIL_2D, torch.float64, H100_SMS, max_blocks=100,
                           route="streaming")
    assert (resident.route, resident.blocks, resident.rows, resident.ppt) == ("resident", 100, 5, 8)
    assert (streaming.route, streaming.blocks) == ("streaming", 100)
    with pytest.raises(ValueError, match="route must be"):
        fused.plan("cg", (500, 500), STENCIL_2D, torch.float64, H100_SMS, route="fast")


def test_resident_scratch_sizes():
    """The edge-row exchange holds 2 h g1 words a band, the sums 2 sets of
    3 partials a band and 2 sets of 3 totals."""
    p = fused.plan("mrr", (500, 500), STENCIL_2D, torch.float64, H100_SMS)
    assert fused.resident_buffers(p, (500, 500)) == (132 * 2 * 500, 6 * 132 + 6)


def test_band_rows_split_as_evenly_as_possible():
    assert fused.band_rows(10, 4) == [(0, 3), (3, 3), (6, 2), (8, 2)]
    # 500 rows on 132 bands: 104 bands of 4 rows, then 28 of 3
    bands = fused.band_rows(500, 132)
    assert bands[0] == (0, 4) and bands[103] == (412, 4) and bands[104] == (416, 3) and bands[-1] == (497, 3)


def test_default_device_is_cuda_without_touching_cuda():
    """The default resolves to the CUDA device by name only: no CUDA call,
    so it works (and costs nothing) on a machine without a card."""
    previous = krylov_tpu_torch.set_default_device("cuda")
    try:
        assert krylov_tpu_torch.default_device() == torch.device("cuda")
        assert port_device.resolve(None) == torch.device("cuda")
        assert port_device.resolve("cpu") == torch.device("cpu")
    finally:
        krylov_tpu_torch.set_default_device(previous)
    assert torch.device(port_device._default) == torch.device("cpu")  # this module's fixture


def test_set_default_device_round_trips():
    first = krylov_tpu_torch.set_default_device("cuda:1")
    assert first == torch.device("cpu") and krylov_tpu_torch.default_device() == torch.device("cuda:1")
    assert krylov_tpu_torch.set_default_device(first) == torch.device("cuda:1")
    assert krylov_tpu_torch.default_device() == torch.device("cpu")


def _on_default_device(make):
    """Runs ``make`` with the package's own default (the CUDA device): on a
    machine without a card it must raise torch's error rather than fall
    back to the host; with one, it must put its tensors there."""
    previous = krylov_tpu_torch.set_default_device("cuda")
    try:
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                make()
            return None
        return make()
    finally:
        krylov_tpu_torch.set_default_device(previous)


def test_fixture_without_a_device_goes_to_the_card():
    A = _on_default_device(lambda: fixtures.laplace2d(8))
    assert A is None or A.coef.device.type == "cuda"


def test_solve_of_host_input_goes_to_the_card():
    P = sp.csr_matrix(np.diag(np.full(16, 2.0)) - np.diag(np.ones(15), 1) - np.diag(np.ones(15), -1))
    b = np.ones(16)
    out = _on_default_device(lambda: krylov_tpu_torch.solve(P, b, method="cg", tol=1e-8))
    assert out is None or out[0].device.type == "cuda"


@pytest.mark.parametrize("make", [
    lambda: fixtures.poisson1d(8),
    lambda: fixtures.laplace3d(3),
    lambda: fixtures.random_spd_ell(20, seed=1),
    lambda: fixtures.ones_rhs(8),
    lambda: krylov_tpu_torch.sparse.as_operator(np.eye(4)),
    lambda: krylov_tpu_torch.sparse.convert.from_scipy(sp.identity(6, format="csr")),
], ids=["poisson1d", "laplace3d", "random_spd_ell", "ones_rhs", "as_operator numpy", "from_scipy"])
def test_host_input_entry_points_default_to_the_card(make):
    out = _on_default_device(make)
    if out is not None:
        t = out if isinstance(out, torch.Tensor) else next(
            v for v in vars(out).values() if isinstance(v, torch.Tensor))
        assert t.device.type == "cuda"


def test_tensor_input_keeps_its_device():
    """A tensor already on a device stays there, whatever the default."""
    A = torch.eye(4, dtype=torch.float64)
    previous = krylov_tpu_torch.set_default_device("cuda")
    try:
        assert krylov_tpu_torch.sparse.as_operator(A).data.device.type == "cpu"
        x, _ = krylov_tpu_torch.solve(fixtures.laplace2d(4, device="cpu"), torch.ones(16, dtype=torch.float64),
                                      tol=1e-10)
        assert x.device.type == "cpu"
    finally:
        krylov_tpu_torch.set_default_device(previous)
