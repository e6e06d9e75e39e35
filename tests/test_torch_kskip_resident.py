"""The launch plan of the fused k-skip kernels K5/K6 (resident or streaming
route), on the CPU.

The resident kernels (``csrc/fused_kskip_resident.cu``) run only on a CUDA
card, where tests/test_torch_cuda.py holds both routes against the plain
versions; here the plan that :func:`krylov_tpu_torch.kernels.fused_kskip.plan`
makes from the grid, the stencil, the dtype, ``k_max`` and the SM count is
checked against the rules the kernels rely on: every row in one band of at
least h rows, a band within its threads' points, and the counted shared
memory (two mirrors, the band-only arrays, the bundle's per-warp sums and
the step coefficients) within ``RESIDENT_SMEM``.
"""

from types import SimpleNamespace

import pytest
import torch

import krylov_tpu_torch
from krylov_tpu_torch.kernels import fused, fused_kskip
from krylov_tpu_torch.sparse import fixtures
from test_torch_resident import H100_SMS, PLAN_CASES, STENCIL_2D

METHODS = ("kskipcg", "kskipmrr")
BAND_ARRAYS = {"kskipcg": 1, "kskipmrr": 3}  # x; x, z and pre_x


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


def _shared_bytes(method, rows, h, g1, k_max, dtype):
    """The layout of csrc/fused_kskip_resident.cu, counted independently:
    two mirrors of band and 2h halo rows, the band-only arrays, 16 warps'
    and the block's sums of the 6 k_max + 6 bundle entries, and the
    2 (k_max + 1) step coefficients."""
    values = 2 * (rows + 2 * h) * g1 + BAND_ARRAYS[method] * rows * g1 + 17 * (6 * k_max + 6) + 2 * (k_max + 1)
    return values * dtype.itemsize


@pytest.mark.parametrize("k_max", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", METHODS)
def test_main_path_system_takes_the_resident_route(method, dtype, k_max):
    """laplace2d(500, constant) (N = 250k): 132 bands of at most 4 rows, 4
    points a thread of 512, one row of halo; K5 in float64 at k_max 8, the
    largest, takes 103,488 bytes of the 231,424."""
    _, stencil, grid, _ = fixtures.laplace2d(500, constant=True, device="cpu").collapse_to_2d()
    p = fused_kskip.plan(method, grid, stencil, dtype, H100_SMS, k_max)
    assert p == fused.Plan("resident", 132, 512, 4, 4, 1, _shared_bytes(method, 4, 1, 500, k_max, dtype))
    assert p.smem <= fused.RESIDENT_SMEM
    if (method, dtype, k_max) == ("kskipmrr", torch.float64, 8):
        assert p.smem == 103_488


@pytest.mark.parametrize("k_max", [1, 4])
@pytest.mark.parametrize("method", METHODS)
def test_large_system_takes_the_streaming_route(method, k_max):
    """laplace2d(1500) in float64 (N = 2.25M): 132 bands of 12 rows are
    18,000 points, more than 8 a thread of 512; it streams, in blocks of
    256 threads whose grid the C library sizes at launch (the plan carries
    none), and a forced resident route raises."""
    _, stencil, grid, _ = fixtures.laplace2d(1500, device="cpu").collapse_to_2d()
    p = fused_kskip.plan(method, grid, stencil, torch.float64, H100_SMS, k_max)
    assert p == fused.Plan("streaming", 0, 256, 0, 0, 1, 0)
    with pytest.raises(ValueError, match="does not fit"):
        fused_kskip.plan(method, grid, stencil, torch.float64, H100_SMS, k_max, route="resident")


@pytest.mark.parametrize("k_max", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_resident_bands_own_every_row_once(name, method, dtype, k_max, sms):
    """Every row of the collapsed grid lies in exactly one band, in order;
    each band holds at least h rows (so a halo comes from the two
    neighbours alone) and fits its threads; there are no more bands than
    SMs; the counted shared memory fits.  Where the bands cannot fit, the
    plan streams and a forced resident route raises."""
    stencil, grid = PLAN_CASES[name]
    p = fused_kskip.plan(method, grid, stencil, dtype, sms, k_max)
    if p.route == "streaming":
        with pytest.raises(ValueError, match="does not fit"):
            fused_kskip.plan(method, grid, stencil, dtype, sms, k_max, route="resident")
        return
    g0, g1 = grid
    bands = fused.band_rows(g0, p.blocks)
    assert 1 <= p.blocks <= min(sms, fused.RESIDENT_MAX_BLOCKS)
    assert sum(rows for _, rows in bands) == g0
    assert [first for first, _ in bands] == [sum(r for _, r in bands[:j]) for j in range(p.blocks)]
    assert all(rows >= p.halo for _, rows in bands) or p.blocks == 1
    assert p.halo == max(abs(d0) for d0, _ in stencil)
    assert max(rows for _, rows in bands) == p.rows and p.rows * g1 <= p.ppt * p.threads
    assert p.ppt == min(q for q in fused.RESIDENT_PPT if q * p.threads >= p.rows * g1)
    assert p.smem == _shared_bytes(method, p.rows, p.halo, g1, k_max, dtype) <= fused.RESIDENT_SMEM


@pytest.mark.parametrize(
    "method, dtype, route",
    [
        ("kskipcg", torch.float64, "resident"),
        ("kskipmrr", torch.float64, "streaming"),
        ("kskipcg", torch.float32, "resident"),
        ("kskipmrr", torch.float32, "resident"),
    ],
)
def test_shared_memory_decides_where_the_threads_fit(method, dtype, route):
    """A 132 x 4096 grid: one row a band is 4096 points, 8 a thread.  In
    float64 K6's two mirrors of 3 rows and x take 229,376 bytes and fit;
    K5's z and pre_x do not, so K5 streams there and a forced resident K5
    raises (k_max 1).  float32 takes half and both fit."""
    p = fused_kskip.plan(method, (132, 4096), STENCIL_2D, dtype, H100_SMS, 1)
    assert p.route == route
    if route == "streaming":
        with pytest.raises(ValueError, match="does not fit"):
            fused_kskip.plan(method, (132, 4096), STENCIL_2D, dtype, H100_SMS, 1, route="resident")
    else:
        assert p.ppt == 8 and p.smem == _shared_bytes(method, 1, 1, 4096, 1, dtype) <= fused.RESIDENT_SMEM


@pytest.mark.parametrize("method", METHODS)
def test_k_max_has_no_compile_time_cap(method):
    """k is a runtime value <= k_max: the bundle's shared memory grows with
    k_max, and only a k_max whose bundle no longer fits beside the band
    (here 256 at N = 250k in float64) sends the solve to streaming."""
    sizes = [fused_kskip.plan(method, (500, 500), STENCIL_2D, torch.float64, H100_SMS, k) for k in (8, 16, 64, 256)]
    assert [p.route for p in sizes] == ["resident"] * 3 + ["streaming"]
    assert sizes[0].smem < sizes[1].smem < sizes[2].smem
    assert sizes[2].smem - sizes[1].smem == (17 * 6 + 2) * 48 * 8


@pytest.mark.parametrize("method", METHODS)
def test_max_blocks_caps_both_routes(method):
    """max_blocks caps the resident bands; the streaming plan leaves its
    grid to the C library, which caps it at fused.MAX_BLOCKS at launch
    (device_plan reads it back: the test below, and on the card
    tests/test_torch_cuda.py)."""
    resident = fused_kskip.plan(method, (500, 500), STENCIL_2D, torch.float64, H100_SMS, 4, max_blocks=100)
    streaming = fused_kskip.plan(method, (500, 500), STENCIL_2D, torch.float64, H100_SMS, 4, max_blocks=100,
                                 route="streaming")
    assert (resident.route, resident.blocks, resident.rows, resident.ppt) == ("resident", 100, 5, 8)
    assert (streaming.route, streaming.blocks, streaming.threads) == ("streaming", 0, 256)
    with pytest.raises(ValueError, match="route must be"):
        fused_kskip.plan(method, (500, 500), STENCIL_2D, torch.float64, H100_SMS, 4, route="fast")
    with pytest.raises(ValueError, match="method must be"):
        fused_kskip.plan("cg", (500, 500), STENCIL_2D, torch.float64, H100_SMS, 4)


def test_device_plan_reads_the_route_and_the_cap_at_call_time(monkeypatch):
    """device_plan takes the SM count from the device and fused.ROUTE and
    fused.MAX_BLOCKS as they stand at the call (no knob of its own); a
    streaming plan carries the grid workspace() sizes for the launch (here
    a stand-in for the C library: 2 blocks an SM, at most MAX_BLOCKS)."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    sized = []

    def workspace(method, dtype, n, k_max):
        sized.append((method, dtype, n, k_max))
        return min(2 * 132, fused.MAX_BLOCKS or 2 * 132), 0, 0, 0

    monkeypatch.setattr(fused_kskip, "workspace", workspace)

    def route_and_blocks():
        p = fused_kskip.device_plan("kskipmrr", (500, 500), STENCIL_2D, torch.float64, 4)
        return p.route, p.blocks

    assert route_and_blocks() == ("resident", 132)
    monkeypatch.setattr(fused, "MAX_BLOCKS", 66)
    assert route_and_blocks() == ("resident", 66)
    monkeypatch.setattr(fused, "ROUTE", "streaming")
    assert route_and_blocks() == ("streaming", 66)
    monkeypatch.setattr(fused, "MAX_BLOCKS", 0)
    assert route_and_blocks() == ("streaming", 264)
    assert sized == [("kskipmrr", torch.float64, 500 * 500, 4)] * 2


@pytest.mark.parametrize("method", METHODS)
def test_resident_scratch_sizes(method):
    """The neighbour exchange holds 2 sets of 2 vectors of 2 h g1 words a
    band; the sums 2 sets of 3 partials a band and 2 of 3 totals for the
    small sums, then 2 sets of 6 k_max + 6 partials a band and 2 of totals
    for the bundle."""
    p = fused_kskip.plan(method, (500, 500), STENCIL_2D, torch.float64, H100_SMS, 4)
    assert fused_kskip.resident_buffers(p, (500, 500), 4) == (132 * 2 * 2 * 2 * 500, 6 * 132 + 6 + 2 * 30 * 133)
    one_row = fused_kskip.plan(method, (40, 30), ((0, -1), (0, 0), (0, 1)), torch.float64, H100_SMS, 1,
                               route="resident")
    assert one_row.halo == 0 and fused_kskip.resident_buffers(one_row, (40, 30), 1)[0] == 1
