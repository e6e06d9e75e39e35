"""krylov_tpu_torch.diagnostics.profiling (torch.profiler) against
krylov_tpu.diagnostics.profiling, on the CPU.

trace_solve writes a Chrome/Perfetto trace into its directory and returns
solve's own (x, info), bitwise; phase_times returns the JAX package's keys
and, on the same float64 system, its iteration count.  A CUDA device asks
the profiler for the CUDA activity (read here from the arguments the
profiler is given; on the card tests/test_torch_cuda.py reads the kernels'
names in the trace).
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.diagnostics import profiling as jax_profiling
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch.diagnostics import profiling
from krylov_tpu_torch.sparse import fixtures
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


@pytest.mark.parametrize("method, kw", [("mrr", {}), ("pcg", {"M": "jacobi"}), ("cacg", {"k": 4})])
def test_trace_solve_writes_a_trace_and_returns_the_solve(tmp_path, method, kw):
    A = fixtures.laplace2d(16, constant=True)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    if kw.get("M") == "jacobi":
        kw = dict(M=krylov_tpu_torch.precond.jacobi(A))
    x, info = profiling.trace_solve(A, b, str(tmp_path), method=method, tol=1e-8, **kw)
    x_ref, info_ref = krylov_tpu_torch.solve(A, b, method=method, tol=1e-8, **kw)
    assert torch.equal(x, x_ref) and info["iterations"] == info_ref["iterations"] and info["converged"]
    np.testing.assert_array_equal(info["residual"], info_ref["residual"])
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), "no torch op in the trace"


def test_trace_yields_the_profiler(tmp_path):
    A = fixtures.laplace2d(8, constant=True)
    with profiling.trace(str(tmp_path), "cpu") as prof:
        A.matvec(torch.ones(64, dtype=torch.float64))
    assert len(prof.key_averages()) > 0
    assert len(glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))) == 1


@pytest.mark.parametrize("device, cuda", [("cpu", False), ("cuda", True), (None, True)])
def test_trace_asks_for_the_cuda_activity_on_a_card(monkeypatch, tmp_path, device, cuda):
    """The activities follow the device: CPU alone for a CPU solve, CPU and
    CUDA for a card (the port's default device, cuda, when none is named),
    whose work is synchronised before the trace closes."""
    from torch.profiler import ProfilerActivity

    seen, synced = {}, []

    @contextlib.contextmanager
    def fake_profile(activities, on_trace_ready):
        seen["activities"] = activities
        yield None

    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    previous = krylov_tpu_torch.set_default_device("cuda")
    try:
        with profiling.trace(str(tmp_path), device):
            pass
    finally:
        krylov_tpu_torch.set_default_device(previous)
    assert (ProfilerActivity.CUDA in seen["activities"]) == cuda
    assert ProfilerActivity.CPU in seen["activities"]
    assert bool(synced) == cuda


@pytest.mark.parametrize("method, k", [("mrr", 0), ("cg", 0), ("kskipmrr", 2)])
def test_phase_times_matches_jax(method, k):
    A = jfx.laplace2d(20)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    want = jax_profiling.phase_times(A, b, method=method, k=k, tol=1e-8)
    got = profiling.phase_times(from_jax_operator(A), b, method=method, k=k, tol=1e-8)
    assert set(got) == set(want)
    assert got["iterations"] == want["iterations"] and got["converged"] and want["converged"]
    for key in ("compile_plus_first_solve_s", "solve_s", "fetch_s"):
        assert isinstance(got[key], float) and got[key] >= 0.0


def test_diagnostics_exports_profiling():
    import krylov_tpu_torch.diagnostics as diagnostics

    assert diagnostics.profiling is profiling and "profiling" in diagnostics.__all__
    assert set(diagnostics.__all__) == set(krylov_tpu.diagnostics.__all__)
