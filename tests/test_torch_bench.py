"""The port's bench, ``python -m krylov_tpu_torch.bench --device cpu``, run
as a subprocess at a small size (``--nx 32``, N = 1024) the way a user runs
it: every stage's keys in a strict-JSON last line, the checked count equal
to ``krylov_tpu.solve``'s (the JAX package on the CPU with x64) on the same
``default_rng(0)`` b and, for cg and mrr, to the NumPy baseline's, and a
nonzero exit for a failed check, an exceeded budget and a missing card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu.sparse.fixtures import laplace2d as jax_laplace2d
from krylov_tpu_torch import bench
from krylov_tpu_torch.sparse.fixtures import laplace2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds a bench run
NX = 32
STAGE_KEYS = {
    "baseline": ("baseline_method", "baseline_s", "baseline_iterations", "baseline_residual"),
    "headline": ("build_s", "first_call_s", "info_time_s", "checked_iterations", "checked_converged",
                 "checked_residual_true", "time_to_solution_s", "trials_s", "host_wall_s", "iterations",
                 "converged", "residual_recurred", "residual_true", "route"),
    "fidelity": ("fidelity", "fidelity_refine"),
    "spmv": ("spmv_us_call", "spmv_us_device", "spmv_gnnz_per_s", "spmv_gflops", "spmv_bound_us", "spmv_bound_by"),
    "amortized": ("amortized_per_solve_s", "nrhs_amortized_over", "iterations_all_rhs", "amortized_vs_baseline"),
    "api": ("solve_api_incl_host_transfer_s",),
}


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


def _strict(text: str) -> dict:
    def refuse(token):
        raise ValueError(f"not strict JSON: {token}")

    return json.loads(text, parse_constant=refuse)


def _bench(*args, device="cpu"):
    """``(exit code, the last stdout line as JSON, stderr)`` of one run."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-m", "krylov_tpu_torch.bench", "--device", device, "--nx", str(NX), *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    assert lines, f"no output:\n{proc.stderr}"
    return proc.returncode, _strict(lines[-1]), proc.stderr


@pytest.mark.parametrize("method, k", [("mrr", 0), ("cg", 0), ("kskipmrr", 4), ("adaptivekskipmrr", 8)])
def test_bench_runs_every_stage_at_the_jax_count(method, k):
    rc, out, err = _bench("--method", method, "--k", str(k))
    e = out["extra"]
    assert rc == 0, f"{e.get('failed_checks')}\n{err}"
    assert out["metric"] == f"{method}_laplace2d_n{NX * NX}_float64_time_to_solution" and out["unit"] == "s"
    assert out["value"] == e["time_to_solution_s"] > 0 and out["vs_baseline"] > 0
    for stage, keys in STAGE_KEYS.items():
        assert all(key in e for key in keys), (stage, [key for key in keys if key not in e])
    assert e["device"] == "cpu" and e["failed_checks"] == [] and e["route"] == {"resident": 0, "streaming": 0}
    assert e["spmv_us_device"] is None and e["spmv_us_call"] > 0  # no graph off the card
    b = np.random.default_rng(0).standard_normal(NX * NX)
    _, info = krylov_tpu.solve(jax_laplace2d(NX, dtype=np.float64, constant=True), b, method=method, k=k,
                               tol=1e-5, maxiter=3000)
    assert e["checked_iterations"] == info["iterations"]
    if method in ("cg", "mrr"):
        assert e["checked_iterations"] == e["baseline_iterations"]
    for key in ("checked_residual_true", "residual_true", "amortized_residual_true_max"):
        assert e[key] < 1e-5, key
    assert e["fidelity"]["true_residual"] < 1e-5 and e["fidelity_refine"]["true_residual"] < 1e-5
    assert len(e["iterations_all_rhs"]) == e["nrhs_amortized_over"] == 8


def test_failed_check_exits_nonzero_with_the_json_line():
    """--maxiter 5: the counts agree (both stop at 5), the true residuals do
    not reach tol, so every float64 solve fails its check."""
    rc, out, _ = _bench("--maxiter", "5")
    e = out["extra"]
    assert rc == 1 and e["checked_iterations"] == e["baseline_iterations"] == 5
    assert any(f.startswith("headline checked solve: true residual") for f in e["failed_checks"])
    assert any(f.startswith("fidelity refine=3") for f in e["failed_checks"])


def test_float32_run_exits_zero():
    rc, out, err = _bench("--dtype", "float32")
    assert rc == 0, err
    assert out["metric"].endswith("_float32_time_to_solution") and out["extra"]["fidelity_refine"]["true_residual"] < 1e-5


def test_budget_exceeded_exits_nonzero():
    rc, out, _ = _bench("--budget", "0")
    assert rc == 1 and out["extra"]["budget_exceeded_s"] == 0 and out["value"] is None


def test_stages_pick_some_stages():
    rc, out, err = _bench("--stages", "spmv,baseline")
    e = out["extra"]
    assert rc == 0, err
    assert e["stages"] == ["baseline", "spmv"] and "spmv_us_call" in e and "baseline_s" in e
    assert "checked_iterations" not in e and out["value"] is None


def test_missing_card_is_torch_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, _ = _bench(device="cuda")
    assert rc == 1 and "baseline_s" not in out["extra"]
    assert "CUDA" in out["extra"]["fatal_error"]


def test_bench_imports_no_jax():
    code = "import sys, krylov_tpu_torch.bench; sys.exit('jax' in sys.modules or 'krylov_tpu' in sys.modules)"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unknown_stage_is_a_usage_error():
    with pytest.raises(SystemExit) as exc:
        bench.parse(["--stages", "headline,warmup"])
    assert exc.value.code == 2


@pytest.mark.parametrize("nx", [1, 5, 12])
def test_check_matrix_is_the_fixture(nx):
    """The scipy check matrix is the port's laplace2d, entry for entry."""
    A = laplace2d(nx, dtype=torch.float64, constant=True, device="cpu")
    dense = torch.stack([A.matvec(e) for e in torch.eye(nx * nx, dtype=torch.float64)], 1).numpy()
    np.testing.assert_array_equal(bench.laplace2d_csr_f64(nx).toarray(), dense)


@pytest.mark.parametrize("baseline, method", [(bench.numpy_mrr, "mrr"), (bench.numpy_cg, "cg")])
def test_numpy_baselines_match_the_jax_counts(baseline, method):
    nx = 24
    b = np.random.default_rng(3).standard_normal(nx * nx)
    _, iters, res = baseline(bench.laplace2d_csr_f64(nx), b, 1e-8, 2000)
    _, info = krylov_tpu.solve(jax_laplace2d(nx, dtype=np.float64, constant=True), b, method=method, tol=1e-8,
                               maxiter=2000)
    assert iters == info["iterations"] and res < 1e-8


def test_finite_makes_strict_json():
    out = bench._finite({"a": [1.0, float("nan")], "b": (float("inf"),), "c": {"d": -float("inf")}, "e": None})
    assert json.loads(json.dumps(out, allow_nan=False)) == {"a": [1.0, "nan"], "b": ["inf"], "c": {"d": "-inf"},
                                                            "e": None}
