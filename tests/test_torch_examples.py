"""Smoke-run every example of krylov_tpu_torch.examples, the counterparts of
examples/ (tests/test_examples.py runs those on the JAX package).

Each example runs as a fresh subprocess, ``python -m
krylov_tpu_torch.examples.<name> --device cpu``, under its own time limit,
and must exit 0 and print the lines tests/test_examples.py asserts for its
JAX twin; distributed_solve starts a gloo world of 2 ranks.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["basic_solve", "distributed_solve", "preconditioned", "production_long_solve", "multi_rhs_solve"]
TIMEOUT = 300  # seconds an example


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-m", f"krylov_tpu_torch.examples.{name}", "--device", "cpu", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=TIMEOUT)
    assert proc.returncode == 0, f"{name} failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    out = _run(name)
    assert "diverged" not in out
    if name == "basic_solve":
        assert out.count("converged") == 5 and out.count("true relative residual") == 5
    if name == "distributed_solve":
        assert "devices: 2 x cpu" in out and "true relative residual" in out
    if name == "preconditioned":
        assert out.count("converged=True") == 12
    if name == "production_long_solve":
        assert "matches unbroken solve" in out
        assert "resumed: converged=True" in out
    if name == "multi_rhs_solve":
        assert out.count("converged=True") == 8


def test_distributed_solve_takes_the_number_of_ranks():
    """--ranks 3: a gloo world of three ranks (the grid's 128 rows pad to
    a multiple of 3), one report."""
    out = _run("distributed_solve", "--ranks", "3")
    assert "devices: 3 x cpu" in out and out.count("true relative residual") == 1


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(name):
    code = (f"import sys, krylov_tpu_torch.examples.{name}; "
            "sys.exit('jax' in sys.modules or 'krylov_tpu' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
