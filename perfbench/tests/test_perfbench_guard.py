"""The import guard: a run holds neither JAX nor the JAX package
(``krylov_tpu``), compared by whole top-level names, so the port
(``krylov_tpu_torch``), whose name begins with the JAX package's, passes;
and the plain reference imports nothing of the port."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import FORBIDDEN, forbidden_modules
from perfbench.tests._runner import MESH_CELL, ROOT, mesh_root, run_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_whole_top_level_names():
    assert forbidden_modules(["krylov_tpu_torch", "krylov_tpu_torch.api", "numpy", "torch._C"]) == []
    assert forbidden_modules(["krylov_tpu.api", "krylov_tpu_torch"]) == ["krylov_tpu"]
    assert forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping", "krylov_tpu_extra"]) == []


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]] + [MESH_CELL])
def test_cell_loads_no_jax(workload, tmp_path):
    """A run that loads the port passes the guard; the ranks of a world
    apply the same guard to themselves and report what they found."""
    root = mesh_root(tmp_path) if workload == MESH_CELL else ROOT
    code, line, modules, err = run_cell(workload, seed=5, trace=0, root=root)
    assert code == 0 and line is not None, err[-3000:]
    if workload != MESH_CELL:
        assert "krylov_tpu_torch" in modules
    assert not set(modules) & set(FORBIDDEN), modules


def test_run_with_jax_loaded_prints_no_result():
    code, line, _, err = run_cell("p2d-mrr-1rhs", seed=5, preamble="import jax\n")
    assert code != 0 and line is None
    assert "jax" in err and "no result" in err


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, json\n"
            "import perfbench.reference.stencil, perfbench.reference.solvers, perfbench.check, perfbench.roofline\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in top
    assert not top & {"krylov_tpu_torch", *FORBIDDEN}, top
