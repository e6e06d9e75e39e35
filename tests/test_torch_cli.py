"""The port's driver, ``python -m krylov_tpu_torch``, against the JAX
package's (``krylov_tpu.cli``): the same ``condition.json`` gives the same
exit code and iteration count, x within rtol 1e-8 (float64; the adaptive
k-skip case at the k-skip tolerances of tests/test_torch_kskip_solve.py,
rtol 1e-6, atol 1e-9), and ``info`` the same report.  The port's one extra
flag is ``--device``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import krylov_tpu_torch
from krylov_tpu import checkpoint as jcheckpoint
from krylov_tpu.cli import main as jax_main
from krylov_tpu_torch import checkpoint
from krylov_tpu_torch.cli import main

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


def _both(args):
    """Exit codes of the JAX driver and of the port's (on the CPU)."""
    return jax_main(list(args)), main([*args, "--device", "cpu"])


@pytest.mark.parametrize("config, x_tol", [
    ({"matrix": {"fixture": "laplace2d", "n": 24, "constant": True}, "b": "random", "method": "kskipmrr", "k": 3,
      "dtype": "float64", "tol": 1e-9, "chunk_iters": 30}, (1e-8, 1e-12)),
    ({"matrix": {"fixture": "laplace2d", "n": 24}, "b": "random", "method": "adaptivekskipmrr", "k": 4,
      "dtype": "float64", "tol": 1e-9, "chunk_iters": 25}, (1e-6, 1e-9)),
    ({"matrix": {"fixture": "poisson1d", "n": 64}, "method": "pcg", "precond": "jacobi", "dtype": "float64",
      "tol": 1e-8}, (1e-8, 1e-12)),
], ids=["kskipmrr-chunked", "adaptive-chunked", "pcg-jacobi"])
def test_condition_json_through_both_drivers(tmp_path, config, x_tol):
    outs = {}
    for name, run in (("jax", jax_main), ("torch", main)):
        cfg = dict(config, out=str(tmp_path / f"{name}.npz"))
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        args = ["solve", "--config", str(path), "--quiet"] + (["--device", "cpu"] if name == "torch" else [])
        assert run(args) == 0
        outs[name] = jcheckpoint.load(cfg["out"])
    (xr, sr), (x, s) = outs["jax"], checkpoint.load(str(tmp_path / "torch.npz"))
    assert s["meta"]["iterations"] == sr["meta"]["iterations"] and s["meta"]["converged"]
    assert s["meta"]["method"] == config["method"] and len(s["nosl"]) == len(sr["nosl"])
    np.testing.assert_allclose(x, xr, rtol=x_tol[0], atol=x_tol[1])
    np.testing.assert_array_equal(outs["torch"][0], x)


def test_flags_override_the_config(tmp_path):
    """A scipy .npz matrix from condition.json, with flags over the file."""
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(128, 128)).tocsr()
    mat = tmp_path / "A.npz"
    sp.save_npz(str(mat), A)
    cond = tmp_path / "condition.json"
    cond.write_text(json.dumps({"matrix": str(mat), "method": "mrr", "tol": 1e-6, "dtype": "float64"}))
    outs = [str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")]
    args = ["solve", "--config", str(cond), "--method", "kskipmrr", "--k", "2", "--quiet"]
    assert jax_main([*args, "--out", outs[0]]) == main([*args, "--out", outs[1], "--device", "cpu"]) == 0
    (xr, sr), (x, s) = (checkpoint.load(o) for o in outs)
    assert s["meta"]["method"] == "kskipmrr" and s["meta"]["iterations"] == sr["meta"]["iterations"]
    np.testing.assert_allclose(x, xr, rtol=1e-8, atol=1e-12)


def test_exit_codes_match():
    # 1: not converged
    assert _both(["solve", "--fixture", "laplace2d", "--n", "32", "--tol", "1e-12", "--maxiter", "3",
                  "--dtype", "float64", "--quiet"]) == (1, 1)
    # 2: no matrix source
    assert _both(["solve", "--quiet"]) == (2, 2)
    # 2: argparse rejects an unknown fixture
    for run, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            run(["solve", "--fixture", "nope", *extra])
        assert e.value.code == 2


def test_bad_scalar_dtype_in_config_exits_2(tmp_path):
    cond = tmp_path / "condition.json"
    cond.write_text(json.dumps({"matrix": {"fixture": "poisson1d", "n": 16}, "scalar_dtype": "f64"}))
    assert _both(["solve", "--config", str(cond), "--quiet"]) == (2, 2)


def test_mesh_names_the_roadmap_item(tmp_path):
    """``--mesh`` is ported: run alone, the port's driver solves over a
    gloo world of one (made and destroyed by the command), as the JAX
    driver solves over its mesh of the 8 CPU devices; the same exit code,
    count and x (rtol 1e-8)."""
    import torch.distributed as dist

    outs = {}
    for name, run in (("jax", jax_main), ("torch", main)):
        out = str(tmp_path / f"{name}.npz")
        args = ["solve", "--fixture", "laplace2d", "--n", "8", "--mesh", "--quiet", "--b", "random", "--dtype",
                "float64", "--tol", "1e-9", "--out", out]
        assert run(args + (["--device", "cpu"] if name == "torch" else [])) == 0
        outs[name] = jcheckpoint.load(out)
    assert not dist.is_initialized()
    (xr, sr), (x, s) = outs["jax"], outs["torch"]
    assert s["meta"]["iterations"] == sr["meta"]["iterations"]
    np.testing.assert_allclose(x, xr, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("args", [
    ["--fixture", "laplace2d", "--n", "16"],
    ["--fixture", "poisson1d", "--n", "40"],
    ["--fixture", "random_spd_ell", "--n", "50"],
    ["--fixture", "powerlaw_spd", "--n", "300"],
    ["--matrix", "A.npz"],
], ids=["stencil", "dia", "ell", "hyb", "npz"])
def test_info_reports_the_same(capsys, tmp_path, monkeypatch, args):
    monkeypatch.chdir(tmp_path)
    sp.save_npz("A.npz", sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64)).tocsr())
    reports = []
    for rc in _both(["info", *args]):
        assert rc == 0
    out = capsys.readouterr().out
    decoder, pos = json.JSONDecoder(), 0
    while pos < len(out):
        report, end = decoder.raw_decode(out, pos)
        reports.append(report)
        pos = end + 1
    assert len(reports) == 2 and reports[0] == reports[1]


def test_module_entry_point_leaves_jax_out():
    """``python -m krylov_tpu_torch info`` in a fresh interpreter, with no
    jax loaded at its exit."""
    code = ("import runpy, sys\n"
            "sys.argv = ['krylov_tpu_torch', 'info', '--fixture', 'laplace2d', '--n', '8', '--device', 'cpu']\n"
            "try:\n    runpy.run_module('krylov_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "sys.exit(3 if 'jax' in sys.modules else rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["container"] == "StencilMatrix"
    proc = subprocess.run([sys.executable, "-m", "krylov_tpu_torch", "info", "--fixture", "poisson1d", "--n", "8",
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and json.loads(proc.stdout)["container"] == "DiaMatrix", proc.stderr
