"""Checkpoints: krylov_tpu_torch.checkpoint against krylov_tpu.checkpoint.

Both write the same ``.npz`` layout, so a file of either package loads and
resumes in the other.  A resume warm-starts from the saved iterate; in
float64 the port's resume takes the JAX package's iteration count, with x
within rtol 1e-8 (atol 1e-12).
"""

import numpy as np
import pytest
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu import checkpoint as jcheckpoint
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch import checkpoint
from krylov_tpu_torch.sparse.convert import from_jax_operator


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """The entry points put host input on the card by default; these tests
    ask for the CPU."""
    previous = krylov_tpu_torch.set_default_device("cpu")
    yield
    krylov_tpu_torch.set_default_device(previous)


KEYS = {"x", "residual", "nosl", "khistory", "meta_json"}


def _system():
    A = jfx.laplace2d(20)
    return A, from_jax_operator(A), np.random.default_rng(9).standard_normal(A.shape[0])


def test_save_load_round_trip(tmp_path):
    _, At, b = _system()
    x, info = krylov_tpu_torch.solve(At, b, method="adaptivekskipmrr", k=4, tol=1e-8, maxiter=1000)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, x, info, method="adaptivekskipmrr", note="round trip")
    with np.load(path) as z:
        assert set(z.files) == KEYS
    x2, state = checkpoint.load(path)
    np.testing.assert_array_equal(x2, x.numpy())
    for key in ("residual", "nosl", "khistory"):
        np.testing.assert_array_equal(state[key], info[key])
    meta = state["meta"]
    assert (meta["iterations"], meta["converged"], meta["method"], meta["note"]) == (
        info["iterations"], True, "adaptivekskipmrr", "round trip")
    # a bare iterate, without info
    checkpoint.save(str(tmp_path / "bare.npz"), torch.arange(4.0))
    x3, state3 = checkpoint.load(str(tmp_path / "bare.npz"))
    np.testing.assert_array_equal(x3, np.arange(4.0))
    assert set(state3) == {"meta"} and "iterations" not in state3["meta"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_cross_load_and_resume(tmp_path, writer):
    """A file of either package resumes in both, with the same counts."""
    A, At, b = _system()
    kw = dict(method="cg", tol=1e-10, maxiter=15)
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        x, info = krylov_tpu.solve(A, b, **kw)
        jcheckpoint.save(path, x, info, method="cg")
    else:
        x, info = krylov_tpu_torch.solve(At, b, **kw)
        checkpoint.save(path, x, info, method="cg")
    assert not info["converged"]
    xj, sj = jcheckpoint.load(path)
    xt, st = checkpoint.load(path)
    np.testing.assert_array_equal(xj, xt)
    assert sj["meta"] == st["meta"] and st["meta"]["iterations"] == 15
    kw["maxiter"] = 500
    xr, ir = jcheckpoint.resume(A, b, path, **kw)
    x2, i2 = checkpoint.resume(At, b, path, **kw)
    assert i2["converged"] and i2["iterations"] == ir["iterations"] < 500
    assert i2["resumed_from"] == ir["resumed_from"] == {"path": path, "prior_iterations": 15}
    np.testing.assert_allclose(x2.numpy(), np.asarray(xr), rtol=1e-8, atol=1e-12)
    assert x2.device == At.device


@pytest.mark.parametrize("method, k", [("mrr", 0), ("kskipmrr", 3)])
def test_resume_of_a_chunk_matches_jax(tmp_path, method, k):
    """The first chunk of a chunked solve saved, then resumed (on the fused
    route here for the stencil)."""
    A, At, b = _system()
    path = str(tmp_path / "chunk.npz")
    x, info = krylov_tpu_torch.solve(At, b, method=method, k=k, tol=1e-10, maxiter=20)
    checkpoint.save(path, x, info)
    xr, ir = jcheckpoint.resume(A, b, path, method=method, k=k, tol=1e-10, maxiter=1000)
    x2, i2 = checkpoint.resume(At, b, path, method=method, k=k, tol=1e-10, maxiter=1000)
    assert i2["converged"] and (i2["iterations"], len(i2["nosl"])) == (ir["iterations"], len(ir["nosl"]))
    np.testing.assert_allclose(x2.numpy(), np.asarray(xr), rtol=1e-6, atol=1e-9)
