"""krylov_tpu_torch sparse containers and fixtures against krylov_tpu.

One operator is built by the JAX package's fixture and handed to both
packages through ``from_jax_operator``; inputs come from seeded numpy.
float64 throughout, rtol 1e-12: the same products summed in the same order,
so only the last bits may differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu_torch.sparse import DenseMatrix, DiaMatrix, EllMatrix, StencilMatrix, as_operator, fixtures, to_device
from krylov_tpu_torch.sparse.convert import from_jax_operator

RTOL = 1e-12

STENCILS = {
    "2d": lambda: jfx.laplace2d(9, 7),
    "2d-const": lambda: jfx.laplace2d(9, 7, constant=True),
    "3d": lambda: jfx.laplace3d(5, 4, 6),
    "3d-const": lambda: jfx.laplace3d(5, 4, 6, constant=True),
}


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_stencil_matvec_matches_jax(name):
    A = STENCILS[name]()
    x = _x(A.shape[0])
    y_ref = np.asarray(A.matvec(jnp.asarray(x)))
    y = from_jax_operator(A).matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=RTOL)


@pytest.mark.parametrize("constant", [False, True])
def test_collapse_to_2d_matches_jax(constant):
    """Same collapsed coefficients, stencil, grid and ``sub`` lane mask."""
    A = jfx.laplace3d(5, 4, 6, constant=constant)
    coef2, stencil2, grid2, sub = A.collapse_to_2d()
    c2, s2, g2, sub_t = from_jax_operator(A).collapse_to_2d()
    assert (s2, g2, sub_t) == (stencil2, grid2, sub)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(coef2))
    if constant:
        assert sub == (5, (0, 0, -1, 0, 1, 0, 0))  # g2 = nx


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_to_dia_todense_offsets_match_jax(name):
    A = STENCILS[name]()
    At = from_jax_operator(A)
    assert At.offsets == A.offsets
    assert (At.shape, At.nnz, At.is_constant) == (A.shape, A.nnz, A.is_constant)
    np.testing.assert_array_equal(At.grid_coef().numpy(), np.asarray(A.grid_coef()))
    D, Dt = A.to_dia(), At.to_dia()
    assert Dt.offsets == D.offsets
    np.testing.assert_allclose(Dt.data.numpy(), np.asarray(D.data), rtol=RTOL)
    np.testing.assert_allclose(At.todense(), A.todense(), rtol=RTOL)


def test_dia_poisson1d_matches_jax():
    A = jfx.poisson1d(50)
    At = from_jax_operator(A)
    assert isinstance(At, DiaMatrix)
    assert (At.offsets, At.shape, At.nnz, At.bandwidth) == (A.offsets, A.shape, A.nnz, A.bandwidth)
    x = _x(50, seed=3)
    np.testing.assert_allclose(
        At.matvec(torch.from_numpy(x)).numpy(), np.asarray(A.matvec(jnp.asarray(x))), rtol=RTOL
    )
    np.testing.assert_array_equal(At.todense(), A.todense())


@pytest.mark.parametrize(
    "port, ref",
    [
        (lambda: fixtures.poisson1d(30), lambda: jfx.poisson1d(30)),
        (lambda: fixtures.laplace2d(7, 5), lambda: jfx.laplace2d(7, 5)),
        (lambda: fixtures.laplace2d(7, 5, constant=True), lambda: jfx.laplace2d(7, 5, constant=True)),
        (lambda: fixtures.laplace3d(4, 3, 5), lambda: jfx.laplace3d(4, 3, 5)),
        (lambda: fixtures.laplace3d(4, 3, 5, constant=True), lambda: jfx.laplace3d(4, 3, 5, constant=True)),
    ],
    ids=["poisson1d", "laplace2d", "laplace2d-const", "laplace3d", "laplace3d-const"],
)
def test_fixtures_match_jax(port, ref):
    At, A = port(), ref()
    assert type(At).__name__ == type(A).__name__
    assert At.dtype == torch.float64 and At.device.type == "cpu"
    if isinstance(At, StencilMatrix):
        assert (At.stencil, At.grid) == (A.stencil, A.grid)
        np.testing.assert_array_equal(At.coef.numpy(), np.asarray(A.coef))
    else:
        assert (At.offsets, At.shape) == (A.offsets, A.shape)
        np.testing.assert_array_equal(At.data.numpy(), np.asarray(A.data))


def test_fixture_dtype_and_device_arguments():
    A = fixtures.laplace2d(6, dtype=torch.float32, constant=True, device="cpu")
    assert A.dtype == torch.float32 and A.coef.device.type == "cpu"
    B = to_device(fixtures.poisson1d(8), "cpu")
    assert B.device.type == "cpu" and dataclasses.is_dataclass(B)


def test_as_operator_passes_port_containers_and_rejects_others():
    A = fixtures.laplace2d(4)
    assert as_operator(A) is A
    D = as_operator(np.eye(4))
    assert isinstance(D, DenseMatrix) and D.device.type == "cpu"
    np.testing.assert_array_equal(D.data.numpy(), np.eye(4))
    with pytest.raises(TypeError, match="from_jax_operator"):
        as_operator(jfx.laplace2d(4))


def test_from_jax_operator_dtype_cast():
    At = from_jax_operator(jfx.laplace2d(5), dtype=torch.float32)
    assert At.dtype == torch.float32
    E = jfx.random_spd_ell(16)
    Et = from_jax_operator(E, dtype=torch.float32)
    assert isinstance(Et, EllMatrix) and Et.dtype == torch.float32 and Et.indices.dtype == torch.int32
    np.testing.assert_array_equal(Et.indices.numpy(), np.asarray(E.indices))
    np.testing.assert_array_equal(Et.data.numpy(), np.asarray(E.data).astype(np.float32))
    with pytest.raises(TypeError, match="krylov_tpu container"):
        from_jax_operator(object())
