"""krylov_tpu_torch irregular operators (ELL, HYB, dense), conversions,
fixtures, IO and the native binding against krylov_tpu.

Operators are built by the JAX package (or from the same scipy matrix by
both packages) and carried across with ``from_jax_operator``; inputs come
from seeded numpy.  Conversions, fixtures, loaders and the host float64
matvec give the JAX package's arrays exactly.  Matvecs are float64: the
batched matvec runs the solo one's sums per member (rtol 1e-13 against a
loop of solo matvecs) and holds the JAX container's within rtol 1e-12.
Solves follow tests/test_torch_solve.py: equal iteration counts and nosl,
residual histories rtol 1e-9 (atol 1e-13), x rtol 1e-8; the k-skip family
those of tests/test_torch_kskip_solve.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import krylov_tpu
import krylov_tpu_torch
from krylov_tpu import native as jnative
from krylov_tpu.sparse import convert as jconvert
from krylov_tpu.sparse import fixtures as jfx
from krylov_tpu.sparse import io as jio
from krylov_tpu_torch import native
from krylov_tpu_torch.sparse import (
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    StencilMatrix,
    as_operator,
    convert,
    fixtures,
    io,
    to_device,
)
from krylov_tpu_torch.sparse.convert import from_jax_operator


def _skewed(n=600, **kw):
    return jfx.powerlaw_spd(n, seed=11, max_deg=n // 4, **kw)


def _uniform(n=300, d=7, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), d)
    cols = rng.integers(0, n, size=rows.size)
    A = sp.coo_matrix((rng.uniform(1, 2, rows.size), (rows, cols)), shape=(n, n))
    return ((A + A.T).tocsr() + sp.eye(n) * 50.0).tocsr()


OPERATORS = {
    "dia": lambda: jfx.poisson1d(40),
    "stencil2d": lambda: jfx.laplace2d(7, 5),
    "stencil3d-const": lambda: jfx.laplace3d(4, 3, 5, constant=True),
    "ell": lambda: jfx.random_spd_ell(60, row_nnz=6, seed=2),
    "hyb": lambda: jconvert.to_hyb(_skewed(300)),
    "dense": lambda: jconvert.to_dense(jfx.random_spd_ell(30, seed=4).todense()),
}


def _fields_equal(At, A):
    """Every field of the port's container equals the JAX container's."""
    assert type(At).__name__ == type(A).__name__
    for f in dataclasses.fields(At):
        got, want = getattr(At, f.name), getattr(A, f.name)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.as_tensor(np.array(want)).dtype, f.name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
        else:
            assert tuple(got) == tuple(want), f.name


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_batched_matvec_matches_solo_and_jax(name):
    A = OPERATORS[name]()
    At = from_jax_operator(A)
    X = np.random.default_rng(5).standard_normal((3, A.shape[0]))
    Y = At.matvec(torch.from_numpy(X)).numpy()
    assert Y.shape == X.shape
    solo = np.stack([At.matvec(torch.from_numpy(x)).numpy() for x in X])
    np.testing.assert_allclose(Y, solo, rtol=1e-13, atol=1e-13 * np.abs(solo).max())
    Y_jax = np.asarray(jax.vmap(A.matvec)(jnp.asarray(X)))
    np.testing.assert_allclose(Y, Y_jax, rtol=1e-12, atol=1e-12 * np.abs(Y_jax).max())


@pytest.mark.parametrize("name", ["ell", "hyb", "dense"])
def test_irregular_containers_match_jax(name):
    A = OPERATORS[name]()
    At = from_jax_operator(A)
    _fields_equal(At, A)
    assert (At.shape, At.nnz, At.dtype, At.device.type) == (tuple(A.shape), A.nnz, torch.float64, "cpu")
    for prop in ("width", "tail_width", "stored_entries"):
        if hasattr(A, prop):
            assert getattr(At, prop) == getattr(A, prop)
    np.testing.assert_array_equal(At.todense(), A.todense())
    x = np.random.default_rng(6).standard_normal(A.shape[0])
    np.testing.assert_allclose(
        At.matvec(torch.from_numpy(x)).numpy(), np.asarray(A.matvec(jnp.asarray(x))), rtol=1e-12,
        atol=1e-14,
    )
    assert from_jax_operator(A, dtype=np.float32).dtype == torch.float32


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_to_device_and_host_matvec64_match_jax(name):
    A = OPERATORS[name]()
    At = to_device(from_jax_operator(A), "cpu")
    x = np.random.default_rng(7).standard_normal(A.shape[0])
    np.testing.assert_array_equal(convert.host_matvec64(At, x), jconvert.host_matvec64(A, x))
    np.testing.assert_array_equal(convert.host_matvec64(At, torch.from_numpy(x)), jconvert.host_matvec64(A, x))


@pytest.mark.parametrize(
    "make",
    [_skewed, _uniform, lambda: sp.csr_matrix(jfx.poisson1d(50).todense()), lambda: _skewed(300, shift=1e-3)],
    ids=["skewed", "uniform", "banded", "skewed-shift"],
)
def test_converters_match_jax(make):
    csr = make()
    row_nnz = np.diff(csr.indptr)
    for tw in (8, 32):
        assert convert.hyb_split_width(row_nnz, tw) == jconvert.hyb_split_width(row_nnz, tw)
    assert convert.analyze(csr).keys() == jconvert.analyze(csr).keys()
    for key, v in jconvert.analyze(csr).items():
        np.testing.assert_array_equal(convert.analyze(csr)[key], v)
    _fields_equal(convert.from_scipy(csr), jconvert.from_scipy(csr))
    _fields_equal(convert.to_dia(csr), jconvert.to_dia(csr))
    _fields_equal(convert.to_ell(csr), jconvert.to_ell(csr))
    _fields_equal(convert.to_ell(csr, width=int(row_nnz.max()) + 2), jconvert.to_ell(csr, width=int(row_nnz.max()) + 2))
    _fields_equal(convert.to_hyb(csr), jconvert.to_hyb(csr))
    _fields_equal(convert.to_hyb(csr, width=3, tail_width=8, tail_multiple=4),
                  jconvert.to_hyb(csr, width=3, tail_width=8, tail_multiple=4))
    _fields_equal(convert.to_dense(csr), jconvert.to_dense(csr))
    # dtype: numpy or torch
    for dt in (np.float32, torch.float32):
        H = convert.to_hyb(csr, dtype=dt)
        assert H.dtype == torch.float32 and H.ell_indices.dtype == torch.int32
        np.testing.assert_array_equal(H.ell_data.numpy(), np.asarray(jconvert.to_hyb(csr, dtype=np.float32).ell_data))


def test_from_scipy_choices_match_jax():
    assert isinstance(convert.from_scipy(_skewed()), HybMatrix)
    assert isinstance(convert.from_scipy(_uniform()), EllMatrix)
    assert isinstance(convert.from_scipy(sp.csr_matrix(jfx.poisson1d(50).todense())), DiaMatrix)
    for csr in (_skewed(), _uniform()):
        assert type(convert.from_scipy(csr)).__name__ == type(jconvert.from_scipy(csr)).__name__


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_pad_to_multiple_matches_jax(name):
    A = OPERATORS[name]()
    b = np.random.default_rng(8).standard_normal(A.shape[0])
    Ap, bp, n = jconvert.pad_to_multiple(A, b, 16)
    Atp, btp, nt = convert.pad_to_multiple(from_jax_operator(A), torch.from_numpy(b), 16)
    assert nt == n and Atp.shape == tuple(Ap.shape)
    _fields_equal(Atp, Ap)
    np.testing.assert_array_equal(btp.numpy(), bp)


@pytest.mark.parametrize(
    "port, ref",
    [
        (lambda: fixtures.random_spd_ell(200, seed=3), lambda: jfx.random_spd_ell(200, seed=3)),
        (lambda: fixtures.random_spd_ell(150, row_nnz=5, seed=1, dtype=np.float32),
         lambda: jfx.random_spd_ell(150, row_nnz=5, seed=1, dtype=np.float32)),
    ],
    ids=["f64", "f32"],
)
def test_random_spd_ell_bitwise(port, ref):
    _fields_equal(port(), ref())


@pytest.mark.parametrize(
    "kw",
    [dict(n=2000), dict(n=1500, seed=4, avg_deg=6, alpha=1.8), dict(n=1000, shift=1e-3, diag_scale_decades=1.5),
     dict(n=800, dtype=np.float32)],
    ids=["default", "params", "row4b", "f32"],
)
def test_powerlaw_spd_bitwise(kw):
    A, Aj = fixtures.powerlaw_spd(**kw), jfx.powerlaw_spd(**kw)
    assert sp.issparse(A) and A.format == "csr" and A.dtype == Aj.dtype
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(A, attr), getattr(Aj, attr))


def test_rhs_fixtures_match_jax():
    A = jfx.random_spd_ell(50, seed=5)
    x = np.random.default_rng(9).standard_normal(50)
    b = fixtures.rhs_for_solution(from_jax_operator(A), x)
    assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
    np.testing.assert_array_equal(b.numpy(), jfx.rhs_for_solution(A, x))
    csr = _skewed(300)
    np.testing.assert_array_equal(fixtures.rhs_for_solution(csr, torch.from_numpy(x[:1]).repeat(300)).numpy(),
                                  jfx.rhs_for_solution(csr, np.full(300, x[0])))
    np.testing.assert_array_equal(fixtures.ones_rhs(7, dtype=np.float32).numpy(), jfx.ones_rhs(7, dtype=np.float32))


def _sym_coo(n, density, seed):
    m = sp.random(n, n, density=density, random_state=np.random.RandomState(seed))
    m = (m + m.T).tolil()
    m.setdiag(np.abs(m).sum(axis=1).A1 + 1.0)
    return m.tocoo()


@pytest.mark.parametrize("prefer", ["auto", "dia", "ell", "hyb", "dense"])
@pytest.mark.parametrize("source", ["random", "banded", "skewed"])
def test_load_mtx_and_npz_match_jax(tmp_path, prefer, source):
    coo = {
        "random": lambda: _sym_coo(40, 0.1, 3),
        "banded": lambda: sp.diags([np.full(37, -1.0), np.full(40, 4.0), np.full(37, -1.0)], [-3, 0, 3]).tocoo(),
        "skewed": lambda: _skewed(300).tocoo(),
    }[source]()
    mtx, npz = str(tmp_path / "a.mtx"), str(tmp_path / "a.npz")
    scipy.io.mmwrite(mtx, coo, symmetry="general")
    sp.save_npz(npz, coo.tocsr())
    for port, ref in ((io.load_mtx, jio.load_mtx), (io.load_npz, jio.load_npz)):
        path = mtx if port is io.load_mtx else npz
        if (port, source, prefer) == (io.load_mtx, "skewed", "dia"):
            # the native DIA packer takes at most 512 diagonals, in both packages
            for load in (port, ref):
                with pytest.raises(ValueError, match="512 distinct diagonals"):
                    load(path, prefer=prefer)
            continue
        At, A = port(path, prefer=prefer), ref(path, prefer=prefer)
        _fields_equal(At, A)
        np.testing.assert_array_equal(At.todense(), coo.toarray())
    assert io.load_npz(npz, dtype=torch.float32, prefer=prefer).dtype == torch.float32


def test_load_npy_and_bad_prefer_match_jax(tmp_path):
    dense = _sym_coo(20, 0.2, 5).toarray()
    path = str(tmp_path / "a.npy")
    np.save(path, dense)
    D = io.load_npy(path)
    assert isinstance(D, DenseMatrix)
    np.testing.assert_array_equal(D.data.numpy(), np.asarray(jio.load_npy(path).data))
    assert io.load_npy(path, dtype=torch.float32).dtype == torch.float32
    sp.save_npz(str(tmp_path / "a.npz"), sp.csr_matrix(dense))
    with pytest.raises(ValueError, match="unknown prefer"):
        io.load_npz(str(tmp_path / "a.npz"), prefer="csr")


def test_native_binding_matches_jax(tmp_path):
    assert native.available() == jnative.available()
    assert native.load_error is None
    coo = _sym_coo(50, 0.08, 5)
    path = str(tmp_path / "s.mtx")
    scipy.io.mmwrite(path, coo, symmetry="symmetric")
    got, want = native.read_mtx(path), jnative.read_mtx(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rows, cols, vals, shape = want
    csr_t, csr_j = native.coo_to_csr(shape[0], rows, cols, vals), jnative.coo_to_csr(shape[0], rows, cols, vals)
    for g, w in zip(csr_t, csr_j):
        np.testing.assert_array_equal(g, w)
    indptr, indices, data = csr_j
    for g, w in zip(native.csr_to_ell(shape[0], indptr, indices, data),
                    jnative.csr_to_ell(shape[0], indptr, indices, data)):
        np.testing.assert_array_equal(g, w)
    band = sp.diags([np.full(37, -1.0), np.full(40, 4.0), np.full(37, -1.0)], [-3, 0, 3]).tocsr()
    args = (40, band.indptr.astype(np.int64), band.indices.astype(np.int32), band.data)
    for g, w in zip(native.csr_to_dia(*args), jnative.csr_to_dia(*args)):
        np.testing.assert_array_equal(g, w)


def test_native_fallbacks_match_library(tmp_path, monkeypatch):
    """Without the library the numpy/scipy fallbacks give the same arrays."""
    coo = _sym_coo(30, 0.12, 4)
    path = str(tmp_path / "g.mtx")
    scipy.io.mmwrite(path, coo, symmetry="general")
    with_lib = native.read_mtx(path)
    rows, cols, vals, shape = with_lib
    csr_lib = native.coo_to_csr(shape[0], rows, cols, vals)
    ell_lib = native.csr_to_ell(shape[0], *csr_lib)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    r2, c2, v2, s2 = native.read_mtx(path)
    np.testing.assert_array_equal(sp.coo_matrix((v2, (r2, c2)), shape=s2).toarray(),
                                  sp.coo_matrix((vals, (rows, cols)), shape=shape).toarray())
    csr_np = native.coo_to_csr(shape[0], rows, cols, vals)
    np.testing.assert_array_equal(sp.csr_matrix(csr_np[::-1], shape=shape).toarray(),
                                  sp.csr_matrix(csr_lib[::-1], shape=shape).toarray())
    ell_np = native.csr_to_ell(shape[0], *csr_np)
    dense = [np.zeros(shape), np.zeros(shape)]
    for out, (d, i) in zip(dense, (ell_np, ell_lib)):
        np.add.at(out, (np.arange(shape[0])[:, None], i), d)
    np.testing.assert_array_equal(dense[0], dense[1])


def test_as_operator_takes_scipy_numpy_and_torch():
    csr = _skewed(300)
    H = as_operator(csr)
    assert isinstance(H, HybMatrix) and H.device.type == "cpu"
    _fields_equal(H, jconvert.from_scipy(csr))
    assert as_operator(csr, dtype=torch.float32).dtype == torch.float32
    dense = csr.toarray()
    for arr in (dense, torch.from_numpy(dense)):
        D = as_operator(arr)
        assert isinstance(D, DenseMatrix) and D.dtype == torch.float64
        np.testing.assert_array_equal(D.data.numpy(), dense)
    assert as_operator(dense, dtype=np.float32).dtype == torch.float32
    assert as_operator(dense, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="2-D"):
        as_operator(np.ones(4))
    with pytest.raises(TypeError, match="from_jax_operator"):
        as_operator(jconvert.to_hyb(csr))
    A = fixtures.laplace2d(4)
    assert as_operator(A) is A and isinstance(A, StencilMatrix)


# the k-skip family: the tolerances of tests/test_torch_kskip_solve.py (its
# k-step recurrences amplify the rounding of the bundle sums)
SOLVE_TOLS = {"cg": (1e-9, 1e-13, 1e-8, 1e-12), "mrr": (1e-9, 1e-13, 1e-8, 1e-12)}
KSKIP_TOLS = (1e-5, 1e-11, 1e-6, 1e-9)


def _compare_solve(A_port, A_ref, b, method, **kw):
    xr, ir = krylov_tpu.solve(A_ref, b, method=method, **kw)
    x, info = krylov_tpu_torch.solve(A_port, b, method=method, **kw)
    assert (info["iterations"], info["converged"]) == (ir["iterations"], ir["converged"])
    np.testing.assert_array_equal(info["nosl"], ir["nosl"])
    if "khistory" in ir:
        np.testing.assert_array_equal(info["khistory"], ir["khistory"])
    t_rtol, t_atol, x_rtol, x_atol = SOLVE_TOLS.get(method, KSKIP_TOLS)
    np.testing.assert_allclose(info["residual"], ir["residual"], rtol=t_rtol, atol=t_atol)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=x_rtol, atol=x_atol)
    return info


@pytest.mark.parametrize("method, k", [("cg", 0), ("mrr", 0), ("kskipcg", 2), ("kskipmrr", 3),
                                       ("adaptivekskipmrr", 4)])
@pytest.mark.parametrize("source", ["hyb", "scipy", "ell", "dense"])
def test_irregular_solve_matches_jax(source, method, k):
    csr = _skewed(400)
    b = np.random.default_rng(10).standard_normal(csr.shape[0])
    A_ref = {"hyb": jconvert.to_hyb, "scipy": lambda a: a, "ell": jconvert.to_ell,
             "dense": lambda a: jconvert.to_dense(a)}[source](csr)
    A_port = csr if source == "scipy" else from_jax_operator(A_ref)
    info = _compare_solve(A_port, A_ref, b, method, tol=1e-9, k=k)
    assert info["converged"]
