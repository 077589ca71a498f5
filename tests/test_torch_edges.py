"""Edge-case and fuzz battery of the PyTorch port: the port's copies of
``tests/test_edges.py`` (degenerate shapes) and ``tests/test_fuzz.py``
(randomized structure x format x dtype), on the CPU through the kernels'
plain twins, against the float64 host oracle ``CSR.spmv_host``.

Tolerance: ``allclose_spmv`` at the result's type (1e-4 float32, 1e-8
float64) with the backward-error scale ``|A| |x|``, as everywhere in the
port. ``SparseMatrix.diagonal()`` is held against the reference's on a
symmetric and on a general matrix.
"""

import numpy as np
import pytest
import torch

import cfs_spmv_tpu as ref
from cfs_spmv_tpu_torch import COO, CSR, Format, SparseMatrix, SpDMV, Tuning
from cfs_spmv_tpu_torch.tuning.tune import tune
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

from conftest import random_x

torch.set_num_threads(1)


def _check(csr, fmt, dtype=np.float32):
    t = tune(csr, fmt=fmt, dtype=dtype, device="cpu")
    x = random_x(csr.ncols, dtype)
    y = t.matvec(torch.from_numpy(x)).numpy()
    xd = x.astype(np.float64)
    assert y.shape == (csr.nrows,) and y.dtype == dtype
    assert allclose_spmv(
        y, csr.spmv_host(xd), dtype,
        nnz_per_row=max(csr.nnz, 1) / max(csr.nrows, 1),
        scale=csr.spmv_host(xd, absolute=True),
    )
    return y


def _one_by_one():
    return CSR.from_coo(COO(1, 1, np.array([0]), np.array([0]),
                            np.array([2.5]), symmetric=True)), Format.SSS


def _empty_rows_and_cols():
    """Rows with no entries and untouched columns."""
    rng = np.random.default_rng(0)
    n = 700
    r = rng.integers(0, n // 3, 900)  # only the first third of rows
    c = rng.integers(0, n, 900)
    keep = r >= c
    coo = COO(n, n, r[keep], c[keep], rng.uniform(1, 2, keep.sum()),
              symmetric=True)
    return CSR.from_coo(coo.canonicalize()), Format.SSS


def _rectangular(nrows, ncols, deg, seed):
    return lambda: (CSR.from_coo(COO.random(nrows, ncols, deg, seed=seed,
                                            dtype=np.float64)), Format.CSR)


def _odd_size(n):
    """Dimensions straddling tile boundaries."""
    return lambda: (CSR.from_coo(COO.random(
        n, n, 3.0, symmetric=True, bandwidth=20, seed=n, dtype=np.float64)),
        Format.SSS)


def _single_dense_row():
    """One fully dense row (a sparse far residual with one long row: 600
    entries through ``compact_stream``)."""
    n = 600
    coo = COO(n, n, np.full(n, n - 1, np.int64), np.arange(n, dtype=np.int64),
              np.random.default_rng(3).uniform(1, 2, n),
              symmetric=True).canonicalize()
    return CSR.from_coo(coo), Format.SSS


EDGES = {
    "one_by_one": _one_by_one,
    "empty_rows_and_cols": _empty_rows_and_cols,
    "rectangular_wide": _rectangular(300, 1000, 4.0, 1),
    "rectangular_tall": _rectangular(1000, 130, 3.0, 2),
    **{f"odd_size_{n}": _odd_size(n) for n in (127, 128, 129, 1023, 1025)},
    "single_dense_row": _single_dense_row,
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_shapes(name, dtype):
    csr, fmt = EDGES[name]()
    _check(csr, fmt, dtype)


@pytest.mark.parametrize("fmt", [Format.SSS, Format.CSR],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_empty_matrix(dtype, fmt):
    csr = CSR(40, 40, np.zeros(41, np.int64), np.zeros(0, np.int32),
              np.zeros(0, np.float64), symmetric=fmt is Format.SSS)
    t = tune(csr, fmt=fmt, dtype=dtype, device="cpu")
    y = t.matvec(torch.ones(40, dtype=t.dtype))
    assert y.dtype == t.dtype
    np.testing.assert_array_equal(y.numpy(), np.zeros(40))
    Y = t.matmat(torch.ones((40, 3), dtype=t.dtype))
    np.testing.assert_array_equal(Y.numpy(), np.zeros((40, 3)))


def test_spmm_single_rhs_column():
    coo = COO.random(400, 400, 4.0, symmetric=True, bandwidth=30, seed=4,
                     dtype=np.float64)
    A = SparseMatrix.create(coo, Format.SSS)
    sp = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32, device="cpu")
    X = random_x(400, np.float32)[:, None]  # (n, 1)
    Y = sp(X).numpy()
    assert Y.shape == (400, 1)
    y1 = sp(X[:, 0]).numpy()
    # mm and mv kernels sum in different orders: fp32 rounding only
    np.testing.assert_allclose(Y[:, 0], y1, rtol=1e-5, atol=1e-5)


def test_duplicate_coordinates_summed():
    r = np.array([0, 0, 1, 1, 1])
    c = np.array([0, 0, 0, 1, 1])
    v = np.array([1.0, 2.0, 5.0, 3.0, 4.0])
    csr = CSR.from_coo(COO(2, 2, r, c, v, symmetric=True).canonicalize())
    assert csr.nnz == 3
    y = _check(csr, Format.SSS)
    # A = [[3, 5], [5, 7]]
    np.testing.assert_allclose(
        y, np.array([[3.0, 5.0], [5.0, 7.0]])
        @ np.asarray(random_x(2, np.float32), np.float64), rtol=1e-5)


CASES = []
for _seed in range(6):
    _rng = np.random.default_rng(1000 + _seed)
    CASES.append(dict(
        n=int(_rng.integers(80, 2500)),
        deg=float(_rng.uniform(1.5, 10.0)),
        bandwidth=(None if _rng.uniform() < 0.3
                   else int(_rng.integers(4, 400))),
        symmetric=bool(_rng.uniform() < 0.6),
        seed=_seed,
    ))


def _fuzz_matrix(case):
    coo = COO.random(
        case["n"], case["n"], case["deg"], symmetric=case["symmetric"],
        bandwidth=case["bandwidth"], seed=case["seed"], dtype=np.float64,
    )
    return (CSR.from_coo(coo),
            Format.SSS if case["symmetric"] else Format.CSR)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['seed']}")
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_fuzz_matvec(case, dtype):
    csr, fmt = _fuzz_matrix(case)
    t = tune(csr, fmt=fmt, dtype=dtype, device="cpu")
    x = random_x(csr.ncols, dtype, seed=case["seed"])
    y = t.matvec(torch.from_numpy(x)).numpy()
    xd = x.astype(np.float64)
    assert allclose_spmv(
        y, csr.spmv_host(xd), dtype,
        nnz_per_row=t.nnz_full / max(csr.nrows, 1),
        scale=csr.spmv_host(xd, absolute=True),
    ), f"case {case} dtype {dtype}"


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: f"s{c['seed']}")
def test_fuzz_spmm(case):
    csr, fmt = _fuzz_matrix(case)
    t = tune(csr, fmt=fmt, device="cpu")
    B = 3
    X = np.stack(
        [random_x(csr.ncols, np.float32, seed=b) for b in range(B)], 1
    )
    Y = t.matmat(torch.from_numpy(X)).numpy()
    for b in range(B):
        xd = X[:, b].astype(np.float64)
        assert allclose_spmv(
            Y[:, b], csr.spmv_host(xd), np.float32,
            nnz_per_row=t.nnz_full / max(csr.nrows, 1),
            scale=csr.spmv_host(xd, absolute=True),
        )


def _ref_csr(csr):
    return ref.CSR(csr.nrows, csr.ncols, csr.indptr, csr.indices, csr.data,
                   csr.symmetric)


@pytest.mark.parametrize("name", ["symmetric", "general_wide",
                                  "general_tall"])
def test_diagonal_matches_reference(name):
    """``SparseMatrix.diagonal()`` against the reference's, on symmetric
    storage (the stored diagonal) and on general storage of both
    rectangular shapes, where rows lack a diagonal entry."""
    if name == "symmetric":
        csr, fmt = _odd_size(1025)()
    else:
        csr, fmt = EDGES[f"rectangular_{name[8:]}"]()
        # plant a few diagonal entries: a random rectangle has hardly any
        coo = csr.to_coo()
        k = np.arange(0, min(csr.nrows, csr.ncols), 7)
        coo = COO(csr.nrows, csr.ncols, np.concatenate([coo.row, k]),
                  np.concatenate([coo.col, k]),
                  np.concatenate([coo.val, np.full(len(k), 3.5)]))
        csr = CSR.from_coo(coo.canonicalize())
    got = SparseMatrix.create(csr, fmt).diagonal()
    want = ref.SparseMatrix.create(_ref_csr(csr), ref.Format[fmt.name])
    want = want.diagonal()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) and np.count_nonzero(got) > 0
