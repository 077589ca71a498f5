"""The port's float64 route against the float64 host oracle and against
the reference's double-float route (Pallas in interpret mode).

The reference reaches double precision on a chip without 64-bit lanes by
carrying fp32 (hi, lo) pairs (``ops/sdia_df.py``, ``ops/bell2_df.py``,
``tuning/tune._tune_fp64_df``); the port computes the same products in
IEEE float64 (kernels B13-B16 as the double instances of B1 and B2; on
the CPU their plain twins). The cases are the reference's own
(``tests/test_fp64_df.py``, ``tests/test_fp64_path.py``) on the same
seeded matrices, plus the twins against the reference kernels and the
user entry points.

Tolerances, each on the scaled error ``max |y - ref| / (|A| |x|)``:

- ``NATIVE_RTOL`` 1e-12 against the oracle ``CSR.spmv_host``: native
  float64 sums a row of at most a few hundred terms in another order than
  the oracle, a few 1e-16 each (the user-facing gate, ``allclose_spmv`` at
  float64, is 1e-8);
- ``DF_RTOL`` 1e-10 against the reference's results: its own bar in
  ``tests/test_fp64_df.py``, since double-float keeps about 48 bits and
  is the less precise side;
- 1e-13 relative for the plain ELL+COO path against the reference's, as
  in ``tests/test_fp64_path.py`` (both sum in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfs_spmv_tpu as ref_cfs
import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu.formats.bell2 import build_bell2_from_arrays as ref_from_arrays
from cfs_spmv_tpu.formats.coo import COO as RefCOO
from cfs_spmv_tpu.formats.csr import CSR as RefCSR
from cfs_spmv_tpu.ops import bell2_df as ref_bdf
from cfs_spmv_tpu.ops import sdia_df as ref_sdf
from cfs_spmv_tpu.ops import xla_ref as ref_xla
from cfs_spmv_tpu.ops.bell2_kernel import meta_word
from cfs_spmv_tpu.tuning import tune as ref_tune
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu.utils.platform import Format as RefFormat
from __graft_entry__ import _flagship
from cfs_spmv_tpu_torch import native as port_native
from cfs_spmv_tpu_torch.cli.test_spmv_mmf import main as run_test_cli
from cfs_spmv_tpu_torch.formats.bell2 import build_bell2_from_arrays
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.io.mmf import write_mmf
from cfs_spmv_tpu_torch.ops import bell2_df as bdf
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import sdia_df as sdf
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.ops import xla_ref
from cfs_spmv_tpu_torch.tuning import tune as port_tune
from cfs_spmv_tpu_torch.utils.config import config
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

torch.set_num_threads(1)

NATIVE_RTOL = 1e-12
DF_RTOL = 1e-10


def port_csr(ref):
    return CSR(ref.nrows, ref.ncols, ref.indptr.copy(), ref.indices.copy(),
               ref.data.copy(), ref.symmetric)


def _rel_err(y, ref, scale):
    return float(np.max(np.abs(y - ref) / np.maximum(scale, 1e-300)))


def _random(n, m, per_row, **kw):
    return RefCSR.from_coo(RefCOO.random(n, m, per_row, dtype=np.float64,
                                         **kw))


def _scattered_grouped():
    """High degree variance (one dense row): the planner may group rows by
    degree, and the applier then gathers them back through a zero."""
    rng = np.random.default_rng(4)
    n = 4096
    row = np.concatenate([np.repeat(np.arange(n, dtype=np.int64), 3),
                          np.full(600, 17, np.int64)])
    col = rng.integers(0, n, len(row))
    val = rng.uniform(-1, 1, len(row))
    return RefCSR.from_coo(RefCOO(n, n, row, col, val).canonicalize())


def _band_plus_tail():
    """A symmetric band plus a scattered strict-lower tail: the peel keeps
    the band, the tail is expanded onto the one-sided stream."""
    rng = np.random.default_rng(14)
    n = 4096
    band = RefCOO.random(n, n, 10.0, symmetric=True, bandwidth=8, seed=15,
                         dtype=np.float64)
    m = 2000
    r = rng.integers(1, n, m)
    c = (r - rng.integers(1, 900, m)).clip(0)
    swap = c > r
    r[swap], c[swap] = c[swap], r[swap].copy()
    keep = r != c
    row = np.concatenate([band.row, r[keep]])
    col = np.concatenate([band.col, c[keep]])
    val = np.concatenate([band.val, rng.uniform(-1, 1, keep.sum())])
    return RefCSR.from_coo(
        RefCOO(n, n, row, col, val, symmetric=True).canonicalize())


#: name -> (matrix, format, seed of x): the matrices of
#: ``tests/test_fp64_df.py``, case by case
MATRICES = {
    "banded": (lambda: _random(3000, 3000, 6.0, symmetric=False,
                               bandwidth=100, seed=1), "CSR", 0),
    "symmetric_expands": (lambda: _random(2000, 2000, 4.0, symmetric=True,
                                          bandwidth=60, seed=2), "SSS", 3),
    "scattered_grouped": (_scattered_grouped, "CSR", 5),
    "wide_band": (lambda: _random(4000, 4000, 10.0, symmetric=False,
                                  bandwidth=300, seed=6), "CSR", 7),
    "rectangular": (lambda: _random(900, 1400, 4.0, symmetric=False,
                                    bandwidth=200, seed=10), "CSR", 11),
    "sdia_peel_banded": (lambda: _random(5000, 5000, 14.0, symmetric=True,
                                         bandwidth=16, seed=12), "SSS", 13),
    "sdia_peel_with_residual": (_band_plus_tail, "SSS", 16),
    # the repository's flagship at test size: 9 diagonals peeled, and an
    # ungrouped residual of 4,164 entries, which travels as an entry list
    "flagship": (lambda: _flagship(n=4096, deg=16, dtype=np.float64), "SSS",
                 19),
}
#: the reference's two SpMM cases, and the flagship's entry list
MM_MATRICES = {
    "matmat": (lambda: _random(1500, 1500, 5.0, symmetric=False,
                               bandwidth=80, seed=8), "CSR", 9),
    "sdia_matmat": (lambda: _random(3000, 3000, 12.0, symmetric=True,
                                    bandwidth=12, seed=17), "SSS", 18),
    "flagship": MATRICES["flagship"],
}


def _assert_entry_route(tuned, name):
    """The flagship's residual travels as entries, with no chunk grid on
    the device; every other case of these tables keeps its grid."""
    d = tuned.operands
    if name == "flagship":
        assert tuned.plan.row_perm is None and tuned.plan.dia is not None
        assert d.entries is not None and d.vals is None and d.packed is None
        assert d.entries.count == tuned.plan.nnz == 4164
        assert d.entries.vals.dtype == torch.float64
    else:
        assert d.entries is None


def _tune_both(ref_csr, fmt):
    tuned = port_tune.tune(port_csr(ref_csr), fmt=ct.Format[fmt],
                           dtype=np.float64, device="cpu")
    ref = ref_tune._tune_fp64_df(ref_csr, RefFormat[fmt])
    assert ref is not None, "the reference plan should be word-eligible"
    return tuned, ref


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fp64_spmv_matches_oracle_and_reference(name):
    make, fmt, seed = MATRICES[name]
    ref_csr = make()
    tuned, ref = _tune_both(ref_csr, fmt)
    x = np.random.default_rng(seed).uniform(1.0, 2.0, ref_csr.ncols)
    y = tuned.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float64 and y.shape == (ref_csr.nrows,)
    y = y.numpy()
    oracle = ref_csr.spmv_host(x)
    scale = ref_csr.spmv_host(x, absolute=True)
    assert _rel_err(y, oracle, scale) < NATIVE_RTOL
    y_ref = np.asarray(ref.matvec(x))
    assert _rel_err(y, y_ref, scale) < DF_RTOL
    assert tuned.nnz_full == ref.nnz_full
    assert tuned.perm is None and tuned.bsr is None  # no RCM, no container
    _assert_entry_route(tuned, name)
    plan = tuned.plan
    if name == "sdia_peel_banded":
        assert plan.dia is not None and 0 in plan.dia.offsets
        diag = int(np.count_nonzero(
            ref_csr.indices == np.repeat(np.arange(ref_csr.nrows),
                                         np.diff(ref_csr.indptr))))
        assert tuned.nnz_full == 2 * ref_csr.nnz - diag
    if name == "sdia_peel_with_residual":
        assert plan.dia is not None and plan.nnz > 0


@pytest.mark.parametrize("B", [3, 11])
@pytest.mark.parametrize("name", sorted(MM_MATRICES))
def test_fp64_spmm_matches_oracle_and_reference(name, B):
    """B = 3 as the reference's tests; B = 11 is two plane groups."""
    make, fmt, seed = MM_MATRICES[name]
    ref_csr = make()
    tuned, ref = _tune_both(ref_csr, fmt)
    X = np.random.default_rng(seed).uniform(1.0, 2.0, (ref_csr.ncols, B))
    Y = tuned.matmat(torch.from_numpy(X))
    assert Y.dtype == torch.float64 and Y.shape == (ref_csr.nrows, B)
    _assert_entry_route(tuned, name)
    Y = Y.numpy()
    # the reference's diagonal kernel is slow in the interpreter: its
    # SpMM joins at B = 3, and at B = 11 on the one-sided stream and on
    # the flagship (nine diagonals), whose entry list is the case's point
    Y_ref = (np.asarray(ref.matmat(X))
             if B == 3 or name in ("matmat", "flagship") else None)
    for b in range(B):
        scale = ref_csr.spmv_host(X[:, b], absolute=True)
        assert _rel_err(Y[:, b], ref_csr.spmv_host(X[:, b]),
                        scale) < NATIVE_RTOL
        if Y_ref is not None:
            assert _rel_err(Y[:, b], Y_ref[:, b], scale) < DF_RTOL
        # a column of the SpMM is the SpMV of that column
        yb = tuned.matvec(torch.from_numpy(X[:, b].copy())).numpy()
        assert _rel_err(Y[:, b], yb, scale) < NATIVE_RTOL


def _scattered_symmetric():
    """A symmetric matrix with no dense diagonal but its main one, which
    holds under a quarter of the stored entries: the peel is rejected."""
    rng = np.random.default_rng(21)
    n = 4096
    row = np.repeat(np.arange(1, n, dtype=np.int64), 6)
    col = (rng.random(len(row)) * row).astype(np.int64)
    row = np.concatenate([row, np.arange(n)])
    col = np.concatenate([col, np.arange(n)])
    val = rng.uniform(-1, 1, len(row))
    return RefCSR.from_coo(
        RefCOO(n, n, row, col, val, symmetric=True).canonicalize())


#: name -> (matrix, peeled): symmetric matrices past a row ceiling of 100
PAST_CEILING = {
    "stencil27": (lambda: ref_proxies.stencil27(g=12, dtype=np.float64),
                  True),
    "scattered_symmetric": (_scattered_symmetric, False),
}


@pytest.mark.parametrize("name", sorted(PAST_CEILING))
def test_fp64_peels_past_the_old_ceiling(name, monkeypatch):
    """The float64 planner has no row ceiling: with the port's
    ``SDIA_SYM_ROWS_MAX`` at 100 (the reference's at its default), the
    1,728-row stencil still peels its 14 lower diagonals, with nothing
    left over, into planes byte-identical to the reference's plan of the
    same matrix, and ``SpDMV`` answers at B = 1 and B = 8; a matrix whose
    diagonals are too sparse still gets the expanded stream."""
    from cfs_spmv_tpu_torch.formats import sdia as port_sdia

    monkeypatch.setattr(port_sdia, "SDIA_SYM_ROWS_MAX", 100)
    make, peeled = PAST_CEILING[name]
    ref_csr = make()
    assert ref_csr.nrows > port_sdia.SDIA_SYM_ROWS_MAX
    plan = port_tune.build_fp64_plan(port_csr(ref_csr))
    if not peeled:
        assert plan.dia is None
        assert plan.nnz == 2 * ref_csr.nnz - ref_csr.nrows  # full diagonal
        return
    assert plan.dia is not None and plan.nnz == 0
    rows = np.repeat(np.arange(ref_csr.nrows), np.diff(ref_csr.indptr))
    lower = set(np.unique(rows - ref_csr.indices).tolist())
    assert set(plan.dia.offsets) == lower and 0 in lower
    assert len(lower) == 14
    ref_dia = ref_tune._tune_fp64_df(ref_csr, RefFormat.SSS).plan.dia
    assert plan.dia.offsets == ref_dia.offsets
    assert plan.dia.nnz == ref_dia.nnz
    assert plan.dia.vals.dtype == ref_dia.vals.dtype == np.float64
    assert plan.dia.vals.tobytes() == ref_dia.vals.tobytes()

    A = ct.SparseMatrix.create(port_csr(ref_csr), ct.Format.SSS)
    op = ct.SpDMV(A, dtype=np.float64, device="cpu")
    assert A.tuned.plan.dia is not None  # the plan the apply runs
    X = np.random.default_rng(22).uniform(-1.0, 1.0, (ref_csr.ncols, 8))
    y = op(torch.from_numpy(X[:, 0].copy())).numpy()
    scale = ref_csr.spmv_host(X[:, 0], absolute=True)
    assert _rel_err(y, ref_csr.spmv_host(X[:, 0]), scale) < NATIVE_RTOL
    Y = op(torch.from_numpy(X)).numpy()
    for b in range(8):
        scale = ref_csr.spmv_host(X[:, b], absolute=True)
        assert _rel_err(Y[:, b], ref_csr.spmv_host(X[:, b]),
                        scale) < NATIVE_RTOL


@pytest.mark.parametrize("rows_per_pass", [7, 1 << 16])
def test_diagonal_count_in_any_column_order(rows_per_pass):
    """``nnz_full`` of a peeled plan counts the stored diagonal entries
    pass by pass: the same count as one row index per entry, with the
    columns of each row shuffled, a diagonal entry stored twice and rows
    without one."""
    ref = _random(500, 500, 6.0, symmetric=True, bandwidth=30, seed=23)
    rng = np.random.default_rng(24)
    indices = ref.indices.copy()
    for r in range(ref.nrows):
        seg = indices[ref.indptr[r]:ref.indptr[r + 1]]
        seg[:] = seg[rng.permutation(len(seg))]
    indptr = ref.indptr.copy()
    rows = np.repeat(np.arange(ref.nrows), np.diff(indptr))
    assert np.count_nonzero(indices == rows) == ref.nrows  # a full diagonal
    on = np.flatnonzero(indices == rows)
    indices[on[10]] = 0  # row 10 loses its diagonal entry
    # row 40 stores (40, 40) twice
    indices[on[40] + 1 if rows[on[40] + 1] == 40 else on[40] - 1] = 40
    expect = int(np.count_nonzero(indices == rows))
    assert expect == ref.nrows and np.any(np.diff(indices) < 0)
    csr = CSR(ref.nrows, ref.ncols, indptr, indices, ref.data.copy(), True)
    assert port_tune._diagonal_entries(csr, rows_per_pass) == expect


def test_fp64_beats_fp32_precision():
    """The point of the route: the same matrix through float32 storage has
    a backward error near 1e-8..1e-7 (scaled); float64 must be at least
    four orders tighter."""
    make, fmt, seed = MATRICES["wide_band"]
    csr = port_csr(make())
    x = np.random.default_rng(seed).uniform(1.0, 2.0, csr.ncols)
    oracle = csr.spmv_host(x)
    scale = csr.spmv_host(x, absolute=True)
    A = ct.SparseMatrix.create(csr, ct.Format.CSR)
    y64 = ct.SpDMV(A, dtype=np.float64, device="cpu")(x).numpy()
    y32 = ct.SpDMV(A, dtype=np.float32, device="cpu")(x).numpy()
    err64 = _rel_err(y64, oracle, scale)
    err32 = _rel_err(y32.astype(np.float64), oracle, scale)
    assert err64 < 1e-4 * err32, (err64, err32)


@pytest.mark.parametrize("path", ["df", "xla"])
def test_fp64_config_knob(path, monkeypatch):
    """``CFS_FP64`` selects the float64 route: "df" the native kernels'
    applier, "xla" the plain ELL+COO path, and nothing else selects it."""
    monkeypatch.setattr(config, "fp64_path", path)
    csr = port_csr(MATRICES["symmetric_expands"][0]())
    tuned = port_tune.tune(csr, fmt=ct.Format.SSS, dtype=np.float64,
                           device="cpu")
    if path == "df":
        assert isinstance(tuned.operands, ops.Fp64Device)
        assert tuned._apply_mv is ops.fp64_apply
    else:
        assert isinstance(tuned.plan, port_tune.CooDevicePlan)
        assert set(tuned.operands) == {"ecol", "evals", "row", "col", "val"}
    x = np.random.default_rng(1).uniform(1.0, 2.0, csr.ncols)
    y = tuned.matvec(torch.from_numpy(x)).numpy()
    assert _rel_err(y, csr.spmv_host(x),
                    csr.spmv_host(x, absolute=True)) < NATIVE_RTOL
    assert tuned.stream_bytes() > 0


def test_fp64_bad_config_value_raises(monkeypatch):
    monkeypatch.setattr(config, "fp64_path", "emulated")
    csr = port_csr(MATRICES["symmetric_expands"][0]())
    with pytest.raises(ValueError, match="CFS_FP64"):
        port_tune.tune(csr, dtype=np.float64, device="cpu")
    # float32 does not read the knob
    port_tune.tune(csr, dtype=np.float32, device="cpu")


# -- the plain ELL+COO path (tests/test_fp64_path.py) ----------------------

def _skewed(n=700, per_row=5, dense_rows=(3, 77), dense_len=200, seed=0):
    """Background rows of ~5 nnz plus two dense rows that overflow the
    4x-mean ELL width into the COO remainder."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(n, dtype=np.int64), per_row)
    col = rng.integers(0, n, n * per_row)
    for r in dense_rows:
        row = np.concatenate([row, np.full(dense_len, r)])
        col = np.concatenate([col, rng.choice(n, dense_len, replace=False)])
    val = rng.uniform(0.5, 1.5, len(row))
    return RefCOO(n, n, row.astype(np.int64), col.astype(np.int64),
                  val).canonicalize()


def test_build_ell_hyb_partition():
    coo = _skewed()
    n = coo.nrows
    got = xla_ref.build_ell_hyb(coo.row, coo.col, coo.val, n)
    want = ref_xla.build_ell_hyb(coo.row, coo.col, coo.val, n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ecol, evals, rr, rc, rv = got
    counts = np.bincount(coo.row, minlength=n)
    L = ecol.shape[1]
    assert L < counts.max()  # the dense rows overflow
    assert (evals != 0).sum() + len(rv) == coo.nnz
    assert set(np.unique(rr)) == set(np.where(counts > L)[0])
    x = np.random.default_rng(1).uniform(1, 2, n)
    y = xla_ref.ell_spmv(torch.from_numpy(ecol), torch.from_numpy(evals),
                         torch.from_numpy(x))
    y = y + xla_ref.coo_spmv(torch.from_numpy(rr), torch.from_numpy(rc),
                             torch.from_numpy(rv), torch.from_numpy(x),
                             nrows=n)
    np.testing.assert_allclose(y.numpy(), RefCSR.from_coo(coo).spmv_host(x),
                               rtol=1e-13)
    empty = xla_ref.build_ell_hyb(coo.row[:0], coo.col[:0], coo.val[:0], n)
    assert empty[0].shape == (n, 0) and len(empty[2]) == 0


def test_ell_spmm_matches_spmv_and_reference():
    coo = _skewed(seed=2)
    n = coo.nrows
    ecol, evals, rr, rc, rv = xla_ref.build_ell_hyb(coo.row, coo.col,
                                                    coo.val, n)
    X = np.random.default_rng(3).uniform(1, 2, (n, 3))
    te, tv, tX = (torch.from_numpy(a) for a in (ecol, evals, X))
    Y = xla_ref.ell_spmm(te, tv, tX).numpy()
    np.testing.assert_allclose(
        Y, np.asarray(ref_xla.ell_spmm_xla(ecol, evals, X)), rtol=1e-13)
    Yc = xla_ref.coo_spmm(torch.from_numpy(rr), torch.from_numpy(rc),
                          torch.from_numpy(rv), tX, nrows=n).numpy()
    np.testing.assert_allclose(
        Yc, np.asarray(ref_xla.coo_spmm_xla(rr, rc, rv, X, nrows=n)),
        rtol=1e-13, atol=1e-300)
    for b in range(3):
        yb = xla_ref.ell_spmv(te, tv, tX[:, b]).numpy()
        np.testing.assert_allclose(Y[:, b], yb, rtol=1e-13)


def test_tune_fp64_xla_applier():
    ref_csr = RefCSR.from_coo(_skewed(seed=4))
    tuned = port_tune._tune_fp64_xla(port_csr(ref_csr), ct.Format.CSR,
                                     torch.device("cpu"))
    ref = ref_tune._tune_fp64_xla(ref_csr, RefFormat.CSR)
    assert tuned.operands["row"] is not None and tuned.dtype == torch.float64
    assert tuned.nnz_full == ref.nnz_full
    assert tuned.padding_ratio == ref.padding_ratio
    x = np.random.default_rng(5).uniform(1, 2, ref_csr.ncols)
    y = tuned.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ref_csr.spmv_host(x), rtol=1e-13)
    np.testing.assert_allclose(y, np.asarray(ref.matvec(x)), rtol=1e-13)
    X = np.random.default_rng(6).uniform(1, 2, (ref_csr.ncols, 2))
    Y = tuned.matmat(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, np.asarray(ref.matmat(X)), rtol=1e-13)
    np.testing.assert_allclose(Y[:, 0], ref_csr.spmv_host(X[:, 0]),
                               rtol=1e-13)


def test_tune_fp64_xla_symmetric_no_remainder():
    """Banded symmetric (uniform degree): the remainder is empty and the
    mirrored expansion exact."""
    rng = np.random.default_rng(7)
    n, hb = 512, 6
    rows = np.repeat(np.arange(n, dtype=np.int64), hb)
    cols = rows - np.tile(np.arange(1, hb + 1, dtype=np.int64), n)
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = rng.uniform(0.5, 1.5, len(r))
    ref_csr = RefCSR.from_coo(
        RefCOO(n, n, r, c, v, symmetric=True).canonicalize())
    tuned = port_tune._tune_fp64_xla(port_csr(ref_csr), ct.Format.SSS,
                                     torch.device("cpu"))
    assert tuned.operands["row"] is None  # uniform rows: pure ELL
    x = rng.uniform(1, 2, n)
    np.testing.assert_allclose(tuned.matvec(torch.from_numpy(x)).numpy(),
                               ref_csr.spmv_host(x), rtol=1e-13)


# -- the twins of B13-B16 against the reference kernels --------------------

#: offset 0 (the halved main diagonal), lane shift 0, sublane shifts > 0,
#: |d| >= 128, and an offset crossing a 1024-row block
DF_OFFSETS = (0, 1, 2, 127, 128, 129, 300, 1029)


def _sdia_operands(R, T, seed, B=None, D=len(DF_OFFSETS)):
    assert R % sk._blocks_per_step(R, D) == 0  # the reference's contract
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1, 1, (R, D, 8, 128))
    x = rng.uniform(-1, 1, (T, 128) if B is None else (B, T, 128))
    return vals, x


@pytest.mark.parametrize("R,T", [(3, 20), (4, 30)])
def test_sdia_df_plain_matches_reference(R, T):
    """B13: the twin on float64 operands against the reference's
    double-float kernel on their (hi, lo) planes, folded in float64."""
    vals, x2d = _sdia_operands(R, T, R * 100 + T)
    yh, yl = ref_sdf.sdia_sym_tiles_df(
        *(jnp.asarray(a) for a in (*ref_bdf.split_df(vals),
                                   *ref_bdf.split_df(x2d))),
        offsets=DF_OFFSETS, interpret=True)
    ref = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    offs = torch.tensor(DF_OFFSETS, dtype=torch.int32)
    tv, tx = torch.from_numpy(vals), torch.from_numpy(x2d)
    y = sdf.sdia_sym_tiles_df(tv, tx, torch.zeros((T, 128),
                                                  dtype=torch.float64), offs)
    assert y.dtype == torch.float64 and y.shape == (T, 128)
    scale = sk.sdia_sym_tiles_plain(tv.abs(), tx.abs(), torch.zeros_like(y),
                                    offs).numpy()
    assert _rel_err(y.numpy(), ref, scale) < DF_RTOL
    # offset 0: both sides land on row g, so the plane counts twice
    only0 = torch.zeros_like(tv)
    only0[:, 0] = tv[:, 0]
    y0 = sdf.sdia_sym_tiles_df(only0, tx, torch.zeros_like(y), offs).numpy()
    want = 2 * vals[:, 0].reshape(-1)[: T * 128] * x2d.reshape(-1)
    assert np.array_equal(y0.reshape(-1), want)
    # a nonzero incoming y is accumulated in place
    y_in = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (T, 128)))
    before = y_in.clone()
    out = sdf.sdia_sym_tiles_df(tv, tx, y_in, offs)
    assert out.data_ptr() == y_in.data_ptr()
    assert _rel_err(out.numpy(), before.numpy() + y.numpy(),
                    scale + before.abs().numpy()) < NATIVE_RTOL
    assert sdf.sdia_sym_tiles_df.launches == 0  # CPU tensors never launch


def test_sdia_df_mm_plain_matches_reference_strided():
    """B14 at B = 11 (two plane groups), Y planes at a plane stride past
    the plane (a column slice of a taller buffer). Three offsets keep the
    reference's interpreter quick: the main diagonal, one with a lane and
    a sublane shift, one crossing a 1024-row block."""
    R, T, B = 2, 16, 11
    mm_offsets = (0, 129, 1029)
    vals, x3d = _sdia_operands(R, T, 5, B=B, D=len(mm_offsets))
    yh, yl = ref_sdf.sdia_sym_tiles_df_mm(
        *(jnp.asarray(a) for a in (*ref_bdf.split_df(vals),
                                   *ref_bdf.split_df(x3d))),
        offsets=mm_offsets, interpret=True)
    ref = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    offs = torch.tensor(mm_offsets, dtype=torch.int32)
    tv, tx = torch.from_numpy(vals), torch.from_numpy(x3d)
    wide = torch.full((B, T + 3, 128), float("nan"), dtype=torch.float64)
    y3d = wide[:, :T]
    y3d.zero_()
    assert y3d.stride(0) == (T + 3) * 128
    Y = sdf.sdia_sym_tiles_df_mm(tv, tx, y3d, offs)
    assert Y.data_ptr() == y3d.data_ptr()
    assert torch.isnan(wide[:, T:]).all()  # nothing written past a plane
    for b in range(B):
        scale = sk.sdia_sym_tiles_plain(
            tv.abs(), tx[b].abs(), torch.zeros((T, 128), dtype=torch.float64),
            offs).numpy()
        assert _rel_err(Y[b].numpy(), ref[b], scale) < DF_RTOL
        yb = sdf.sdia_sym_tiles_df(tv, tx[b].contiguous(),
                                   torch.zeros((T, 128), dtype=torch.float64),
                                   offs)
        assert torch.equal(yb, Y[b])
    assert sdf.sdia_sym_tiles_df_mm.launches == 0


def _df_plan(ref_csr, **kw):
    """The reference's double-float one-sided plan of ``ref_csr`` (float32
    ``vals`` with the low halves in ``vals2``), slot-packed."""
    coo = ref_csr.to_coo()
    hi, lo = ref_bdf.split_df(np.asarray(coo.val, np.float64))
    return ref_from_arrays(
        coo.nrows, coo.ncols, np.asarray(coo.row, np.int32),
        np.asarray(coo.col, np.int32), hi, dtype=np.float32, val2=lo,
        force_slot=True, **kw)


def _holes():
    """A band whose rows 1024-3071 are empty: on 8-tile blocks without
    covering chunks, two of its four output blocks are never visited."""
    coo = MATRICES["wide_band"][0]().to_coo()
    keep = (coo.row < 1024) | (coo.row >= 3072)
    return RefCSR.from_coo(RefCOO(coo.nrows, coo.ncols, coo.row[keep],
                                  coo.col[keep], coo.val[keep]))


#: name -> (plan factory, window depth, grouped, unvisited blocks); every
#: plan has 8-tile output blocks, so several of them
DF_STREAMS = {
    "contig8": (lambda: _df_plan(
        ref_proxies.random_band(n=4000, per_row=10, half_bw=300),
        tiles_per_block=8), 8, False, False),
    "deep": (lambda: _df_plan(_scattered_grouped(), tiles_per_block=8),
             32, False, False),
    # degree-grouped over a compact tile range: the empty rows are absent
    # from the stream and the blocks past the range are never visited
    "grouped_holes": (lambda: _df_plan(_holes(), tiles_per_block=8),
                      8, True, True),
    "holes": (lambda: _df_plan(_holes(), tiles_per_block=8,
                               cover_all_tiles=False), 8, False, True),
}


def _stream_kw(plan, contig):
    return dict(num_row_tiles=plan.num_row_tiles,
                chunks_per_step=plan.chunks_per_step,
                tiles_per_block=plan.tiles_per_block, contig=contig)


def _stream_to_device(plan):
    """The stream's chunk grid as the grid kernel's wrappers take them. An
    ungrouped sparse plan (one that leaves blocks unvisited) is uploaded
    as its entry list, without the grid, so its grid struct is built by
    hand from the rejoined values."""
    if not (plan.sparse_stream and plan.row_perm is None):
        return ops.fp64_to_device(plan, "cpu")
    up = ops.fp64_to_device(plan, "cpu")
    assert up.entries is not None and up.vals is None and not up.covers
    vals = plan.vals.astype(np.float64) + plan.vals2.astype(np.float64)
    return ops.Fp64Device(
        nrows=plan.nrows, ncols=plan.ncols, num_row_tiles=plan.num_row_tiles,
        x_rows=plan.x_rows, chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block, contig=True, has_work=True,
        vals=torch.from_numpy(vals),
        **{k: torch.from_numpy(np.ascontiguousarray(getattr(plan, k)))
           for k in ("packed", "meta", "step_block")})


def _visited(plan):
    BT = plan.tiles_per_block
    rows = (np.unique(plan.step_block)[:, None] * BT
            + np.arange(BT)[None, :]).ravel()
    return rows[rows < plan.num_row_tiles]


@pytest.mark.parametrize("name", sorted(DF_STREAMS))
def test_bell2_df_plain_matches_reference(name):
    """B15: the twin on the rejoined float64 values against the reference's
    double-float word kernel, its 8x-tall partials folded in float64; the
    output buffer NaN-poisoned."""
    make, depth, grouped, holes = DF_STREAMS[name]
    plan = make()
    assert plan.window_depth == depth and plan.windows_contig
    assert (plan.row_perm is not None) == grouped
    assert plan.num_row_tiles > plan.tiles_per_block == 8
    d = _stream_to_device(plan)
    assert d.vals.dtype == torch.float64
    assert torch.equal(d.vals, torch.from_numpy(
        plan.vals.astype(np.float64) + plan.vals2.astype(np.float64)))
    x = np.random.default_rng(1).uniform(1.0, 2.0, plan.ncols)
    x2d = np.zeros((plan.x_rows, 128))
    x2d.reshape(-1)[: plan.ncols] = x
    T = plan.num_row_tiles
    xh, xl = ref_bdf.split_df(x2d)
    yh, yl = ref_bdf.bell2_spmv_tiles_df(
        jnp.asarray(plan.vals), jnp.asarray(plan.vals2),
        jnp.asarray(plan.packed), jnp.asarray(meta_word(plan.meta)),
        jnp.asarray(plan.step_block), jnp.asarray(xh), jnp.asarray(xl),
        num_row_tiles=T, chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block, depth=plan.window_depth,
        interpret=True)
    ref = np.asarray(ref_bdf.fold_df_tiles(yh, yl, T))
    kw = _stream_kw(plan, d.contig)
    TP = -(-T // 8) * 8
    poison = torch.full((TP, 128), float("nan"), dtype=torch.float64)
    tx = torch.from_numpy(x2d)
    got = bdf.bell2_spmv_tiles_df(d.vals, d.packed, d.meta, d.step_block, tx,
                                  out=poison, **kw)
    assert got.dtype == torch.float64 and got.shape == (T, 128)
    scale = bk.bell2_spmv_tiles_plain(d.vals.abs(), d.packed, d.meta,
                                      d.step_block, tx.abs(), **kw).numpy()
    rows = _visited(plan)
    assert (len(rows) < T) == holes
    assert np.isfinite(got.numpy()[rows]).all()
    assert _rel_err(got.numpy()[rows], ref[rows], scale[rows]) < DF_RTOL
    if holes:  # unvisited blocks keep what the buffer held
        rest = np.setdiff1d(np.arange(TP), rows)
        assert torch.isnan(poison[rest]).all()
    if grouped:
        # the applier's gather on the poisoned output: rows without
        # entries read the appended zero exactly, every row is finite
        flat = torch.cat([got.reshape(-1), got.new_zeros(1)])
        y = torch.index_select(flat, 0, d.row_perm)[: plan.nrows].numpy()
        absent = plan.row_perm == T * 128
        assert absent.any() and np.all(y[absent] == 0.0)
        assert np.isfinite(y).all()
    assert bdf.bell2_spmv_tiles_df.launches == 0


@pytest.mark.parametrize("name,B", [("contig8", 11), ("deep", 3),
                                    ("grouped_holes", 3)])
def test_bell2_df_mm_plain_matches_reference(name, B):
    """B16 from X planes at a plane stride past the plane, into
    NaN-poisoned planes; B = 11 is two plane groups (the reference kernel
    takes its 11 planes in one call, slowly in the interpreter, so the
    other streams run B = 3)."""
    make, _, _, holes = DF_STREAMS[name]
    plan = make()
    d = ops.fp64_to_device(plan, "cpu")
    T = plan.num_row_tiles
    wide = np.random.default_rng(2).uniform(1.0, 2.0,
                                            (B, plan.x_rows + 2, 128))
    wide[:, : plan.x_rows].reshape(B, -1)[:, plan.ncols:] = 0.0
    x3d = torch.from_numpy(wide)[:, : plan.x_rows]
    assert x3d.stride(0) == (plan.x_rows + 2) * 128
    xh, xl = ref_bdf.split_df(np.ascontiguousarray(x3d.numpy()))
    yh, yl = ref_bdf.bell2_spmm_tiles_df(
        jnp.asarray(plan.vals), jnp.asarray(plan.vals2),
        jnp.asarray(plan.packed), jnp.asarray(meta_word(plan.meta)),
        jnp.asarray(plan.step_block), jnp.asarray(xh), jnp.asarray(xl),
        num_row_tiles=T, chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block, depth=plan.window_depth,
        interpret=True)
    ref = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    kw = _stream_kw(plan, d.contig)
    TP = -(-T // 8) * 8
    poison = torch.full((B, TP, 128), float("nan"), dtype=torch.float64)
    got = bdf.bell2_spmm_tiles_df(d.vals, d.packed, d.meta, d.step_block,
                                  x3d, out=poison, **kw)
    assert got.dtype == torch.float64 and got.shape == (B, T, 128)
    rows = _visited(plan)
    assert (len(rows) < T) == holes
    for b in range(B):
        xb = x3d[b].contiguous()
        scale = bk.bell2_spmv_tiles_plain(d.vals.abs(), d.packed, d.meta,
                                          d.step_block, xb.abs(), **kw)
        assert np.isfinite(got[b].numpy()[rows]).all()
        assert _rel_err(got[b].numpy()[rows], ref[b][rows],
                        scale.numpy()[rows]) < DF_RTOL
        yb = bdf.bell2_spmv_tiles_df(d.vals, d.packed, d.meta, d.step_block,
                                     xb, **kw)
        assert torch.equal(yb[rows], got[b][rows])
    if holes:
        rest = np.setdiff1d(np.arange(TP), rows)
        assert torch.isnan(poison[:, rest]).all()
    assert bdf.bell2_spmm_tiles_df.launches == 0


def _accum_plan(name):
    """(the reference's double-float plan, its float64 upload): the
    flagship's peel residual (covering, one output block) or ``holes``
    (8-tile blocks, two of four never visited); both upload as entries."""
    if name == "flagship":
        make, fmt, _ = MATRICES["flagship"]
        plan = ref_tune._tune_fp64_df(make(), RefFormat[fmt]).plan
    else:
        plan = DF_STREAMS["holes"][0]()
    d = ops.fp64_to_device(plan, "cpu")
    assert d.entries is not None and d.vals is None
    assert d.entries.vals.dtype == torch.float64
    return plan, d


def _grid_f64(plan):
    """The plan's chunk grid, values rejoined in float64, and the grid
    twin's keywords (every block zeroed: the accumulated product)."""
    vals = plan.vals.astype(np.float64) + plan.vals2.astype(np.float64)
    grid = (torch.from_numpy(vals), *(
        torch.from_numpy(np.ascontiguousarray(getattr(plan, k)))
        for k in ("packed", "meta", "step_block")))
    kw = _stream_kw(plan, plan.windows_contig or plan.window_depth > 8)
    return grid, dict(kw, covers=True)


def _seeded_tiles(d, B, seed):
    """(B, T, 128) float64 tiles over the entries' rows: finite on every
    row an entry names and on half the others, NaN on the rest; and the
    mask of named rows."""
    T = d.entries.min_tiles
    named = torch.zeros(T * 128, dtype=torch.bool)
    named[d.entries.rows.long()] = True
    rng = np.random.default_rng(seed)
    y0 = torch.from_numpy(rng.uniform(-1, 1, (B, T * 128)))
    unnamed = torch.nonzero(~named).ravel()
    y0[:, unnamed[::2]] = float("nan")
    assert named.any() and unnamed.numel() > 1
    return y0.view(B, T, 128), named


def _ref_df_tiles(plan, x3d):
    """The reference's double-float grid kernel on (B, rows, 128) planes,
    folded in float64: (B, T, 128)."""
    xh, xl = ref_bdf.split_df(np.ascontiguousarray(x3d))
    common = (jnp.asarray(plan.vals), jnp.asarray(plan.vals2),
              jnp.asarray(plan.packed), jnp.asarray(meta_word(plan.meta)),
              jnp.asarray(plan.step_block))
    kw = dict(num_row_tiles=plan.num_row_tiles,
              chunks_per_step=plan.chunks_per_step,
              tiles_per_block=plan.tiles_per_block, depth=plan.window_depth,
              interpret=True)
    if x3d.shape[0] == 1:
        yh, yl = ref_bdf.bell2_spmv_tiles_df(
            *common, jnp.asarray(xh[0]), jnp.asarray(xl[0]), **kw)
        return np.asarray(ref_bdf.fold_df_tiles(yh, yl,
                                                plan.num_row_tiles))[None]
    yh, yl = ref_bdf.bell2_spmm_tiles_df(*common, jnp.asarray(xh),
                                         jnp.asarray(xl), **kw)
    return np.asarray(yh, np.float64) + np.asarray(yl, np.float64)


@pytest.mark.parametrize("mm", [False, True])
@pytest.mark.parametrize("name", ["flagship", "holes"])
def test_bell2_accum_df_matches_grid_and_reference(name, mm):
    """B15/B16 on an entry list: the float64 accumulating wrappers (their
    twins here) add the compacted stream into NaN-poisoned tiles seeded
    finite on some rows. Rows no entry names keep their bits; named rows
    get the grid twin's product (``bell2_spmv_tiles_plain`` on the same
    plan's chunk grid) and the reference's double-float kernel's (folded
    in float64), each added to the seed. The SpMM form reads X planes at a
    plane stride past the plane, B = 3."""
    plan, d = _accum_plan(name)
    es = d.entries
    B = 3 if mm else 1
    wide = np.random.default_rng(7).uniform(1.0, 2.0,
                                            (B, plan.x_rows + 2, 128))
    wide[:, : plan.x_rows].reshape(B, -1)[:, plan.ncols:] = 0.0
    x3d = torch.from_numpy(wide)[:, : plan.x_rows]
    assert x3d.stride(0) == (plan.x_rows + 2) * 128
    y0, named = _seeded_tiles(d, B, seed=8)
    y = y0.clone()
    if mm:
        got = bdf.bell2_spmm_tiles_accum_df(es, x3d, y)
    else:
        got = bdf.bell2_spmv_tiles_accum_df(es, x3d[0], y[0])[None]
    assert got.data_ptr() == y.data_ptr()  # added into in place
    flat, before = y.reshape(B, -1), y0.reshape(B, -1)
    assert torch.equal(flat[:, ~named].view(torch.int64),
                       before[:, ~named].view(torch.int64))
    grid, kw = _grid_f64(plan)
    T = es.min_tiles
    ref = _ref_df_tiles(plan, x3d.numpy())
    for b in range(B):
        xb = x3d[b].contiguous()
        want = bk.bell2_spmv_tiles_plain(*grid, xb, **kw)[:T].reshape(-1)
        scale = bk.bell2_spmv_tiles_plain(grid[0].abs(), *grid[1:], xb.abs(),
                                          **kw)[:T].reshape(-1)
        scale = (scale + before[b].abs())[named].numpy()
        sums = flat[b][named].numpy()
        assert np.isfinite(sums).all()
        assert _rel_err(sums, (before[b] + want)[named].numpy(),
                        scale) < NATIVE_RTOL
        assert _rel_err(sums, before[b][named].numpy()
                        + ref[b].reshape(-1)[: T * 128][named.numpy()],
                        scale) < DF_RTOL
        # the grid names no row past the entries' tiles
        assert not bk.bell2_spmv_tiles_plain(*grid, xb, **kw)[T:].any()
    assert bdf.bell2_spmv_tiles_accum_df.launches == 0
    assert bdf.bell2_spmm_tiles_accum_df.launches == 0


def test_fp64_upload_keeps_the_grid_where_it_must():
    """Only an ungrouped peel residual or sparse stream becomes entries: a
    grouped residual (``sdia_peel_with_residual``) and a covering stream
    without a peel (``contig8``) keep the chunk grid. ``covers`` is true
    where the grid visits every block, and the grid twin then zeroes the
    whole output, which is the same product."""
    make, fmt, _ = MATRICES["sdia_peel_with_residual"]
    grouped = port_tune.build_fp64_plan(port_csr(make()))
    assert grouped.dia is not None and grouped.row_perm is not None
    d = ops.fp64_to_device(grouped, "cpu")
    assert d.entries is None and d.vals is not None and d.grouped
    contig8 = DF_STREAMS["contig8"][0]()
    assert contig8.dia is None and not contig8.sparse_stream
    d = ops.fp64_to_device(contig8, "cpu")
    assert d.entries is None and d.vals is not None and d.covers
    d_gh = ops.fp64_to_device(DF_STREAMS["grouped_holes"][0](), "cpu")
    assert d_gh.vals is not None and not d_gh.covers  # unvisited blocks
    holes = DF_STREAMS["holes"][0]()
    assert not ops._visits_every_block(holes.step_block, holes.num_row_tiles,
                                       holes.tiles_per_block)
    assert ops.fp64_to_device(holes, "cpu").entries is not None
    # covering: zeroing the whole buffer and zeroing the visited blocks
    # give the same tiles from a NaN-poisoned buffer
    x2d = torch.from_numpy(np.random.default_rng(3).uniform(
        1.0, 2.0, (contig8.x_rows, 128)))
    TP = -(-contig8.num_row_tiles // 8) * 8
    outs = []
    for covers in (False, True):
        poison = torch.full((TP, 128), float("nan"), dtype=torch.float64)
        outs.append(bdf.bell2_spmv_tiles_df(
            d.vals, d.packed, d.meta, d.step_block, x2d, out=poison,
            covers=covers, **d.stream_kw()))
        assert torch.isfinite(poison).all()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("name", ["sdia_peel_with_residual",
                                  "scattered_grouped"])
def test_fp64_appliers_run_the_reference_plan(name):
    """``fp64_to_device`` takes the reference's double-float plan (its two
    value planes rejoined in float64), so both appliers run on one plan:
    the port's result on it agrees with the reference's applier, and with
    the port's own plan of the same matrix."""
    make, fmt, seed = MATRICES[name]
    ref_csr = make()
    tuned, ref = _tune_both(ref_csr, fmt)
    d = ops.fp64_to_device(ref.plan, "cpu")
    x = np.random.default_rng(seed).uniform(1.0, 2.0, ref_csr.ncols)
    X = np.random.default_rng(seed + 1).uniform(1.0, 2.0, (ref_csr.ncols, 3))
    scale = ref_csr.spmv_host(x, absolute=True)
    y = ops.fp64_apply(d, torch.from_numpy(x)).numpy()
    assert _rel_err(y, np.asarray(ref.matvec(x)), scale) < DF_RTOL
    # hi + lo keeps about 48 of the 53 bits: 2^-48 is 3.6e-15 per value
    assert _rel_err(y, tuned.matvec(torch.from_numpy(x)).numpy(),
                    scale) < NATIVE_RTOL
    Y = ops.fp64_apply_mm(d, torch.from_numpy(X)).numpy()
    Y_ref = np.asarray(ref.matmat(X))
    for b in range(3):
        assert _rel_err(Y[:, b], Y_ref[:, b],
                        ref_csr.spmv_host(X[:, b], absolute=True)) < DF_RTOL
    # the plain path of the applier is the same arithmetic on the CPU
    assert torch.equal(ops.fp64_apply(d, torch.from_numpy(x), plain=True),
                       torch.from_numpy(y))


def test_fp64_plan_values_native_and_numpy_assembly_agree(monkeypatch):
    """The native one-pass plan assembler takes the values' item size; its
    float64 plan equals the NumPy scatter's."""
    coo = MATRICES["wide_band"][0]().to_coo()
    args = (coo.nrows, coo.ncols, np.asarray(coo.row, np.int32),
            np.asarray(coo.col, np.int32), np.asarray(coo.val, np.float64))
    kw = dict(dtype=np.float64, force_slot=True)
    a = build_bell2_from_arrays(*args, **kw)
    monkeypatch.setattr(port_native, "assemble_plan", lambda *a, **k: False)
    b = build_bell2_from_arrays(*args, **kw)
    assert a.vals.dtype == b.vals.dtype == np.float64
    assert a.vals.tobytes() == b.vals.tobytes()
    assert a.packed.tobytes() == b.packed.tobytes()
    assert np.count_nonzero(a.vals) == coo.nnz


# -- the user entry points -------------------------------------------------

def _assert_oracle(y, csr, x, nnz_full):
    assert allclose_spmv(y, csr.spmv_host(x), np.float64,
                         nnz_per_row=nnz_full / csr.nrows,
                         scale=csr.spmv_host(x, absolute=True))
    assert _rel_err(y, csr.spmv_host(x),
                    csr.spmv_host(x, absolute=True)) < NATIVE_RTOL


@pytest.mark.parametrize("fmt", ["SSS", "CSR", "BSR"])
def test_spdmv_spdmm_matmul_float64(fmt):
    """``SpDMV``, ``SpDMM`` and a tuned ``A @ x`` in float64, from numpy
    and from float32 input (converted to the tuned type)."""
    ref_csr = MATRICES["sdia_peel_with_residual"][0]()
    csr = port_csr(ref_csr)
    if fmt != "SSS":
        csr = CSR.from_coo(csr.to_coo().expand_symmetric())
    A = ct.SparseMatrix.create(csr, ct.Format[fmt])
    op = ct.SpDMV(A, dtype=np.float64, device="cpu")
    assert A.tuned.dtype == torch.float64
    assert (A.tuned.plan.dia is not None) == (fmt == "SSS")
    x = np.random.default_rng(3).uniform(10.01, 20.42, csr.ncols)
    y = op(x)
    assert y.dtype == torch.float64 and y.device.type == "cpu"
    _assert_oracle(y.numpy(), ref_csr, x, A.tuned.nnz_full)
    assert torch.equal(A @ x, y)
    x32 = x.astype(np.float32)
    _assert_oracle(op(x32).numpy(), ref_csr, x32.astype(np.float64),
                   A.tuned.nnz_full)
    X = np.random.default_rng(4).uniform(10.01, 20.42, (csr.ncols, 2))
    Y = ct.SpDMM(A, dtype=np.float64, device="cpu")(X)
    assert Y.dtype == torch.float64 and Y.shape == (csr.nrows, 2)
    assert torch.equal(op(X), Y) and torch.equal(A @ X, Y)
    for b in range(2):
        _assert_oracle(Y[:, b].numpy(), ref_csr, X[:, b], A.tuned.nnz_full)
    assert A.size() == A.tuned.plan.stream_bytes() > 0


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("xtype", ["float64", "float32"])
def test_untuned_matmul_tunes_in_the_type_of_x(xtype, as_tensor, monkeypatch):
    """An untuned ``A @ x`` tunes in float64 for a float64 x (a numpy
    array or a tensor) and in float32 for any other, as the reference
    does; the float64 product passes the float64 gate (1e-8)."""
    import cfs_spmv_tpu_torch.matrix as matrix_mod

    ref_csr = MATRICES["sdia_peel_with_residual"][0]()
    A = ct.SparseMatrix.create(port_csr(ref_csr), ct.Format.SSS)
    x = np.random.default_rng(3).uniform(10.01, 20.42, A.ncols).astype(xtype)
    assert A.tuned is None
    if as_tensor:
        y = A @ torch.from_numpy(x)
    else:
        # a numpy x tunes onto the card: here the tuner is handed the CPU
        real = matrix_mod.tune
        monkeypatch.setattr(
            matrix_mod, "tune",
            lambda *a, **kw: real(*a, **{**kw, "device": "cpu"}))
        y = A @ x
    want = torch.float64 if xtype == "float64" else torch.float32
    assert A.tuned.dtype == want and y.dtype == want
    x64 = x.astype(np.float64)
    assert allclose_spmv(y.numpy(), ref_csr.spmv_host(x64), np.dtype(xtype),
                         nnz_per_row=A.tuned.nnz_full / A.nrows,
                         scale=ref_csr.spmv_host(x64, absolute=True))
    if xtype == "float64":
        _assert_oracle(y.numpy(), ref_csr, x64, A.tuned.nnz_full)


def test_spdmv_retunes_when_dtype_changes():
    csr = port_csr(MATRICES["symmetric_expands"][0]())
    A = ct.SparseMatrix.create(csr, ct.Format.SSS)
    x = np.random.default_rng(5).uniform(1.0, 2.0, csr.ncols)
    y32 = ct.SpDMV(A, dtype=np.float32, device="cpu")(x)
    t32 = A.tuned
    assert y32.dtype == torch.float32 and t32.dtype == torch.float32
    y64 = ct.SpDMV(A, dtype=np.float64, device="cpu")(x)
    t64 = A.tuned
    assert t64 is not t32 and y64.dtype == torch.float64
    assert isinstance(t64.operands, ops.Fp64Device)
    assert ct.SpDMV(A, dtype=np.float64, device="cpu").A.tuned is t64
    back = ct.SpDMV(A, dtype=np.float32, device="cpu")(x)
    assert A.tuned is not t64 and torch.equal(back, y32)
    _assert_oracle(y64.numpy(), csr, x, t64.nnz_full)


def test_fp64_empty_matrix_gives_zeros():
    csr = CSR(300, 200, np.zeros(301, np.int64), np.zeros(0, np.int32),
              np.zeros(0, np.float64), False)
    tuned = port_tune.tune(csr, dtype=np.float64, device="cpu")
    y = tuned.matvec(torch.ones(200, dtype=torch.float64))
    assert y.dtype == torch.float64 and torch.equal(
        y, torch.zeros(300, dtype=torch.float64))
    Y = tuned.matmat(torch.ones((200, 3), dtype=torch.float64))
    assert Y.shape == (300, 3) and not Y.any()


def test_fp64_dtype_mix_raises_type_error():
    """A kernel reads x and y through pointers of its values' type, so
    every wrapper refuses a mix, naming both types."""
    make, fmt, _ = MATRICES["sdia_peel_with_residual"]
    tuned = port_tune.tune(port_csr(make()), fmt=ct.Format[fmt],
                           dtype=np.float64, device="cpu")
    d = tuned.operands
    x64 = torch.ones(d.ncols, dtype=torch.float64)
    for apply, x in ((ops.fp64_apply, x64.float()),
                     (ops.fp64_apply_mm, x64.float()[:, None])):
        with pytest.raises(TypeError, match="float32.*float64"):
            apply(d, x)
    TD = -(-d.nrows // 128)
    x2d, y2d = ops.pad_x(x64, d.x_rows), torch.zeros((TD, 128)).double()
    kw = d.stream_kw()
    stream = (d.packed, d.meta, d.step_block)
    with pytest.raises(TypeError, match="float64.*float32"):
        sk.sdia_sym_tiles(d.dia_vals.float(), x2d, y2d.float(),
                          d.dia_offsets)
    with pytest.raises(TypeError, match="float32.*float64"):
        sdf.sdia_sym_tiles_df(d.dia_vals, x2d.float(), y2d, d.dia_offsets)
    with pytest.raises(TypeError, match="float32.*float64"):
        sdf.sdia_sym_tiles_df(d.dia_vals, x2d, y2d.float(), d.dia_offsets)
    with pytest.raises(TypeError, match="float64"):
        sdf.sdia_sym_tiles_df(d.dia_vals.float(), x2d, y2d, d.dia_offsets)
    with pytest.raises(TypeError, match="float32.*float64"):
        sdf.sdia_sym_tiles_df_mm(d.dia_vals, x2d[None].float(), y2d[None],
                                 d.dia_offsets)
    with pytest.raises(TypeError, match="float64.*float32"):
        bk.bell2_spmv_tiles(d.vals.float(), *stream, x2d, **kw)
    with pytest.raises(TypeError, match="float32"):
        bk.bell2_spmv_tiles(d.vals, *stream, x2d.float(), **kw)
    with pytest.raises(TypeError, match="float32.*float64"):
        bdf.bell2_spmv_tiles_df(d.vals, *stream, x2d.float(), **kw)
    with pytest.raises(TypeError, match="float32.*float64"):
        bdf.bell2_spmm_tiles_df(d.vals, *stream, x2d[None].float(), **kw)
    with pytest.raises(TypeError, match="float32.*float64"):
        bdf.bell2_spmv_tiles_df(
            d.vals, *stream, x2d,
            out=torch.empty((-(-d.num_row_tiles // d.tiles_per_block)
                             * d.tiles_per_block, 128)), **kw)
    with pytest.raises(ValueError, match="offsets >= 0"):
        plan = port_tune.build_fp64_plan(port_csr(make()))
        plan.dia.offsets = tuple(-o for o in plan.dia.offsets)
        ops.fp64_to_device(plan, "cpu")


@pytest.mark.parametrize("fmt", ["0", "1"])
def test_cli_test_spmv_mmf_double_precision(fmt, tmp_path, capsys):
    """``--dp``: the differential harness in float64 at the 1e-8 gate, as
    the reference's CLI (``cfs_spmv_tpu/cli/test_spmv_mmf.py``)."""
    csr = ct.CSR.from_coo(ct.COO.random(600, 600, 6.0, symmetric=True,
                                        bandwidth=5, seed=3,
                                        dtype=np.float64))
    coo = csr.to_coo()
    path = tmp_path / "band.mtx"
    write_mmf(path, coo.nrows, coo.ncols, coo.row, coo.col, coo.val,
              symmetric=True)
    assert run_test_cli([str(path), fmt, "--device", "cpu", "--dp"]) == 0
    assert capsys.readouterr().out.strip().endswith("PASSED!")


def test_split_df_matches_reference():
    a = np.random.default_rng(0).uniform(-3, 3, 1000) * 1e3
    for got, want in zip(bdf.split_df(a), ref_bdf.split_df(a)):
        assert got.dtype == np.float32 and np.array_equal(got, want)
    # the pair rejoined keeps about 48 of the 53 bits
    hi, lo = bdf.split_df(a)
    rejoined = hi.astype(np.float64) + lo.astype(np.float64)
    assert np.all(np.abs(rejoined - a) <= 2.0 ** -47 * np.abs(a))
    assert not np.array_equal(rejoined, a)


def test_fp64_agrees_with_reference_public_entry():
    """The reference's public float64 entry, ``SpDMV(dtype=float64)``: in
    the CPU interpreter it runs the fp32-layout Pallas kernels in native
    float64 (a path that exists on no chip and is not ported); its result
    and the port's agree like two float64 sums."""
    make, fmt, seed = MATRICES["symmetric_expands"]
    ref_csr = make()
    x = np.random.default_rng(seed).uniform(1.0, 2.0, ref_csr.ncols)
    R = ref_cfs.SparseMatrix.create(ref_csr, ref_cfs.Format.SSS)
    y_ref = np.asarray(ref_cfs.SpDMV(R, dtype=np.float64)(x))
    A = ct.SparseMatrix.create(port_csr(ref_csr), ct.Format.SSS)
    y = ct.SpDMV(A, dtype=np.float64, device="cpu")(x).numpy()
    scale = ref_csr.spmv_host(x, absolute=True)
    assert _rel_err(y, y_ref, scale) < NATIVE_RTOL
