"""The slice end to end: the port's ``SpDMV`` on the CPU against the
reference's ``SpDMV`` (Pallas in interpret mode) and the float64 host
oracle ``CSR.spmv_host``, on the flagship, the cant and audikw proxies, a
27-point stencil and a shuffled band on which RCM reordering fires — and
everything off the slice raising ``NotImplementedError``.

Tolerance: ``allclose_spmv`` at float32 with the backward-error scale
``|A| |x|``, since the reference, the twins and the card's atomics all
sum in different orders.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
import cfs_spmv_tpu as ref_cfs
import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_build
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu_torch.formats import sdia as port_sdia
from cfs_spmv_tpu_torch.formats.coo import COO
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.io.mmf import write_mmf
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.utils import proxies
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

from conftest import random_x

torch.set_num_threads(1)


def port_csr(ref):
    return CSR(ref.nrows, ref.ncols, ref.indptr.copy(), ref.indices.copy(),
               ref.data.copy(), ref.symmetric)


def shuffled_band(n=2048, half_bw=9, seed=3):
    """A banded matrix hidden behind a random symmetric shuffle: the
    ``"auto"`` reorder gate accepts RCM on it."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    cols = rows - np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    keep = cols >= 0
    shuf = rng.permutation(n)
    r, c = shuf[rows[keep]], shuf[cols[keep]]
    swap = c > r
    r[swap], c[swap] = c[swap], r[swap].copy()
    r = np.concatenate([r, np.arange(n)])
    c = np.concatenate([c, np.arange(n)])
    v = np.concatenate([rng.uniform(-1, 1, keep.sum()), rng.uniform(1, 2, n)])
    return ref_cfs.CSR.from_coo(ref_cfs.COO(
        n, n, r.astype(np.int32), c.astype(np.int32), v.astype(np.float32),
        symmetric=True,
    ).canonicalize())


MATRICES = {
    "flagship": __graft_entry__._flagship,
    "cant": lambda: ref_proxies.cant_proxy(n=4096),
    "stencil27": lambda: ref_proxies.stencil27(g=12),
    "audikw": lambda: ref_proxies.audikw_proxy(nb=1000),
    "shuffled_band": shuffled_band,
}


def _assert_close(y, y_ref, csr, x, nnz_full):
    xd = x.astype(np.float64)
    assert allclose_spmv(y, y_ref, np.float32,
                         nnz_per_row=nnz_full / csr.nrows,
                         scale=csr.spmv_host(xd, absolute=True))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spdmv_matches_reference_and_oracle(name):
    ref_csr = MATRICES[name]()
    csr = port_csr(ref_csr)
    x = random_x(csr.nrows, np.float32)

    A = ct.SparseMatrix.create(csr, ct.Format.SSS)
    y = ct.SpDMV(A, ct.Tuning.AGGRESSIVE, dtype=np.float32, device="cpu")(x)
    assert isinstance(y, torch.Tensor)
    assert y.dtype == torch.float32 and y.shape == (csr.nrows,)
    assert y.device.type == "cpu"
    y = y.numpy()

    R = ref_cfs.SparseMatrix.create(ref_csr, ref_cfs.Format.SSS)
    y_ref = np.asarray(
        ref_cfs.SpDMV(R, ref_cfs.Tuning.AGGRESSIVE, dtype=np.float32)(x)
    )
    nnz_full = A.tuned.nnz_full
    assert nnz_full == R.tuned.nnz_full
    _assert_close(y, csr.spmv_host(x.astype(np.float64)), csr, x, nnz_full)
    _assert_close(y, y_ref, csr, x, nnz_full)

    # RCM fires on the shuffled band only, with the reference's permutation
    assert (A.tuned.perm is not None) == (name == "shuffled_band")
    if A.tuned.perm is not None:
        assert np.array_equal(A.tuned.perm, R.tuned.perm)
        fn, dev = A.tuned.pure_apply()
        xt = torch.from_numpy(x)
        assert torch.equal(A.tuned.decode(fn(dev, A.tuned.encode(xt))),
                           torch.from_numpy(y))
    # the CPU path runs the twins: no kernel was launched
    for w in (sk.sdia_sym_tiles, bk.bell2_spmv_tiles,
              bk.bell2_spmv_tiles_accum, bk.unperm_gather_tiles):
        assert w.launches == 0


def test_port_applier_runs_reference_plan():
    """``sym_to_device`` takes the reference's numpy plan as it is: the
    port's applier gives bit-identical results on both plans."""
    ref_csr = __graft_entry__._flagship()
    x = torch.from_numpy(random_x(ref_csr.nrows, np.float32))
    y_ref_plan = ops.sbell_apply(ops.sym_to_device(ref_build(ref_csr), "cpu"),
                                 x)
    y_port_plan = ops.sbell_apply(
        ops.sym_to_device(build_sbell_plan(port_csr(ref_csr)), "cpu"), x
    )
    assert torch.equal(y_ref_plan, y_port_plan)
    # the kernel wrappers and the plain twins compose identically on CPU
    d = ops.sym_to_device(build_sbell_plan(port_csr(ref_csr)), "cpu")
    assert torch.equal(ops.sbell_apply(d, x, plain=True), y_port_plan)


def test_spdmv_from_mtx_file(tmp_path):
    csr = proxies.cant_proxy(n=600, half_bw=5, dtype=np.float64)
    coo = csr.to_coo()
    path = tmp_path / "band.mtx"
    write_mmf(path, coo.nrows, coo.ncols, coo.row, coo.col, coo.val,
              symmetric=True)
    A = ct.SparseMatrix.create(str(path), ct.Format.SSS)
    x = random_x(csr.nrows, np.float32)
    y = ct.SpDMV(A, dtype=np.float32, device="cpu")(x).numpy()
    _assert_close(y, csr.spmv_host(x.astype(np.float64)), csr, x,
                  A.tuned.nnz_full)


def _small_sym():
    return ct.SparseMatrix.create(port_csr(__graft_entry__._flagship()),
                                  ct.Format.SSS)


def test_paired_plan_raises(monkeypatch):
    monkeypatch.setenv("CFS_PAIRED", "force")
    csr = proxies.near_band_paired(n=8000, n_diags=48, max_off=400, seed=3)
    assert build_sbell_plan(csr).nnz_paired > 0
    with pytest.raises(NotImplementedError, match="A3"):
        ct.SpDMV(ct.SparseMatrix.create(csr, ct.Format.SSS), device="cpu")


def test_mirrored_sdia_raises(monkeypatch):
    # past SDIA_SYM_ROWS_MAX the planner mirrors the diagonals into
    # signed offsets for the one-sided blocked-y kernel (B6)
    monkeypatch.setattr(port_sdia, "SDIA_SYM_ROWS_MAX", 100)
    A = ct.SparseMatrix.create(proxies.cant_proxy(n=2048), ct.Format.SSS)
    with pytest.raises(NotImplementedError, match="B6"):
        ct.SpDMV(A, device="cpu")


def test_general_path_raises():
    coo = COO.random(500, 500, 4.0, seed=1)
    A = ct.SparseMatrix.create(coo, ct.Format.CSR)
    with pytest.raises(NotImplementedError, match="A4"):
        ct.SpDMV(A, device="cpu")
    with pytest.raises(NotImplementedError, match="A4"):
        ct.SpDMV(_small_sym(), ct.Tuning.NONE, device="cpu")
    with pytest.raises(NotImplementedError, match="A4"):
        A @ np.ones(500, np.float32)  # untuned: the general oracle path
    with pytest.raises(NotImplementedError, match="A4"):
        ops.bell2_apply(None, torch.ones(4))


def test_float64_and_bf16_raise():
    with pytest.raises(NotImplementedError, match="A8"):
        ct.SpDMV(_small_sym(), dtype=np.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ct.SpDMV(_small_sym(), values="bfloat16", device="cpu")


def test_spmm_raises():
    A = _small_sym()
    op = ct.SpDMV(A, device="cpu")
    X = np.ones((A.ncols, 2), np.float32)
    with pytest.raises(NotImplementedError, match="A7"):
        op(X)
    with pytest.raises(NotImplementedError, match="A7"):
        ops.sbell_apply(A.tuned.operands, torch.from_numpy(X))


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    with pytest.raises(RuntimeError, match="cuda"):
        ct.SpDMV(_small_sym(), device="cuda")
