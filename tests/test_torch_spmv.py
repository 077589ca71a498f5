"""The port end to end: its ``SpDMV`` on the CPU against the reference's
``SpDMV`` (Pallas in interpret mode) and the float64 host oracle
``CSR.spmv_host``. The tuned symmetric path runs on the flagship, the
cant and audikw proxies, a 27-point stencil and a shuffled band on which
RCM reordering fires; the general path on an asymmetric stencil, the
flagship and audikw as general matrices, a rectangular matrix,
``Tuning.NONE``, an untuned ``A @ x`` and ``Format.BSR``; the paired
stream under ``CFS_PAIRED=force``; mirrored diagonals past
``SDIA_SYM_ROWS_MAX``. SpMM (``SpDMM``, ``SpDMV`` with a 2-D X, ``A @
X``) runs against the reference's SpMM and the oracle column by column
on the same paths, B = 1 as a 2-D X included. The differential CLI runs
on a written ``.mtx`` (in float32 and, with ``--dp``, in float64), and
bfloat16 values run where they once raised (``tests/test_torch_bf16.py``
holds them against the reference). The float64 route has its own file,
``tests/test_torch_fp64.py``; here the tests that once held its refusal
run it against the oracle.

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
from cfs_spmv_tpu.formats import sdia as ref_sdia
from cfs_spmv_tpu.formats.bell2 import build_general_plan as ref_general
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_build
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu_torch.cli.test_spmv_mmf import main as run_test_cli
from cfs_spmv_tpu_torch.formats import sdia as port_sdia
from cfs_spmv_tpu_torch.formats.bell2 import build_general_plan
from cfs_spmv_tpu_torch.formats.coo import COO
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.io.mmf import write_mmf
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.tuning.tune import tune
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


WRAPPERS = (sk.sdia_sym_tiles, sk.sdia_gen_tiles, bk.bell2_spmv_tiles,
            bk.bell2_spmv_tiles_accum, bk.unperm_gather_tiles,
            bk.sbell_spmv_tiles, sk.sdia_sym_tiles_mm, sk.sdia_gen_tiles_mm,
            bk.bell2_spmm_tiles, bk.bell2_spmm_tiles_accum,
            bk.unperm_gather_tiles_mm, bk.sbell_spmm_tiles)


def _assert_close(y, y_ref, csr, x, nnz_full):
    xd = x.astype(np.float64)
    assert allclose_spmv(y, y_ref, np.float32,
                         nnz_per_row=nnz_full / csr.nrows,
                         scale=csr.spmv_host(xd, absolute=True))


def _assert_close_mm(Y, Y_ref, csr, X, nnz_full):
    """Column by column: each column is one SpMV's result."""
    Y, Y_ref = np.asarray(Y), np.asarray(Y_ref)
    assert Y.shape == Y_ref.shape == (csr.nrows, X.shape[1])
    for b in range(X.shape[1]):
        _assert_close(Y[:, b], Y_ref[:, b], csr, X[:, b], nnz_full)


def _oracle_mm(csr, X):
    return np.stack([csr.spmv_host(X[:, b].astype(np.float64))
                     for b in range(X.shape[1])], axis=1)


def random_X(n, B, seed=8):
    return np.random.default_rng(seed).uniform(10.01, 20.42, (n, B)).astype(
        np.float32
    )


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
    for w in WRAPPERS:
        assert w.launches == 0


def test_port_applier_runs_reference_plan(monkeypatch):
    """``sym_to_device`` and ``to_device`` take the reference's numpy
    plans as they are: the port's appliers give bit-identical results on
    the reference's and the port's plans — a symmetric plan, a general
    plan with its signed diagonal peel and a paired plan."""
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

    gen = ref_proxies.general_asym(g=12)
    xg = torch.from_numpy(random_x(gen.ncols, np.float32))
    ref_plan = ref_general(gen)
    assert ref_plan.dia is not None
    y_ref_plan = ops.bell2_apply(ops.to_device(ref_plan, "cpu"), xg)
    d = ops.to_device(build_general_plan(port_csr(gen)), "cpu")
    assert torch.equal(ops.bell2_apply(d, xg), y_ref_plan)
    assert torch.equal(ops.bell2_apply(d, xg, plain=True), y_ref_plan)

    monkeypatch.setenv("CFS_PAIRED", "force")
    pc = ref_proxies.near_band_paired(n=4000, n_diags=32, max_off=300, seed=5)
    xp = torch.from_numpy(random_x(pc.nrows, np.float32))
    ref_plan = ref_build(pc)
    assert ref_plan.nnz_paired > 0
    y_ref_plan = ops.sbell_apply(ops.sym_to_device(ref_plan, "cpu"), xp)
    d = ops.sym_to_device(build_sbell_plan(port_csr(pc)), "cpu")
    assert d.has_paired
    assert torch.equal(ops.sbell_apply(d, xp), y_ref_plan)
    assert torch.equal(ops.sbell_apply(d, xp, plain=True), y_ref_plan)


def _patch_sym_rows_max(monkeypatch):
    """Mirror the symmetric diagonals at test size, in both packages."""
    monkeypatch.setattr(ref_sdia, "SDIA_SYM_ROWS_MAX", 100)
    monkeypatch.setattr(port_sdia, "SDIA_SYM_ROWS_MAX", 100)


def _rect():
    return ref_cfs.CSR.from_coo(
        ref_cfs.COO.random(700, 500, 4.0, seed=1, dtype=np.float32)
    )


#: name -> (reference CSR, format, tuning, untuned A @ x, CFS_PAIRED,
#: mirrored diagonals)
PATHS = {
    "general_asym": (lambda: ref_proxies.general_asym(g=12), "CSR",
                     "AGGRESSIVE", False, None, False),
    "flagship_csr": (__graft_entry__._flagship, "CSR", "AGGRESSIVE", False,
                     None, False),
    "audikw_csr": (lambda: ref_proxies.audikw_proxy(nb=1000), "CSR",
                   "AGGRESSIVE", False, None, False),
    "rectangular": (_rect, "CSR", "AGGRESSIVE", False, None, False),
    "tuning_none_sym": (lambda: ref_proxies.cant_proxy(n=4096), "SSS",
                        "NONE", False, None, False),
    "untuned_matmul": (lambda: ref_proxies.stencil27(g=12), "SSS", None,
                       True, None, False),
    "bsr_sym": (lambda: ref_proxies.audikw_proxy(nb=1000), "BSR",
                "AGGRESSIVE", False, None, False),
    "bsr_general": (lambda: ref_proxies.general_asym(g=12), "BSR",
                    "AGGRESSIVE", False, None, False),
    "paired_forced": (
        lambda: ref_proxies.near_band_paired(n=8000, n_diags=48, max_off=400,
                                             seed=3),
        "SSS", "AGGRESSIVE", False, "force", False,
    ),
    "mirrored_cant": (lambda: ref_proxies.cant_proxy(n=4096), "SSS",
                      "AGGRESSIVE", False, None, True),
}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_general_paired_mirrored_paths_match_reference(name, monkeypatch):
    gen, fmt, tuning, matmul, paired, mirrored = PATHS[name]
    if paired:
        monkeypatch.setenv("CFS_PAIRED", paired)
    if mirrored:
        _patch_sym_rows_max(monkeypatch)
    ref_csr = gen()
    csr = port_csr(ref_csr)
    x = random_x(csr.ncols, np.float32)

    A = ct.SparseMatrix.create(csr, getattr(ct.Format, fmt))
    R = ref_cfs.SparseMatrix.create(ref_csr, getattr(ref_cfs.Format, fmt))
    if matmul:
        y, y_ref = A @ torch.from_numpy(x), np.asarray(R @ x)
    else:
        y = ct.SpDMV(A, getattr(ct.Tuning, tuning), dtype=np.float32,
                     device="cpu")(x)
        y_ref = np.asarray(ref_cfs.SpDMV(
            R, getattr(ref_cfs.Tuning, tuning), dtype=np.float32)(x))
    assert y.dtype == torch.float32 and y.shape == (csr.nrows,)
    y = y.numpy()
    nnz_full = A.tuned.nnz_full
    assert nnz_full == R.tuned.nnz_full
    assert A.tuned.format == ct.Format(R.tuned.format.value)
    _assert_close(y, csr.spmv_host(x.astype(np.float64)), csr, x, nnz_full)
    _assert_close(y, y_ref, csr, x, nnz_full)

    plan, dev = A.tuned.plan, A.tuned.operands
    general = fmt == "CSR" or not csr.symmetric or tuning != "AGGRESSIVE"
    assert isinstance(dev, ops.Bell2Device) == general
    if name == "general_asym":
        assert min(plan.dia.offsets) < 0 and 0 in plan.dia.offsets
    if tuning != "AGGRESSIVE":  # the untuned oracle path: no peel
        assert plan.dia is None
    if fmt == "BSR":
        assert A.tuned.bsr.b == R.tuned.bsr.b
        assert (A.tuned.bsr.b > 1) == (name == "bsr_sym")  # audikw: 3x3
    assert (A.nrows != A.ncols) == (name == "rectangular")
    if paired:
        assert plan.nnz_paired > 0 and dev.has_paired
    assert getattr(dev, "dia_mirrored", False) == mirrored
    for w in WRAPPERS:
        assert w.launches == 0


#: name -> (reference CSR, format, tuning (None: untuned A @ X), entry,
#: B, CFS_PAIRED, mirrored diagonals)
MM_PATHS = {
    "flagship": (__graft_entry__._flagship, "SSS", "AGGRESSIVE", "SpDMM", 3,
                 None, False),
    "cant": (lambda: ref_proxies.cant_proxy(n=4096), "SSS", "AGGRESSIVE",
             "SpDMM", 3, None, False),
    "stencil27_spdmv_2d": (lambda: ref_proxies.stencil27(g=12), "SSS",
                           "AGGRESSIVE", "SpDMV", 2, None, False),
    "audikw_grouped_far": (lambda: ref_proxies.audikw_proxy(nb=1000), "SSS",
                           "AGGRESSIVE", "SpDMM", 2, None, False),
    "general_asym": (lambda: ref_proxies.general_asym(g=12), "CSR",
                     "AGGRESSIVE", "SpDMM", 3, None, False),
    "flagship_csr": (__graft_entry__._flagship, "CSR", "AGGRESSIVE", "SpDMM",
                     2, None, False),
    "tuning_none": (lambda: ref_proxies.cant_proxy(n=4096), "SSS", "NONE",
                    "SpDMM", 2, None, False),
    "rectangular": (_rect, "CSR", "AGGRESSIVE", "SpDMM", 3, None, False),
    "paired_forced": (
        lambda: ref_proxies.near_band_paired(n=4000, n_diags=32, max_off=300,
                                             seed=5),
        "SSS", "AGGRESSIVE", "SpDMM", 2, "force", False,
    ),
    "mirrored_cant": (lambda: ref_proxies.cant_proxy(n=4096), "SSS",
                      "AGGRESSIVE", "SpDMM", 2, None, True),
    "rcm": (shuffled_band, "SSS", "AGGRESSIVE", "SpDMM", 2, None, False),
    "b1_as_2d": (__graft_entry__._flagship, "SSS", "AGGRESSIVE", "SpDMM", 1,
                 None, False),
    "untuned_matmul": (lambda: ref_proxies.stencil27(g=12), "SSS", None,
                       "matmul", 3, None, False),
}


@pytest.mark.parametrize("name", sorted(MM_PATHS))
def test_spdmm_matches_reference_and_oracle(name, monkeypatch):
    gen, fmt, tuning, entry, B, paired, mirrored = MM_PATHS[name]
    if paired:
        monkeypatch.setenv("CFS_PAIRED", paired)
    if mirrored:
        _patch_sym_rows_max(monkeypatch)
    ref_csr = gen()
    csr = port_csr(ref_csr)
    X = random_X(csr.ncols, B)

    A = ct.SparseMatrix.create(csr, getattr(ct.Format, fmt))
    R = ref_cfs.SparseMatrix.create(ref_csr, getattr(ref_cfs.Format, fmt))
    if entry == "matmul":
        Y, Y_ref = A @ torch.from_numpy(X), R @ X
    else:
        port_cls = getattr(ct, entry)
        ref_cls = getattr(ref_cfs, entry)
        Y = port_cls(A, getattr(ct.Tuning, tuning), dtype=np.float32,
                     device="cpu")(X)
        Y_ref = ref_cls(R, getattr(ref_cfs.Tuning, tuning),
                        dtype=np.float32)(X)
    assert isinstance(Y, torch.Tensor) and Y.dtype == torch.float32
    assert Y.shape == (csr.nrows, B) and Y.device.type == "cpu"
    nnz_full = A.tuned.nnz_full
    assert nnz_full == R.tuned.nnz_full
    _assert_close_mm(Y.numpy(), _oracle_mm(csr, X), csr, X, nnz_full)
    _assert_close_mm(Y.numpy(), Y_ref, csr, X, nnz_full)

    tuned, dev = A.tuned, A.tuned.operands
    assert (tuned.perm is not None) == (name == "rcm")
    if tuned.perm is not None:
        assert np.array_equal(tuned.perm, R.tuned.perm)
        fn, d = tuned.pure_apply_mm()
        Xt = torch.from_numpy(X)
        assert torch.equal(tuned.decode(fn(d, tuned.encode(Xt))), Y)
    if name == "audikw_grouped_far":
        assert dev.far is not None and dev.far.grouped
    if paired:
        assert dev.has_paired
    assert getattr(dev, "dia_mirrored", False) == mirrored
    # column by column, SpMM gives what SpMV gives (the twins compose
    # identically, so the CPU results are bit-equal)
    for b in range(B):
        assert torch.equal(Y[:, b], tuned.matvec(torch.from_numpy(X[:, b])))
    for w in WRAPPERS:
        assert w.launches == 0


def test_port_mm_applier_runs_reference_plan(monkeypatch):
    """``sbell_apply_mm`` and ``bell2_apply_mm`` give bit-identical
    results on the reference's plans and on the port's (a symmetric plan
    with a sparse far stream, a general plan with its signed peel, a
    paired plan), with the kernel wrappers and with the plain twins."""
    cases = [(__graft_entry__._flagship(), ref_build, build_sbell_plan,
              ops.sym_to_device, ops.sbell_apply_mm)]
    gen = ref_proxies.general_asym(g=12)
    cases.append((gen, ref_general, build_general_plan, ops.to_device,
                  ops.bell2_apply_mm))
    for ref_csr, ref_plan, port_plan, upload, apply_mm in cases:
        Xc = torch.from_numpy(random_X(ref_csr.ncols, 3))
        y_ref_plan = apply_mm(upload(ref_plan(ref_csr), "cpu"), Xc)
        d = upload(port_plan(port_csr(ref_csr)), "cpu")
        assert torch.equal(apply_mm(d, Xc), y_ref_plan)
        assert torch.equal(apply_mm(d, Xc, plain=True), y_ref_plan)
    monkeypatch.setenv("CFS_PAIRED", "force")
    pc = ref_proxies.near_band_paired(n=4000, n_diags=32, max_off=300, seed=5)
    Xp = torch.from_numpy(random_X(pc.nrows, 2))
    ref_plan = ref_build(pc)
    assert ref_plan.nnz_paired > 0
    y_ref_plan = ops.sbell_apply_mm(ops.sym_to_device(ref_plan, "cpu"), Xp)
    d = ops.sym_to_device(build_sbell_plan(port_csr(pc)), "cpu")
    assert d.has_paired
    assert torch.equal(ops.sbell_apply_mm(d, Xp), y_ref_plan)


@pytest.mark.parametrize("fmt", ["0", "1"])
def test_cli_test_spmv_mmf_passes(fmt, tmp_path, capsys):
    """The differential harness on a written symmetric ``.mtx``: tuned
    (general for code 0, SSS for 1) against the untuned CSR oracle and
    the float64 host oracle."""
    csr = proxies.cant_proxy(n=600, half_bw=5, dtype=np.float64)
    coo = csr.to_coo()
    path = tmp_path / "band.mtx"
    write_mmf(path, coo.nrows, coo.ncols, coo.row, coo.col, coo.val,
              symmetric=True)
    assert run_test_cli([str(path), fmt, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith("PASSED!")
    # --dp: the same harness in float64, at the 1e-8 gate
    assert run_test_cli([str(path), fmt, "--device", "cpu", "--dp"]) == 0
    assert capsys.readouterr().out.strip().endswith("PASSED!")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_test_cli([str(path), fmt])  # --device defaults to cuda


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
    """The paired stream runs (against the oracle), and its upload and
    wrapper refuse what the kernel's unchecked reads and scatters cannot
    take: a window outside the chunk's output block, a window count
    other than 2 or 4, int16 words."""
    monkeypatch.setenv("CFS_PAIRED", "force")
    csr = proxies.near_band_paired(n=8000, n_diags=48, max_off=400, seed=3)
    A = ct.SparseMatrix.create(csr, ct.Format.SSS)
    x = random_x(csr.nrows, np.float32)
    y = ct.SpDMV(A, device="cpu")(x).numpy()
    assert A.tuned.operands.has_paired
    _assert_close(y, csr.spmv_host(x.astype(np.float64)), csr, x,
                  A.tuned.nnz_full)
    plan = build_sbell_plan(csr)
    plan.meta[0, 2] = plan.x_rows  # a window past the x operand
    with pytest.raises(ValueError, match="window"):
        ops.sym_to_device(plan, "cpu")
    plan = build_sbell_plan(csr)
    plan.transpose_windows = 3
    with pytest.raises(ValueError, match="transpose_windows"):
        ops.sym_to_device(plan, "cpu")
    d = A.tuned.operands
    with pytest.raises(ValueError, match="int32"):
        bk.sbell_spmv_tiles(
            d.vals, d.packed.short(), d.meta, d.step_block,
            ops.pad_x(torch.from_numpy(x), d.x_rows),
            num_row_tiles=d.num_row_tiles, chunks_per_step=d.chunks_per_step,
            tiles_per_block=d.tiles_per_block, transpose_windows=2,
        )


def test_mirrored_sdia_raises(monkeypatch):
    """Past SDIA_SYM_ROWS_MAX the planner mirrors the diagonals into
    signed offsets, which run ``sdia_gen_tiles`` (B6) and, for SpMM,
    ``sdia_gen_tiles_mm`` (B12): both agree with the oracle. What the
    plan still refuses: a 2-D X to the 1-D applier, and B = 0."""
    _patch_sym_rows_max(monkeypatch)
    csr = proxies.cant_proxy(n=2048)
    A = ct.SparseMatrix.create(csr, ct.Format.SSS)
    op = ct.SpDMV(A, device="cpu")
    assert A.tuned.operands.dia_mirrored
    x = random_x(csr.nrows, np.float32)
    _assert_close(op(x).numpy(), csr.spmv_host(x.astype(np.float64)), csr,
                  x, A.tuned.nnz_full)
    X = random_X(csr.nrows, 2)
    _assert_close_mm(op(X).numpy(), _oracle_mm(csr, X), csr, X,
                     A.tuned.nnz_full)
    with pytest.raises(ValueError, match="sbell_apply_mm"):
        ops.sbell_apply(A.tuned.operands, torch.from_numpy(X))
    with pytest.raises(ValueError, match="B = 0"):
        op(np.ones((csr.nrows, 0), np.float32))


def test_general_path_raises():
    """The general path runs, SpMM included (untuned ``A @ X``), and in
    float64 too; what it still refuses: a 2-D X to the 1-D applier and
    B = 0."""
    coo = COO.random(500, 500, 4.0, seed=1)
    A = ct.SparseMatrix.create(coo, ct.Format.CSR)
    x = np.ones(500, np.float32)
    # untuned: the general oracle path, on the tensor's device
    y = (A @ torch.from_numpy(x)).numpy()
    assert isinstance(A.tuned.operands, ops.Bell2Device)
    _assert_close(y, A.csr.spmv_host(x.astype(np.float64)), A.csr, x,
                  A.tuned.nnz_full)
    X = random_X(500, 2)
    Y = A @ X
    assert Y.shape == (500, 2)
    _assert_close_mm(Y.numpy(), _oracle_mm(A.csr, X), A.csr, X,
                     A.tuned.nnz_full)
    with pytest.raises(ValueError, match="bell2_apply_mm"):
        ops.bell2_apply(A.tuned.operands, torch.ones((500, 2)))
    with pytest.raises(ValueError, match="B = 0"):
        A @ np.ones((500, 0), np.float32)
    y64 = ct.SpDMV(A, dtype=np.float64, device="cpu")(x)
    assert y64.dtype == torch.float64
    _assert_close_f64(y64.numpy(), A.csr, x.astype(np.float64),
                      A.tuned.nnz_full)


def _assert_close_f64(y, csr, x, nnz_full):
    """The float64 gate: ``allclose_spmv`` at 1e-8 with the scale."""
    assert allclose_spmv(y, csr.spmv_host(x), np.float64,
                         nnz_per_row=nnz_full / csr.nrows,
                         scale=csr.spmv_host(x, absolute=True))


def _assert_close_bf16(y, csr, x, nnz_full):
    """The 2-byte gate (5e-2) against the float64 oracle, with the scale."""
    xd = x.astype(np.float64)
    assert allclose_spmv(y, csr.spmv_host(xd), np.float16,
                         nnz_per_row=nnz_full / csr.nrows,
                         scale=csr.spmv_host(xd, absolute=True))


def test_float64_and_bf16_raise():
    """float64 runs (the symmetric route with its halved main diagonal)
    and agrees with the oracle at the float64 gate. bfloat16 values, which
    once raised, run: in float32 a float32 result within a 2-byte type's
    gate; in float64 they are ignored, as the reference's float64 route
    ignores them. Another ``values`` raises."""
    A = _small_sym()
    x = random_x(A.ncols, np.float64)
    y = ct.SpDMV(A, dtype=np.float64, device="cpu")(x)
    assert y.dtype == torch.float64
    assert isinstance(A.tuned.operands, ops.Fp64Device)
    assert 0 in A.tuned.plan.dia.offsets
    _assert_close_f64(y.numpy(), A.csr, x, A.tuned.nnz_full)
    Abf = _small_sym()
    ybf = ct.SpDMV(Abf, values="bfloat16", device="cpu")(x)
    assert ybf.dtype == torch.float32 == Abf.tuned.dtype
    _assert_close_bf16(ybf.numpy(), Abf.csr, x.astype(np.float32),
                       Abf.tuned.nnz_full)
    y64 = ct.SpDMV(_small_sym(), dtype=np.float64, values="bfloat16",
                   device="cpu")(x)
    assert torch.equal(y64, y)
    with pytest.raises(ValueError, match="values"):
        ct.SpDMV(_small_sym(), values="float16", device="cpu")


def test_spmm_raises():
    """SpMM runs on the tuned symmetric path through ``SpDMM`` and
    ``SpDMV`` with a 2-D X, in float32 and in float64, and agrees with
    the oracle, with bfloat16 values too (which it once refused); what it
    refuses: a 2-D X to the 1-D applier, a 1-D x to ``SpDMM``, and B =
    0."""
    A = _small_sym()
    X = random_X(A.ncols, 2)
    Y = ct.SpDMM(A, device="cpu")(X)
    _assert_close_mm(Y.numpy(), _oracle_mm(A.csr, X), A.csr, X,
                     A.tuned.nnz_full)
    assert torch.equal(ct.SpDMV(A, device="cpu")(X), Y)
    A64 = _small_sym()
    X64 = X.astype(np.float64)
    Y64 = ct.SpDMM(A64, dtype=np.float64, device="cpu")(X64)
    assert Y64.dtype == torch.float64 and Y64.shape == Y.shape
    for b in range(X.shape[1]):
        _assert_close_f64(Y64[:, b].numpy(), A64.csr, X64[:, b],
                          A64.tuned.nnz_full)
    with pytest.raises(ValueError, match="B = 0"):
        ct.SpDMM(A64, dtype=np.float64, device="cpu")(X64[:, :0])
    Abf = _small_sym()
    Ybf = ct.SpDMM(Abf, values="bfloat16", device="cpu")(X)
    assert Ybf.dtype == torch.float32 and Ybf.shape == Y.shape
    for b in range(X.shape[1]):
        _assert_close_bf16(Ybf[:, b].numpy(), Abf.csr, X[:, b],
                           Abf.tuned.nnz_full)
    with pytest.raises(ValueError, match="sbell_apply_mm"):
        ops.sbell_apply(A.tuned.operands, torch.from_numpy(X))
    with pytest.raises(ValueError, match="X must be"):
        ct.SpDMM(A, device="cpu")(X[:, 0])
    with pytest.raises(ValueError, match="B = 0"):
        ct.SpDMM(A, device="cpu")(X[:, :0])


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    with pytest.raises(RuntimeError, match="cuda"):
        ct.SpDMV(_small_sym(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ct.SpDMM(_small_sym(), device="cuda")


@pytest.mark.parametrize("entry", ["SpDMV", "SpDMM", "tune_method",
                                   "tune_function", "matmul_numpy",
                                   "matmul_list"])
def test_default_device_is_the_card(entry):
    """Every entry point runs on the card unless the caller asks for the
    CPU: without CUDA the default raises, naming the device, and nothing
    is tuned onto the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a host without")
    A = _small_sym()
    x = np.ones(A.ncols, np.float32)
    call = {
        "SpDMV": lambda: ct.SpDMV(A),
        "SpDMM": lambda: ct.SpDMM(A),
        "tune_method": lambda: A.tune(),
        "tune_function": lambda: tune(A.csr),
        "matmul_numpy": lambda: A @ x,
        "matmul_list": lambda: A.dense_vector_multiply(x.tolist()),
    }[entry]
    with pytest.raises(RuntimeError, match="device cuda"):
        call()
    assert A.tuned is None


def test_untuned_matmul_tunes_onto_the_tensors_device():
    """An untuned ``A @ x`` with a CPU tensor runs on the CPU, SpMV and
    SpMM; once tuned, numpy operands go to the matrix's device."""
    A = _small_sym()
    x = random_x(A.ncols, np.float32)
    y = A @ torch.from_numpy(x)
    assert y.device.type == "cpu" and A.tuned.device.type == "cpu"
    _assert_close(y.numpy(), A.csr.spmv_host(x.astype(np.float64)), A.csr, x,
                  A.tuned.nnz_full)
    assert torch.equal(A @ x, y)
    A2 = _small_sym()
    X = random_X(A2.ncols, 2)
    Y = A2 @ torch.from_numpy(X)
    assert Y.device.type == "cpu" and Y.shape == (A2.nrows, 2)
    assert torch.equal(Y[:, 0], A2 @ X[:, 0])
