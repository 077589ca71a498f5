"""B14 over a row-major X and Y (``sdia_df.sdia_sym_rows_df_mm``, the
CUDA ``sdia_sym_rows_kernel``): the float64 SpMM of a plan that is
diagonals only, X (n, B) read where it lies and Y (n, B) written fresh.

- The plain twin against the reference's double-float
  ``sdia_sym_tiles_df_mm`` (interpret mode) on a 27-point stencil's 14
  offsets (nx = 16 and 20: clusters 0-1, nx - 1 .. nx + 1, nx^2 - nx - 1
  .. and on) and on banded offsets 0-32 as cant's plan has them.
- A numpy model of the kernel as it ships (CTAs of 128 rows, a thread a
  row walking every diagonal, its row side and transpose side read from X
  at X's row stride, a row's 16-byte chunks from the lane's rotation on,
  one launch a group of up to 8 columns in the instance of 2, 4 or 8):
  every read lies inside X, every element of Y is written once, and the
  sums are the twin's.
- ``fp64_apply_mm`` takes the row-major path for a diagonal-only plan and
  a contiguous, 16-byte aligned X of even B (B = 2, 4, 8, 16), returning a
  contiguous (n, B) Y equal to the planes path's bit for bit, and keeps
  the planes path for odd B, a transposed or misaligned X and a plan with
  a residual; the recorder's ``fp64_mm.rows`` / ``fp64_mm.planes`` count
  one an apply.

The kernel itself runs on the card (``tests/test_torch_sdia_rows_card.py``).
Tolerance: 1e-12 of |A| |X| for sums in another order (FMA in the kernel,
the reference's double-float pairs), 0 where the same twin runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfs_spmv_tpu_torch as ct
from __graft_entry__ import _flagship
from cfs_spmv_tpu.ops import bell2_df as ref_bdf
from cfs_spmv_tpu.ops import sdia_df as ref_sdf
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.ops import sdia_df as sdf
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.utils import proxies as pp
from cfs_spmv_tpu_torch.utils import trace

torch.set_num_threads(1)

#: ``kRowsCta`` of ``csrc/spmv_kernels.cu``: rows (threads) a CTA
ROWS_CTA = 128
#: columns a launch serves
GROUP = 8
TOL = 1e-12


def stencil_offsets(nx):
    """The 14 lower offsets of a 27-point stencil on an nx^3 grid."""
    return sorted({dz * nx * nx + dy * nx + dx for dz in (0, 1)
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                   if dz * nx * nx + dy * nx + dx >= 0})


#: name -> (offsets, rows n, value blocks R, columns B); R pads the value
#: rows to the reference's block multiple, past n (values there meet x's
#: zeros)
#: (the twin works column by column: two columns hold it to the
#: reference, whose interpreter takes about a minute a case)
CASES = {
    "stencil_nx16": (stencil_offsets(16), 16 ** 3, 4, 2),
    "stencil_nx20": (stencil_offsets(20), 20 ** 3, 8, 2),
    "banded": (list(range(33)), 3000, 3, 2),
}


def _operands(case):
    offs, n, R, B = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    vals = rng.uniform(-1, 1, (R, len(offs), 8, 128))
    X = rng.uniform(-1, 1, (n, B))
    return offs, vals, X


def _scale(vals, X, offs):
    return sdf.sdia_sym_rows_plain(torch.from_numpy(np.abs(vals)),
                                   torch.from_numpy(np.abs(X)),
                                   offs).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_twin_matches_reference(case):
    """The row-major twin against the reference's double-float B14 on X's
    planes (zero past n), folded in float64: within 1e-12 of |A| |X|."""
    offs, vals, X = _operands(case)
    n, B = X.shape
    R = vals.shape[0]
    assert R % sk._blocks_per_step(R, len(offs)) == 0
    x3d = np.zeros((B, R * 8, 128))
    x3d.reshape(B, -1)[:, :n] = X.T
    yh, yl = ref_sdf.sdia_sym_tiles_df_mm(
        *(jnp.asarray(a) for a in (*ref_bdf.split_df(vals),
                                   *ref_bdf.split_df(x3d))),
        offsets=tuple(offs), interpret=True)
    ref = (np.asarray(yh, np.float64) + np.asarray(yl, np.float64))
    ref = ref.reshape(B, -1)[:, :n].T
    offs_t = torch.tensor(offs, dtype=torch.int32)
    Y = sdf.sdia_sym_rows_df_mm(torch.from_numpy(vals), torch.from_numpy(X),
                                offs_t)
    assert Y.shape == (n, B) and Y.is_contiguous()
    assert Y.dtype == torch.float64
    err = np.abs(Y.numpy() - ref) / np.maximum(_scale(vals, X, offs), 1e-300)
    assert err.max() < TOL
    assert sdf.sdia_sym_rows_df_mm.launches == 0  # CPU tensors never launch


def _groups(B):
    """(first column, live columns, instance width) of each launch."""
    out = []
    for b0 in range(0, B, GROUP):
        nr = min(GROUP, B - b0)
        out.append((b0, nr, 2 if nr <= 2 else 4 if nr <= 4 else 8))
    return out


def _kernel_model(vals, X, offs):
    """(Y, read, writes) of ``sdia_sym_rows_kernel`` over X (n, B): for
    each launch of a group (b0, nr, width), thread h of CTA h // 128
    (threads past n return) walks diagonals 0 .. D-1, adding v_j[h] x[h -
    d_j] where h - d_j >= 0 and v_j[h + d_j] x[h + d_j] where h + d_j < n
    (values past the value rows read 0), each x row read chunk by chunk
    from the lane's rotation on (slot k <- chunk (k + rot) % chunks, rot
    from lane h % 32), then stores chunk (k + rot) % chunks of its row
    from slot k, live chunks only. ``read`` counts the x elements read,
    ``writes`` the y elements written."""
    n, B = X.shape
    R, D = vals.shape[:2]
    nv = R * 1024
    vd = vals.transpose(1, 0, 2, 3).reshape(D, nv)
    Y = np.full((n, B), np.nan)
    read = np.zeros((n, B), np.int64)
    writes = np.zeros((n, B), np.int64)
    threads = -(-n // ROWS_CTA) * ROWS_CTA
    h = np.arange(threads)
    h = h[h < n]  # the threads past n return at once
    lane = h % 32
    for b0, nr, width in _groups(B):
        chunks = width // 2
        rot = (lane // (8 // chunks)) % chunks if chunks > 1 else 0 * lane
        acc = np.zeros((len(h), width))
        for j, d in enumerate(offs):
            v = np.where(h < nv, vd[j, np.minimum(h, nv - 1)], 0.0)
            t = h + d
            w = np.where(t < nv, vd[j, np.minimum(t, nv - 1)], 0.0)
            for coef, src, ok in ((v, h - d, h - d >= 0), (w, t, t < n)):
                assert (src[ok] >= 0).all() and (src[ok] < n).all()
                for k in range(chunks):
                    c = (k + rot) % chunks
                    live = ok & (2 * c < nr)
                    for i in (0, 1):
                        col = b0 + 2 * c + i
                        assert (col[live] < B).all()
                        np.add.at(read, (src[live], col[live]), 1)
                        xv = np.where(live, X[np.clip(src, 0, n - 1),
                                              np.minimum(col, B - 1)], 0.0)
                        acc[:, 2 * k + i] += coef * xv
        for k in range(chunks):
            c = (k + rot) % chunks
            live = 2 * c < nr
            for i in (0, 1):
                col = b0 + 2 * c + i
                Y[h[live], col[live]] = acc[live, 2 * k + i]
                np.add.at(writes, (h[live], col[live]), 1)
    return Y, read, writes


@pytest.mark.parametrize("B", [2, 4, 6, 10, 16])
@pytest.mark.parametrize("case", ["stencil_nx16", "banded"])
def test_kernel_model_reads_inside_x_and_writes_every_element_once(case,
                                                                   B):
    """The model of the kernel at B of 2 to 16 (a group of 6 in the
    instance of 8, groups of 8 + 2 and 8 + 8): every read inside X, every
    element of X read, every element of Y written exactly once, the sums
    within 1e-12 of |A| |X| of the twin."""
    offs, vals, X0 = _operands(case)
    n = X0.shape[0]
    X = np.random.default_rng(B).uniform(-1, 1, (n, B))
    Y, read, writes = _kernel_model(vals, X, offs)
    assert (writes == 1).all()
    assert (read > 0).all()
    twin = sdf.sdia_sym_rows_plain(torch.from_numpy(vals),
                                   torch.from_numpy(X), offs).numpy()
    err = np.abs(Y - twin) / np.maximum(_scale(vals, X, offs), 1e-300)
    assert err.max() < TOL


def test_kernel_model_rotation_spreads_a_quarter_warp():
    """The chunk rotation: at 8 columns (four 16-byte chunks, 64 bytes a
    row) the 8 lanes of a quarter warp reading 8 consecutive rows, at any
    row shift, start on 8 distinct 16-byte bank groups of a 128-byte bank
    row; at 4 columns likewise; at 2 columns rows are 16 bytes."""
    for chunks in (1, 2, 4):
        row_units = chunks  # 16-byte units a row
        for quarter in range(4):
            lanes = np.arange(8) + 8 * quarter
            rot = ((lanes // (8 // chunks)) % chunks if chunks > 1
                   else 0 * lanes)
            for shift in range(-9, 9):
                for k in range(chunks):
                    unit = (lanes + shift) * row_units + (k + rot) % chunks
                    assert len(set(unit % 8)) == 8


def _dia_only(g=14):
    """A 27-point stencil (``stencil27(g)``) tuned in float64 on the
    CPU: 14 diagonals, nothing left for the stream."""
    A = ct.SparseMatrix.create(pp.stencil27(g=g), ct.Format.SSS)
    ct.SpDMM(A, ct.Tuning.AGGRESSIVE, dtype=np.float64, device="cpu")
    d = A.tuned.operands
    assert d.entries is None and not d.has_work
    assert d.dia_offsets.tolist() == stencil_offsets(g)
    return A, d


def _recorded_apply(d, X):
    trace.collect()
    with trace.recording():
        Y = ops.fp64_apply_mm(d, X)
    return Y, trace.collect().counters


@pytest.mark.parametrize("B", [2, 4, 8, 16])
def test_fp64_apply_mm_rows_path_matches_planes_path(B):
    """A diagonal-only plan and a contiguous aligned X of even B: the
    row-major path, one ``fp64_mm.rows`` an apply, a contiguous (n, B) Y
    equal bit for bit to the planes path's on the same values (X given
    transposed), which counts one ``fp64_mm.planes``; both agree with the
    float64 oracle."""
    A, d = _dia_only()
    X = torch.from_numpy(np.random.default_rng(B).uniform(-1, 1,
                                                          (A.ncols, B)))
    assert ops._rows_path(d, X)
    Y, counts = _recorded_apply(d, X)
    assert counts.get("fp64_mm.rows") == 1 and "fp64_mm.planes" not in counts
    assert Y.shape == (A.nrows, B) and Y.is_contiguous()
    Xt = X.T.contiguous().T
    assert not Xt.is_contiguous() and not ops._rows_path(d, Xt)
    Yp, counts = _recorded_apply(d, Xt)
    assert counts.get("fp64_mm.planes") == 1 and "fp64_mm.rows" not in counts
    assert torch.equal(Y, Yp)
    for b in range(B):
        ref = A.csr.spmv_host(X[:, b].numpy())
        scale = A.csr.spmv_host(X[:, b].numpy(), absolute=True)
        assert (np.abs(Y[:, b].numpy() - ref) <= TOL * scale).all()


@pytest.mark.parametrize("form", ["odd_B", "transposed", "misaligned"])
def test_fp64_apply_mm_keeps_planes_path(form):
    """Odd B, a transposed X and an X whose rows are not 16-byte aligned
    take the planes path (``fp64_mm.planes``), whose result is the
    row-major twin's."""
    A, d = _dia_only()
    n = A.ncols
    rng = np.random.default_rng(3)
    if form == "odd_B":
        X = torch.from_numpy(rng.uniform(-1, 1, (n, 3)))
    elif form == "transposed":
        X = torch.from_numpy(rng.uniform(-1, 1, (4, n))).T
    else:
        base = torch.from_numpy(rng.uniform(-1, 1, n * 4 + 1))
        X = base[1:].view(n, 4)
        assert X.is_contiguous() and X.data_ptr() % 16 == 8
    assert not ops._rows_path(d, X)
    Y, counts = _recorded_apply(d, X)
    assert counts.get("fp64_mm.planes") == 1 and "fp64_mm.rows" not in counts
    want = sdf.sdia_sym_rows_plain(d.dia_vals, X.contiguous(), d.dia_offsets)
    assert torch.equal(Y, want)


def test_fp64_apply_mm_with_a_residual_keeps_planes_path():
    """A float64 plan with a residual beside its diagonals (the
    flagship's peel: entries) multiplies through planes."""
    ref = _flagship(n=4096, deg=16, dtype=np.float64)
    A = ct.SparseMatrix.create(
        CSR(ref.nrows, ref.ncols, ref.indptr.copy(), ref.indices.copy(),
            ref.data.copy(), ref.symmetric), ct.Format.SSS)
    ct.SpDMM(A, ct.Tuning.AGGRESSIVE, dtype=np.float64, device="cpu")
    d = A.tuned.operands
    assert d.entries is not None and d.dia_vals is not None
    X = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1,
                                                          (A.ncols, 8)))
    assert not ops._rows_path(d, X)
    _, counts = _recorded_apply(d, X)
    assert counts.get("fp64_mm.planes") == 1 and "fp64_mm.rows" not in counts


@pytest.mark.parametrize("bad", ["odd_B", "float32", "transposed"])
def test_rows_wrapper_refuses_what_the_kernel_cannot_read(bad):
    offs, vals, X = _operands("banded")
    offs_t = torch.tensor(offs, dtype=torch.int32)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (X.shape[0], 3 if bad == "odd_B" else 4)))
    x = {"odd_B": x, "float32": x.float(),
         "transposed": x.T.contiguous().T}[bad]
    with pytest.raises(ValueError):
        sdf.sdia_sym_rows_df_mm(torch.from_numpy(vals), x, offs_t)
