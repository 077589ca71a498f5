"""Kernels B1 and B6 (dense-diagonal streams, symmetric and signed) and
their multi-RHS forms B11 and B12: the port's plain twins against the
reference's Pallas ``sdia_sym_tiles``, ``sdia_gen_tiles``,
``sdia_sym_tiles_mm`` and ``sdia_gen_tiles_mm`` (interpret mode), and
each MM twin against its SpMV twin column by column. A numpy model of the
symmetric CUDA kernel as it ships (``_sym_model``: CTAs of 128 rows, two
slices of a row's diagonals, both sides gathered, and over planes, given
``stage_x``, the CTA's 256-row x window staged with zeros outside x) runs
in float32 and float64 (B1, B11, B13, B14) against the twin and the
reference, with the staging rule the upload applies (``stages_x``).

B12's kernel reads X interleaved: its twin is held against the
reference's ``sdia_gen_tiles_mm`` with X given in place as (m, B) (B of 2
and 8; ``gen_x`` must return a view of it), through ``interleave_x`` (B
of 3 and 11), and as a misaligned or strided (m, B) X that ``gen_x`` must
copy. The store form (a dia-only plan's, B6 from x itself and B12) is
held against the reference from zero tiles, written into NaN-poisoned
tiles whose rows past R * 1024 must read +0. A numpy model of the signed
kernel's split of a row's diagonals over 1, 2 or 4 threads
(``_gen_model``), adding and storing, runs against the twin and the
reference, and ``gen_slices`` picks 2 threads a row on the narrow plans
only.

Random values on every diagonal (padding rows included), offsets that
hit lane shift 0 and sublane shifts > 0 and cross 1024-row blocks (for
B6 also the main diagonal and super-diagonals reading ahead), fewer
output tiles than value rows, a shorter x than the value rows, a
nonzero incoming y, and (B6) a NaN-poisoned y tail past the value rows,
which must keep its value. The MM cases add a Y whose planes sit at a
plane stride larger than a plane (a column slice of a wider buffer).

Tolerance: ``allclose_spmv`` at float32 (float64 for the float64 model
cases) with the backward-error scale (|vals|, |x|, |y| through the
float64 twin), since the Pallas interpreter, the twin and the model sum
in different orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfs_spmv_tpu.ops import bell2_df as ref_bdf
from cfs_spmv_tpu.ops import sdia_df as ref_sdf
from cfs_spmv_tpu.ops.sdia_kernel import sdia_gen_tiles as ref_sdia_gen
from cfs_spmv_tpu.ops.sdia_kernel import sdia_gen_tiles_mm as ref_sdia_gen_mm
from cfs_spmv_tpu.ops.sdia_kernel import sdia_sym_tiles as ref_sdia_sym
from cfs_spmv_tpu.ops.sdia_kernel import sdia_sym_tiles_mm as ref_sdia_sym_mm
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops.sdia_kernel import (
    _blocks_per_step,
    sdia_gen_tiles,
    sdia_gen_tiles_mm,
    sdia_gen_tiles_mm_plain,
    sdia_gen_tiles_plain,
    sdia_sym_tiles,
    sdia_sym_tiles_mm,
    sdia_sym_tiles_mm_plain,
    sdia_sym_tiles_plain,
)
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

torch.set_num_threads(1)

OFFSETS = (1, 2, 127, 128, 129, 300, 1029)
GEN_OFFSETS = (0, 1, -1, 127, -128, 129, -300, 1029, -1500)


@pytest.mark.parametrize("R,T,x_rows", [(3, 20, 22), (8, 61, 40)])
def test_sdia_sym_plain_matches_reference(R, T, x_rows):
    D = len(OFFSETS)
    assert R % _blocks_per_step(R, D) == 0  # the reference kernel's contract
    rng = np.random.default_rng(R * 100 + T)
    vals = rng.uniform(-1, 1, (R, D, 8, 128)).astype(np.float32)
    x2d = rng.uniform(-1, 1, (x_rows, 128)).astype(np.float32)
    y0 = rng.uniform(-1, 1, (T, 128)).astype(np.float32)

    ref = np.asarray(ref_sdia_sym(
        jnp.asarray(vals), jnp.asarray(x2d), jnp.asarray(y0),
        offsets=OFFSETS, interpret=True,
    ))
    offs = torch.tensor(OFFSETS, dtype=torch.int32)
    y = sdia_sym_tiles(torch.from_numpy(vals), torch.from_numpy(x2d),
                       torch.from_numpy(y0.copy()), offs)
    scale = sdia_sym_tiles_plain(
        torch.from_numpy(np.abs(vals)).double(),
        torch.from_numpy(np.abs(x2d)).double(),
        torch.from_numpy(np.abs(y0)).double(), offs,
    )
    assert y.shape == (T, 128)
    assert allclose_spmv(y.numpy(), ref, np.float32, nnz_per_row=2 * D,
                         scale=scale.numpy())
    # the incoming y is accumulated in place, as the reference aliases it
    assert not np.array_equal(y.numpy(), y0)


@pytest.mark.parametrize("R,T,x_rows", [(3, 20, 22), (8, 61, 70), (2, 19, 16)])
def test_sdia_gen_plain_matches_reference(R, T, x_rows):
    D = len(GEN_OFFSETS)
    assert R % _blocks_per_step(R, D) == 0
    rng = np.random.default_rng(R * 100 + T + 1)
    vals = rng.uniform(-1, 1, (R, D, 8, 128)).astype(np.float32)
    x2d = rng.uniform(-1, 1, (x_rows, 128)).astype(np.float32)
    y0 = rng.uniform(-1, 1, (T, 128)).astype(np.float32)
    body = min(T, R * 8)  # rows past the value blocks keep their value
    y0[body:] = np.nan

    ref = np.asarray(ref_sdia_gen(
        jnp.asarray(vals), jnp.asarray(x2d), jnp.asarray(y0),
        offsets=GEN_OFFSETS, interpret=True,
    ))
    assert ref.shape == (body, 128)
    offs = torch.tensor(GEN_OFFSETS, dtype=torch.int32)
    y_in = torch.from_numpy(y0.copy())
    y = sdia_gen_tiles(torch.from_numpy(vals), torch.from_numpy(x2d), y_in,
                       offs)
    assert y.data_ptr() == y_in.data_ptr() and y.shape == (T, 128)
    scale = sdia_gen_tiles_plain(
        torch.from_numpy(np.abs(vals)).double(),
        torch.from_numpy(np.abs(x2d)).double(),
        torch.from_numpy(np.abs(y0)).double(), offs,
    )
    assert np.isnan(y.numpy()[body:]).all()
    assert allclose_spmv(y.numpy()[:body], ref, np.float32,
                         nnz_per_row=D, scale=scale.numpy()[:body])
    assert not np.array_equal(y.numpy()[:body], y0[:body])


def _strided_planes(a, extra=3):
    """``a`` (B, T, 128) as a column slice of a (B, T + extra, 128)
    buffer: each plane contiguous, the plane stride past the plane."""
    buf = torch.full((a.shape[0], a.shape[1] + extra, 128), float("nan"))
    buf[:, : a.shape[1]] = torch.from_numpy(a)
    return buf[:, : a.shape[1]]


@pytest.mark.parametrize("R,T,x_rows,B", [(3, 20, 22, 3), (8, 61, 40, 2)])
def test_sdia_sym_mm_plain_matches_reference(R, T, x_rows, B):
    """B11: nonzero incoming Y, accumulated in place in strided planes."""
    D = len(OFFSETS)
    rng = np.random.default_rng(R * 100 + T + 2)
    vals = rng.uniform(-1, 1, (R, D, 8, 128)).astype(np.float32)
    x3d = rng.uniform(-1, 1, (B, x_rows, 128)).astype(np.float32)
    y0 = rng.uniform(-1, 1, (B, T, 128)).astype(np.float32)

    ref = np.asarray(ref_sdia_sym_mm(
        jnp.asarray(vals), jnp.asarray(x3d), jnp.asarray(y0),
        offsets=OFFSETS, interpret=True,
    ))
    offs = torch.tensor(OFFSETS, dtype=torch.int32)
    y_in = _strided_planes(y0)
    y = sdia_sym_tiles_mm(torch.from_numpy(vals), torch.from_numpy(x3d),
                          y_in, offs)
    assert y.data_ptr() == y_in.data_ptr() and y.shape == (B, T, 128)
    scale = sdia_sym_tiles_mm_plain(
        torch.from_numpy(np.abs(vals)).double(),
        torch.from_numpy(np.abs(x3d)).double(),
        torch.from_numpy(np.abs(y0)).double(), offs,
    )
    assert allclose_spmv(y.numpy(), ref, np.float32, nnz_per_row=2 * D,
                         scale=scale.numpy())
    assert not np.array_equal(y.numpy(), y0)
    # column by column, the MM twin is the SpMV twin
    for b in range(B):
        yb = sdia_sym_tiles_plain(torch.from_numpy(vals),
                                  torch.from_numpy(x3d[b]),
                                  torch.from_numpy(y0[b].copy()), offs)
        assert torch.equal(yb, y[b])


@pytest.mark.parametrize("R,T,x_rows,B", [(3, 20, 22, 3), (2, 19, 16, 2)])
def test_sdia_gen_mm_plain_matches_reference(R, T, x_rows, B):
    """B12: signed offsets with |d| >= 128 and d = 0, nonzero Y, a
    NaN-poisoned Y tail past the value blocks that keeps its value."""
    D = len(GEN_OFFSETS)
    rng = np.random.default_rng(R * 100 + T + 3)
    vals = rng.uniform(-1, 1, (R, D, 8, 128)).astype(np.float32)
    x3d = rng.uniform(-1, 1, (B, x_rows, 128)).astype(np.float32)
    y0 = rng.uniform(-1, 1, (B, T, 128)).astype(np.float32)
    body = min(T, R * 8)
    y0[:, body:] = np.nan

    ref = np.asarray(ref_sdia_gen_mm(
        jnp.asarray(vals), jnp.asarray(x3d), jnp.asarray(y0),
        offsets=GEN_OFFSETS, interpret=True,
    ))
    assert ref.shape == (B, body, 128)
    offs = torch.tensor(GEN_OFFSETS, dtype=torch.int32)
    y_in = _strided_planes(y0)
    y = sdia_gen_tiles_mm(torch.from_numpy(vals), torch.from_numpy(x3d),
                          y_in, offs)
    assert y.data_ptr() == y_in.data_ptr() and y.shape == (B, T, 128)
    scale = sdia_gen_tiles_mm_plain(
        torch.from_numpy(np.abs(vals)).double(),
        torch.from_numpy(np.abs(x3d)).double(),
        torch.from_numpy(np.abs(y0)).double(), offs,
    )
    assert np.isnan(y.numpy()[:, body:]).all()
    assert allclose_spmv(y.numpy()[:, :body], ref, np.float32,
                         nnz_per_row=D, scale=scale.numpy()[:, :body])
    for b in range(B):
        yb = sdia_gen_tiles_plain(torch.from_numpy(vals),
                                  torch.from_numpy(x3d[b]),
                                  torch.from_numpy(y0[b].copy()), offs)
        assert torch.equal(yb[:body], y[b, :body])


def test_sdia_sym_wrapper_checks_operands():
    vals = torch.zeros((1, 2, 8, 128))
    x2d = torch.zeros((8, 128))
    y = torch.zeros((8, 128))
    offs = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        sdia_sym_tiles(vals, x2d, y, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(TypeError):
        sdia_sym_tiles(vals.double(), x2d, y, offs)
    with pytest.raises(ValueError):  # offsets must be int32
        sdia_gen_tiles(vals, x2d, y, torch.tensor([0, -1]))
    # the MM wrappers: 3-D planes of one count, float32, each contiguous
    x3d, y3d = torch.zeros((2, 8, 128)), torch.zeros((2, 8, 128))
    for mm in (sdia_sym_tiles_mm, sdia_gen_tiles_mm):
        with pytest.raises(ValueError, match="x3d"):  # a 2-D x
            mm(vals, x2d, y3d, offs)
        with pytest.raises(ValueError, match="planes"):  # B differs
            mm(vals, x3d, y3d[:1], offs)
        with pytest.raises(TypeError, match="float64.*float32"):
            mm(vals, x3d, y3d.double(), offs)  # a mix names both types
        with pytest.raises(ValueError, match="contiguous"):
            mm(vals, torch.zeros((2, 128, 8)).transpose(1, 2), y3d, offs)
        with pytest.raises(ValueError, match="no planes|planes"):
            mm(vals, x3d[:0], y3d[:0], offs)
    for w in (sdia_sym_tiles, sdia_gen_tiles, sdia_sym_tiles_mm,
              sdia_gen_tiles_mm):
        assert w.launches == 0  # CPU tensors never launch


# -- the symmetric CUDA kernel as it ships, as a numpy model ---------------

#: ``kSdiaRows`` and ``kSdiaSlices`` of ``csrc/spmv_kernels.cu``
SDIA_ROWS, SDIA_SLICES = 128, 2
#: ``utils/proxies.stencil27(g=40)``'s lower diagonals: past a value block
STENCIL27_OFFSETS = (1, 39, 40, 41, 1559, 1560, 1561, 1599, 1600, 1601,
                     1639, 1640, 1641)
#: mostly within the halo, as on cant: 64 the last staged offset, 65 the
#: first gathered one
NEAR_OFFSETS = (1, 2, 3, 17, 63, 64, 65, 700)


def _sym_model(vals, x3d, y3d, offsets, stage_x):
    """``y3d + (L + Lᵀ) x3d`` as ``sdia_sym_kernel`` computes it, in the
    values' type, one group of up to 8 planes at a time (the instance of
    1, 2, 4 or 8 planes that holds it). A CTA takes 128 value rows h up to
    y's end; slice s of each row takes diagonals s, s + 2, ... A group of
    two planes or more, given ``stage_x``, first stages the CTA's x window
    x[r0 - 64, r0 + 192) (zero outside [0, x_len)), and an offset d <= 64
    reads x[h - d] and x[h + d] there, at 64 + r - d and 64 + r + d; other
    offsets, and one plane, read x itself, zero outside it. The row side
    is v[h] x[h - d]; the transpose side gathers v[h + d] x[h + d] where h
    + d lies below both the value rows and x's end. The slices' sums join
    per row and are added to the rows of y."""
    R, D = vals.shape[:2]
    NV = R * 1024
    vd = vals.transpose(1, 0, 2, 3).reshape(D, NV)
    B = x3d.shape[0]
    xf = x3d.reshape(B, -1)
    XL = xf.shape[1]
    y = y3d.reshape(B, -1).copy()
    YL = y.shape[1]
    r = np.arange(SDIA_ROWS)
    halo = sk.SDIA_HALO

    def x_at(planes, i):
        return np.where((i >= 0) & (i < XL),
                        xf[planes][:, np.clip(i, 0, XL - 1)], 0)

    def v_at(j, i, ok):
        return np.where(ok, vd[j, np.clip(i, 0, NV - 1)], 0)

    for g0 in range(0, B, 8):
        planes = slice(g0, min(B, g0 + 8))
        staged = stage_x and min(B, g0 + 8) - g0 > 1
        for r0 in range(0, min(NV, YL), SDIA_ROWS):
            h = r0 + r
            if staged:
                window = x_at(planes, r0 - halo + np.arange(
                    SDIA_ROWS + 2 * halo))
            sums = np.zeros((SDIA_SLICES,) + y[planes, :SDIA_ROWS].shape,
                            vals.dtype)
            for s in range(SDIA_SLICES):
                for j in range(s, D, SDIA_SLICES):
                    d = offsets[j]
                    v = v_at(j, h, h < NV)
                    t = h + d
                    w = v_at(j, t, (t < NV) & (t < XL))
                    if staged and d <= halo:
                        below, above = halo + r - d, halo + r + d
                        assert below.min() >= 0 and above.max() < window.shape[1]
                        sums[s] += v * window[:, below] + w * window[:, above]
                    else:
                        sums[s] += v * x_at(planes, h - d) + w * x_at(planes, t)
            rows = h < YL
            y[planes, h[rows]] += sums.sum(0)[:, rows]
    return y.reshape(y3d.shape)


#: name -> (type, offsets, value blocks R, y tiles T, x rows, planes B):
#: fewer y rows than value rows, x shorter than the value rows and ending
#: inside a CTA's staged window (float64: the reference's double-float
#: kernel gives the rows of x only, so x reaches y's end), the halved main
#: diagonal at offset 0 in float64, offsets on both sides of the staging
#: rule (``NEAR_OFFSETS`` stage, ``OFFSETS`` and stencil27's do not), and
#: groups of 8 + 3 and 8 + 1 planes (a group of one never stages)
MODEL_CASES = {
    "f32_offsets": (np.float32, OFFSETS, 3, 20, 22, 1),
    "f32_offsets_mm": (np.float32, OFFSETS, 3, 23, 16, 3),
    "f32_near_mm": (np.float32, NEAR_OFFSETS, 3, 24, 21, 3),
    "f32_near_mm11": (np.float32, NEAR_OFFSETS, 1, 7, 6, 11),
    "f32_stencil27_mm": (np.float32, STENCIL27_OFFSETS, 3, 24, 21, 3),
    "f64_offsets": (np.float64, (0,) + OFFSETS, 3, 23, 24, 1),
    "f64_near_mm": (np.float64, (0,) + NEAR_OFFSETS, 3, 20, 22, 2),
    "f64_near_mm9": (np.float64, (0,) + NEAR_OFFSETS, 1, 7, 7, 9),
    "f64_stencil27": (np.float64, (0,) + STENCIL27_OFFSETS, 3, 20, 24, 1),
    "f64_stencil27_mm": (np.float64, (0,) + STENCIL27_OFFSETS, 3, 17, 24, 2),
}


@functools.lru_cache(maxsize=None)
def _model_operands(case):
    """(vals, x3d, y0, the reference's result) of a model case: float32
    through the reference's ``sdia_sym_tiles(_mm)``, float64 through its
    double-float ``sdia_sym_tiles_df(_mm)`` (from zero tiles, folded in
    float64, plus y0), both in interpret mode."""
    dtype, offs, R, T, x_rows, B = MODEL_CASES[case]
    assert R % _blocks_per_step(R, len(offs)) == 0
    rng = np.random.default_rng(sum(map(ord, case)))
    vals = rng.uniform(-1, 1, (R, len(offs), 8, 128)).astype(dtype)
    x3d = rng.uniform(-1, 1, (B, x_rows, 128)).astype(dtype)
    y0 = rng.uniform(-1, 1, (B, T, 128)).astype(dtype)
    if dtype == np.float32:
        if B == 1:
            ref = np.asarray(ref_sdia_sym(
                jnp.asarray(vals), jnp.asarray(x3d[0]), jnp.asarray(y0[0]),
                offsets=offs, interpret=True))[None]
        else:
            ref = np.asarray(ref_sdia_sym_mm(
                jnp.asarray(vals), jnp.asarray(x3d), jnp.asarray(y0),
                offsets=offs, interpret=True))
    else:
        kernel = (ref_sdf.sdia_sym_tiles_df if B == 1
                  else ref_sdf.sdia_sym_tiles_df_mm)
        yh, yl = kernel(*(jnp.asarray(a) for a in (
            *ref_bdf.split_df(vals),
            *ref_bdf.split_df(x3d[0] if B == 1 else x3d))),
            offsets=offs, interpret=True)
        ref = (np.asarray(yh, np.float64) + np.asarray(yl, np.float64))
        ref = ref.reshape(B, -1)[:, : T * 128].reshape(B, T, 128) + y0
    return vals, x3d, y0, ref


@pytest.mark.parametrize("stage_x", ["rule", False, True])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_sdia_sym_kernel_model_matches_twin_and_reference(case, stage_x):
    """The shipped kernel as the numpy model, x staged as the upload's
    rule says (``rule``) and either way (any value gives the same sums):
    against the plain twin and the reference."""
    dtype, offs = MODEL_CASES[case][:2]
    if stage_x == "rule":
        stage_x = sk.stages_x(offs)
        assert stage_x == ("near" in case)
    vals, x3d, y0, ref = _model_operands(case)
    got = _sym_model(vals, x3d, y0, offs, stage_x)
    t_offs = torch.tensor(offs, dtype=torch.int32)
    tv, tx = torch.from_numpy(vals), torch.from_numpy(x3d)
    plain = sdia_sym_tiles_mm_plain(tv, tx, torch.from_numpy(y0.copy()),
                                    t_offs, stage_x=stage_x).numpy()
    scale = sdia_sym_tiles_mm_plain(
        tv.abs().double(), tx.abs().double(),
        torch.from_numpy(np.abs(y0)).double(), t_offs).numpy()
    D = len(offs)
    assert got.dtype == dtype and np.isfinite(got).all()
    for want in (plain, ref):
        assert allclose_spmv(got, want, dtype, nnz_per_row=2 * D,
                             scale=scale)
    assert not np.array_equal(got, y0)


@pytest.mark.parametrize("offsets,stages", [
    (OFFSETS, False), (STENCIL27_OFFSETS, False), (NEAR_OFFSETS, True),
    ((0,) + OFFSETS, False), ((1, 64, 65, 1029), True), ((65,), False),
    ((0,), True), ((), False)])
def test_sdia_sym_stages_x_rule(offsets, stages):
    """Staging over planes where at least half the offsets lie within
    the 64-row halo (exactly half counts; 64 is in, 65 out)."""
    assert sk.stages_x(offsets) is stages


@pytest.mark.parametrize("proxy,dtype,stages", [
    ("cant", np.float32, True), ("stencil27", np.float32, False),
    ("cant", np.float64, True), ("stencil27", np.float64, False)])
def test_upload_sets_dia_stage_x(proxy, dtype, stages):
    """The upload decides the staging once from the plan's offsets
    (cant's 1-32 stage; stencil27's, 4 of 13 within 64, do not), and the
    SpMM applier's result does not depend on it."""
    import cfs_spmv_tpu_torch as ct
    from cfs_spmv_tpu_torch.utils import proxies as pp

    csr = pp.cant_proxy(n=4096) if proxy == "cant" else pp.stencil27(g=12)
    A = ct.SparseMatrix.create(csr, ct.Format.SSS)
    mm = ct.SpDMM(A, ct.Tuning.AGGRESSIVE, dtype=dtype, device="cpu")
    d = A.tuned.operands
    assert d.dia_offsets is not None
    assert d.dia_stage_x is stages
    assert d.dia_stage_x == sk.stages_x(d.dia_offsets.tolist())
    X = np.random.default_rng(3).uniform(-1, 1, (A.ncols, 3)).astype(dtype)
    Y = np.asarray(mm(torch.from_numpy(X)))
    d.dia_stage_x = not stages
    assert np.array_equal(np.asarray(mm(torch.from_numpy(X))), Y)


# -- B12 over an interleaved X, its store form and its slices --------------


def _gen_case(R, T, x_rows, B, seed, short=37):
    """(vals, X (m, B) with m = x_rows * 128 - short, y0 (B, T, 128)) in
    float32: x ends inside a tile, so reading it in place leans on the
    kernel's bound check for the zeros the planes copy used to hold."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1, 1, (R, len(GEN_OFFSETS), 8, 128)).astype(np.float32)
    X = rng.uniform(-1, 1, (x_rows * 128 - short, B)).astype(np.float32)
    y0 = rng.uniform(-1, 1, (B, T, 128)).astype(np.float32)
    return vals, X, y0


def _planes_of(X, x_rows):
    """The (B, x_rows, 128) zero-padded planes of an (m, B) X, in numpy."""
    m, B = X.shape
    x3d = np.zeros((B, x_rows * 128), np.float32)
    x3d[:, :m] = X.T
    return x3d.reshape(B, x_rows, 128)


def _ref_gen_mm(vals, x3d, y0):
    return np.asarray(ref_sdia_gen_mm(
        jnp.asarray(vals), jnp.asarray(x3d), jnp.asarray(y0),
        offsets=GEN_OFFSETS, interpret=True))


@pytest.mark.parametrize("how,B", [
    ("in_place", 2), ("in_place", 8), ("interleave_x", 3),
    ("interleave_x", 11), ("misaligned", 8), ("strided", 8)])
def test_sdia_gen_mm_interleaved_x_matches_reference(how, B):
    """B12's twin over the X its kernel reads: an (m, B) X in place (B of
    2 or 8, contiguous, 32-byte aligned: ``gen_x`` returns a view of it,
    x_len = m), ``interleave_x``'s copy at B = 3 and 11 (a group of 8
    and one of 4 planes, the fourth zero), and a misaligned or a strided
    (m, B) X, which ``gen_x`` must copy. Against the reference's
    ``sdia_gen_tiles_mm`` in interpret mode on the zero-padded planes, a
    NaN tail past the value blocks kept, and bit for bit against the
    wrapper given the planes."""
    R, T, x_rows = 3, 26, 22
    vals, X, y0 = _gen_case(R, T, x_rows, B, seed=B + len(how))
    body = R * 8
    y0[:, body:] = np.nan
    x3d = _planes_of(X, x_rows)
    ref = _ref_gen_mm(vals, x3d, y0)
    Xt = torch.from_numpy(X).clone()  # torch's allocator aligns to 64 B
    if how == "misaligned":  # a contiguous view 4 bytes into a buffer
        Xt = torch.zeros(X.size + 8)[1:1 + X.size].view(X.shape)
        Xt.copy_(torch.from_numpy(X))
        assert Xt.is_contiguous() and Xt.data_ptr() % 32
    elif how == "strided":
        Xt = torch.zeros((X.shape[0], B + 5))[:, :B]
        Xt.copy_(torch.from_numpy(X))
        assert not Xt.is_contiguous()
    xg = sk.gen_x(Xt, x_rows)
    if how == "in_place":
        assert xg.data_ptr() == Xt.data_ptr() and xg.shape == (B, X.shape[0])
    else:
        widths = {3: 4, 8: 8, 11: 12}[B]
        assert xg.data_ptr() != Xt.data_ptr()
        assert xg.shape == (widths, x_rows * 128) and xg.is_contiguous()
    offs = torch.tensor(GEN_OFFSETS, dtype=torch.int32)
    tv = torch.from_numpy(vals)
    y_in = _strided_planes(y0)
    y = sdia_gen_tiles_mm(tv, xg, y_in, offs, planes=B)
    assert y.data_ptr() == y_in.data_ptr() and y.shape == (B, T, 128)
    scale = sdia_gen_tiles_mm_plain(
        tv.abs().double(), torch.from_numpy(np.abs(x3d)).double(),
        torch.from_numpy(np.abs(y0)).double(), offs)
    assert np.isnan(y.numpy()[:, body:]).all()
    assert allclose_spmv(y.numpy()[:, :body], ref, np.float32,
                         nnz_per_row=len(GEN_OFFSETS),
                         scale=scale.numpy()[:, :body])
    by_planes = sdia_gen_tiles_mm(tv, torch.from_numpy(x3d),
                                  _strided_planes(y0), offs)
    assert torch.equal(y[:, :body], by_planes[:, :body])
    assert sdia_gen_tiles_mm.launches == 0


@pytest.mark.parametrize("B", [None, 1, 3, 8])
def test_sdia_gen_store_form_zeroes_the_tail(B):
    """The store form (a dia-only plan's applier passes no zeroed tiles):
    into a NaN-poisoned Y (strided planes for B12, a flat x for B6), the
    rows below R * 1024 hold the reference's A_dia x from zero tiles and
    every row past them reads exact +0."""
    R, T, x_rows = 2, 21, 19  # 16 tiles of values, 5 past them
    Bp = B or 1
    vals, X, _ = _gen_case(R, T, x_rows, Bp, seed=30 + Bp)
    x3d = _planes_of(X, x_rows)
    zeros = np.zeros((Bp, T, 128), np.float32)
    ref = _ref_gen_mm(vals, x3d, zeros)
    offs = torch.tensor(GEN_OFFSETS, dtype=torch.int32)
    tv = torch.from_numpy(vals)
    poison = np.full((Bp, T, 128), np.nan, np.float32)
    if B is None:
        y = sdia_gen_tiles(tv, torch.from_numpy(X[:, 0].copy()),
                           torch.from_numpy(poison[0].copy()), offs,
                           store=True)[None]
    else:
        y = sdia_gen_tiles_mm(tv, sk.gen_x(torch.from_numpy(X).clone(),
                                           x_rows),
                              _strided_planes(poison), offs, planes=B,
                              store=True)
    y = y.numpy()
    body = R * 8
    tail = y[:, body:]
    assert (tail == 0).all() and not np.signbit(tail).any()
    scale = sdia_gen_tiles_mm_plain(
        tv.abs().double(), torch.from_numpy(np.abs(x3d)).double(),
        torch.from_numpy(zeros).double(), offs).numpy()
    assert allclose_spmv(y[:, :body], ref, np.float32,
                         nnz_per_row=len(GEN_OFFSETS), scale=scale[:, :body])


#: ``kGenThreads`` of ``csrc/spmv_kernels.cu``: a CTA of the signed kernel
GEN_THREADS = 256


def _gen_model(vals, x_flat, y, offsets, slices, store):
    """``y (+)= A_dia x`` as ``sdia_gen_kernel`` computes it, in float32,
    for (B, x_len) planes ``x_flat`` (the interleaved X's planes) and
    (B, y_len) planes ``y``. A CTA takes 256 / slices rows g; thread (r,
    s) sums diagonals s, s + slices, ... of its row, reading x zero
    outside [0, x_len) and values only below nv = R * 1024; the slices'
    sums join in slice order. Adding, rows g < min(y_len, nv) get the
    sum; storing, every row below y_len is written (0 past nv)."""
    R, D = vals.shape[:2]
    nv = R * 1024
    vd = vals.transpose(1, 0, 2, 3).reshape(D, nv)
    B, XL = x_flat.shape
    YL = y.shape[1]
    out = y.copy()
    n_rows = YL if store else min(YL, nv)
    rows = GEN_THREADS // slices
    seen = np.zeros((D, n_rows), np.int64)  # each (diagonal, row) once
    for r0 in range(0, n_rows, rows):
        g = r0 + np.arange(rows)
        g = g[g < n_rows]
        sums = np.zeros((slices, B, len(g)), np.float32)
        for s in range(slices):
            for j in range(s, D, slices):
                src = g - offsets[j]
                ok = (src >= 0) & (src < XL) & (g < nv)
                v = np.where(ok, vd[j, np.clip(g, 0, nv - 1)], 0)
                xv = np.where(ok, x_flat[:, np.clip(src, 0, XL - 1)], 0)
                sums[s] += v * xv
                seen[j, g] += 1
        total = sums[0]
        for s in range(1, slices):
            total = total + sums[s]
        out[:, g] = total if store else out[:, g] + total
    assert (seen == 1).all()
    return out


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_sdia_gen_kernel_model_matches_twin_and_reference(B, slices, store):
    """The kernel's split of a row's diagonals over 1, 2 (both ship, by
    ``gen_slices``) or 4 threads (timed in the smoke only), adding and
    storing, as the numpy model: against the plain twin and the
    reference, x read in place with fewer rows than the values hold and
    y taller than them."""
    R, T, x_rows = 2, 21, 14
    vals, X, y0 = _gen_case(R, T, x_rows, B, seed=50 + B)
    x3d = _planes_of(X, x_rows)
    x_flat = X.T.copy()  # the in-place X's planes, x_len = m
    got = _gen_model(vals, x_flat, y0.reshape(B, -1), GEN_OFFSETS, slices,
                     store).reshape(B, T, 128)
    offs = torch.tensor(GEN_OFFSETS, dtype=torch.int32)
    tv = torch.from_numpy(vals)
    plain = sdia_gen_tiles_mm_plain(tv, torch.from_numpy(x3d),
                                    torch.from_numpy(y0.copy()), offs,
                                    store=store).numpy()
    y_ref0 = np.zeros_like(y0) if store else y0
    ref = _ref_gen_mm(vals, x3d, y_ref0)
    body = R * 8
    scale = sdia_gen_tiles_mm_plain(
        tv.abs().double(), torch.from_numpy(np.abs(x3d)).double(),
        torch.from_numpy(np.abs(y_ref0)).double(), offs).numpy()
    D = len(GEN_OFFSETS)
    assert allclose_spmv(got, plain, np.float32, nnz_per_row=D, scale=scale)
    assert allclose_spmv(got[:, :body], ref, np.float32, nnz_per_row=D,
                         scale=scale[:, :body])
    if store:
        assert (got[:, body:] == 0).all()
    else:
        assert np.array_equal(got[:, body:], y0[:, body:])


@pytest.mark.parametrize("rows,D,slices", [
    (512_000, 7, 1), (62_464, 64, 2), (65_536, 33, 2), (125_056, 7, 2),
    (135_168, 7, 2), (135_169, 7, 1), (4096, 1, 1)])
def test_sdia_gen_slices_rule(rows, D, slices):
    """Two threads a row where two a row fit the card's thread slots
    (132 x 2048 on an H100) and there are two diagonals to share: the
    62-65k-row plans; one where the rows alone fill the card
    (``general_asym()``'s 512,000)."""
    assert sk.gen_slices(rows, D) == slices
    assert sk.gen_slices(rows, D, slots=2 * rows) == (2 if D >= 2 else 1)
