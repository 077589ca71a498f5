"""Kernels B1 and B6 (dense-diagonal streams, symmetric and signed) and
their multi-RHS forms B11 and B12: the port's plain twins against the
reference's Pallas ``sdia_sym_tiles``, ``sdia_gen_tiles``,
``sdia_sym_tiles_mm`` and ``sdia_gen_tiles_mm`` (interpret mode), and
each MM twin against its SpMV twin column by column.

Random values on every diagonal (padding rows included), offsets that
hit lane shift 0 and sublane shifts > 0 and cross 1024-row blocks (for
B6 also the main diagonal and super-diagonals reading ahead), fewer
output tiles than value rows, a shorter x than the value rows, a
nonzero incoming y, and (B6) a NaN-poisoned y tail past the value rows,
which must keep its value. The MM cases add a Y whose planes sit at a
plane stride larger than a plane (a column slice of a wider buffer).

Tolerance: ``allclose_spmv`` at float32 with the backward-error scale
(|vals|, |x|, |y| through the float64 twin), since the Pallas
interpreter and the twin sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfs_spmv_tpu.ops.sdia_kernel import sdia_gen_tiles as ref_sdia_gen
from cfs_spmv_tpu.ops.sdia_kernel import sdia_gen_tiles_mm as ref_sdia_gen_mm
from cfs_spmv_tpu.ops.sdia_kernel import sdia_sym_tiles as ref_sdia_sym
from cfs_spmv_tpu.ops.sdia_kernel import sdia_sym_tiles_mm as ref_sdia_sym_mm
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
