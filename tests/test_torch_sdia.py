"""Kernel B1 (dense-diagonal symmetric stream): the port's plain twin
against the reference's Pallas ``sdia_sym_tiles`` (interpret mode).

Random values on every diagonal (padding rows included), offsets that
hit lane shift 0 and sublane shifts > 0 and cross 1024-row blocks, fewer
output tiles than value rows, a shorter x than the value rows and a
nonzero incoming y.

Tolerance: ``allclose_spmv`` at float32 with the backward-error scale
(|vals|, |x|, |y| through the float64 twin), since the Pallas
interpreter and the twin sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfs_spmv_tpu.ops.sdia_kernel import sdia_sym_tiles as ref_sdia_sym
from cfs_spmv_tpu_torch.ops.sdia_kernel import (
    _blocks_per_step,
    sdia_sym_tiles,
    sdia_sym_tiles_plain,
)
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

torch.set_num_threads(1)

OFFSETS = (1, 2, 127, 128, 129, 300, 1029)


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


def test_sdia_sym_wrapper_checks_operands():
    vals = torch.zeros((1, 2, 8, 128))
    x2d = torch.zeros((8, 128))
    y = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        sdia_sym_tiles(vals, x2d, y, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(TypeError):
        sdia_sym_tiles(vals.double(), x2d, y,
                       torch.tensor([1, 2], dtype=torch.int32))
    assert sdia_sym_tiles.launches == 0  # CPU tensors never launch
