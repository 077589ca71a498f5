"""Plain-PyTorch sparse ops: the ELL+COO float64 path.

Port of the part of ``cfs_spmv_tpu/ops/xla_ref.py`` that the float64
route uses (``tuning/tune._tune_fp64_xla``). The reference holds no Pallas
kernel here (it is XLA gather, multiply and scatter-add), so plain tensor
code is its port: a dense ELL slab for the regular part of the matrix
(gather, multiply, row sum; no scatter) and a COO remainder for rows
longer than the slab (``index_add_``). It runs only when the float64 path
is asked for by name (``CFS_FP64=xla``); the default float64 path runs
the CUDA kernels.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "build_ell_hyb",
    "ell_spmv",
    "ell_spmm",
    "coo_spmv",
    "coo_spmm",
]


def build_ell_hyb(row, col, val, nrows, *, width_factor=4, min_width=8):
    """Host split of COO triples into a dense ELL slab + COO remainder
    (NumPy; the reference's function of the same name, unchanged).

    The slab is ``min(longest row, max(min_width, width_factor x mean
    row length))`` wide; a row's entries past that width go to the
    remainder. Returns ``(ecol (nrows, L) int32, eval (nrows, L),
    rem_row, rem_col, rem_val)``; L == 0 when there is nothing to store.
    """
    row = np.asarray(row)
    counts = np.bincount(row, minlength=nrows)
    if nrows == 0 or len(row) == 0:
        z = np.zeros((nrows, 0))
        return (z.astype(np.int32), z.astype(val.dtype),
                row[:0], np.asarray(col)[:0], np.asarray(val)[:0])
    L = int(min(
        counts.max(),
        max(min_width, int(np.ceil(width_factor * counts.mean()))),
    ))
    order = np.argsort(row, kind="stable")
    r, c, v = row[order], np.asarray(col)[order], np.asarray(val)[order]
    starts = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    k = np.arange(len(r), dtype=np.int64) - starts[r]  # rank within row
    in_ell = k < L
    # padded slots gather x[0] with value 0 (exact no-op contribution)
    ecol = np.zeros((nrows, L), np.int32)
    evals = np.zeros((nrows, L), v.dtype)
    ecol[r[in_ell], k[in_ell]] = c[in_ell]
    evals[r[in_ell], k[in_ell]] = v[in_ell]
    rem = ~in_ell
    return ecol, evals, r[rem], c[rem], v[rem]


def ell_spmv(ecol, evals, x):
    """y = A @ x from an ELL slab: gather, multiply, row sum."""
    return (evals * x[ecol.long()]).sum(dim=1)


def ell_spmm(ecol, evals, x):
    """Y = A @ X (X: (ncols, B)) from an ELL slab."""
    return torch.einsum("rl,rlb->rb", evals, x[ecol.long()])


def coo_spmv(row, col, val, x, *, nrows: int):
    """y = A @ x from COO tensors: gather, multiply, ``index_add_``."""
    prod = val * x[col.long()]
    return prod.new_zeros(nrows).index_add_(0, row.long(), prod)


def coo_spmm(row, col, val, x, *, nrows: int):
    """Y = A @ X (X: (ncols, B)) from COO tensors."""
    prod = val[:, None] * x[col.long()]
    return prod.new_zeros((nrows, x.shape[1])).index_add_(0, row.long(), prod)
